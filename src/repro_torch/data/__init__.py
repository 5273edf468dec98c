"""Data of the port (``repro.data``): seeded metric-space corpora
(``metricsets``, a copy) and the checkpointable training streams
(``pipeline``)."""
