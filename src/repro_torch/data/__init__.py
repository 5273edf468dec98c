"""Seeded metric-space corpora of the port (copies of ``repro.data``)."""
