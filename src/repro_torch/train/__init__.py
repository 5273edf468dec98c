"""Training of the port (``repro.train``): the train step and the
fault-tolerant loop."""
