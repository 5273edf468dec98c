"""Fault-tolerant checkpointing of the port (``repro.checkpoint``)."""
