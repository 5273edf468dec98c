"""Observability of the port: the shared engine-stats schema."""
