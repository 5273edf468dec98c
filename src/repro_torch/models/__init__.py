"""Model definitions of the port (``repro.models``): the recsys family."""
