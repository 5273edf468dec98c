"""Launchers of the port (``repro.launch``): ``python -m repro_torch.launch.serve``."""
