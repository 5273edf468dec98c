"""--arch din (exact assignment config; implementation in recsys_archs.py)."""
from repro_torch.configs.recsys_archs import bundles as _b

ARCH_ID = "din"
BUNDLE = _b()["din"]
CONFIG = BUNDLE.cfg
