"""--arch wide-deep (exact assignment config; implementation in recsys_archs.py)."""
from repro_torch.configs.recsys_archs import bundles as _b

ARCH_ID = "wide-deep"
BUNDLE = _b()["wide-deep"]
CONFIG = BUNDLE.cfg
