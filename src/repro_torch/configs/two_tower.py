"""--arch two-tower-retrieval (exact assignment config; implementation in recsys_archs.py)."""
from repro_torch.configs.recsys_archs import bundles as _b

ARCH_ID = "two-tower-retrieval"
BUNDLE = _b()["two-tower-retrieval"]
CONFIG = BUNDLE.cfg
