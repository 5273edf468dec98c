"""--arch phi3.5-moe-42b-a6.6b (exact assignment config; implementation in lm_archs.py)."""
from repro_torch.configs.lm_archs import bundles as _b

ARCH_ID = "phi3.5-moe-42b-a6.6b"
BUNDLE = _b()["phi3.5-moe-42b-a6.6b"]
CONFIG = BUNDLE.cfg
