"""--arch kimi-k2-1t-a32b (exact assignment config; implementation in lm_archs.py)."""
from repro_torch.configs.lm_archs import bundles as _b

ARCH_ID = "kimi-k2-1t-a32b"
BUNDLE = _b()["kimi-k2-1t-a32b"]
CONFIG = BUNDLE.cfg
