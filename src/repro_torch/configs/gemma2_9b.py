"""--arch gemma2-9b (exact assignment config; implementation in lm_archs.py)."""
from repro_torch.configs.lm_archs import bundles as _b

ARCH_ID = "gemma2-9b"
BUNDLE = _b()["gemma2-9b"]
CONFIG = BUNDLE.cfg
