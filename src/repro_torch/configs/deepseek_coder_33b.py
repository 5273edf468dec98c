"""--arch deepseek-coder-33b (exact assignment config; implementation in lm_archs.py)."""
from repro_torch.configs.lm_archs import bundles as _b

ARCH_ID = "deepseek-coder-33b"
BUNDLE = _b()["deepseek-coder-33b"]
CONFIG = BUNDLE.cfg
