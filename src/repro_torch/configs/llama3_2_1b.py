"""--arch llama3.2-1b (exact assignment config; implementation in lm_archs.py)."""
from repro_torch.configs.lm_archs import bundles as _b

ARCH_ID = "llama3.2-1b"
BUNDLE = _b()["llama3.2-1b"]
CONFIG = BUNDLE.cfg
