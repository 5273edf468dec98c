"""--arch dlrm-rm2 (exact assignment config; implementation in recsys_archs.py)."""
from repro_torch.configs.recsys_archs import bundles as _b

ARCH_ID = "dlrm-rm2"
BUNDLE = _b()["dlrm-rm2"]
CONFIG = BUNDLE.cfg
