"""Architecture registry of the port: ``--arch <id>`` resolution, the port
of ``repro.configs.registry``.

Per-arch modules (one file per assigned architecture, exact configs inside):
    configs/phi3_5_moe.py  configs/kimi_k2.py  configs/gemma2_9b.py
    configs/deepseek_coder_33b.py  configs/llama3_2_1b.py
    configs/pna.py
    configs/wide_deep.py  configs/din.py  configs/two_tower.py  configs/dlrm_rm2.py
plus the paper's own workload: configs/supermetric.py (metric-search corpus).

The port holds every family the reference registers (LM, GNN, recsys), in
the reference's order; an unknown name raises ``KeyError``, as the
reference does.  ``NOT_PORTED`` (a name the reference registers that the
port does not hold yet, with the ROADMAP item that ports it) is empty.
"""

from __future__ import annotations

from repro_torch.configs import lm_archs, pna, recsys_archs
from repro_torch.configs.common import ArchBundle

_REGISTRY: dict[str, ArchBundle] | None = None

# the reference's names not ported yet, and the ROADMAP item of each
NOT_PORTED: dict[str, str] = {}


def registry() -> dict[str, ArchBundle]:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = {}
        _REGISTRY.update(lm_archs.bundles())
        _REGISTRY.update(pna.bundles())
        _REGISTRY.update(recsys_archs.bundles())
    return _REGISTRY


def get_arch(name: str) -> ArchBundle:
    reg = registry()
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: {NOT_PORTED[name]}"
        )
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; have: {sorted(reg)}")
    return reg[name]


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) pair — the reference's 40-cell matrix."""
    out = []
    for name, b in registry().items():
        for cell in b.cells:
            out.append((name, cell))
    return out
