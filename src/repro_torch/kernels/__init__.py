"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``, built
by ``_build`` on first use) with their plain PyTorch versions (``ref``).

``launch_counts()`` / ``reset_launch_counts()`` read and zero every
wrapper's count of kernel launches, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations


def _counters() -> list[dict]:
    from repro_torch.kernels import pairwise_dist, planar_exclusion

    return [pairwise_dist.LAUNCHES, planar_exclusion.LAUNCHES]


def launch_counts() -> dict[str, int]:
    """Kernel name -> launches since the last reset."""
    out: dict[str, int] = {}
    for c in _counters():
        out.update(c)
    return out


def reset_launch_counts() -> None:
    from repro_torch.kernels import _build

    for c in _counters():
        _build.reset_counts(c)
