"""Jensen-Shannon distance: sqrt(JS divergence in bits) between rows on the
simplex, with ``x log x`` taken as 0 at or below 1e-12 (the guard the
metric's definition in the paper's code uses)."""

from __future__ import annotations

import math

import torch

EPS = 1e-12


def _xlogx(v: torch.Tensor) -> torch.Tensor:
    # v log v where v > EPS, else 0 (the other branch's nan is not taken)
    return torch.where(v > EPS, v * torch.log(v), 0.0)


def _dist(hq: torch.Tensor, hx: torch.Tensor, q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    # JS = sum_k (x/2 log x + y/2 log y - m log m), m = (x + y) / 2; the two
    # one-sided sums are taken once per row
    s = hq + hx - _xlogx(0.5 * (q + x)).sum(-1)
    return torch.sqrt(torch.clamp_min(s, 0.0) / math.log(2.0))


def prepare(x: torch.Tensor) -> torch.Tensor:
    return x


def pair_bytes(d: int) -> int:
    """Bytes of the float64 intermediates ``pairwise`` holds per pair."""
    return 8 * d


def pairwise(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    hq = 0.5 * _xlogx(q).sum(-1)
    hx = 0.5 * _xlogx(x).sum(-1)
    return _dist(hq[:, None], hx[None, :], q[:, None, :], x[None, :, :])


def paired(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    hq = 0.5 * _xlogx(q).sum(-1)
    hx = 0.5 * _xlogx(x).sum(-1)
    return _dist(hq[:, None], hx, q[:, None, :], x)


def control(q: torch.Tensor, x: torch.Tensor, precision: str) -> torch.Tensor:
    """``pairwise`` with every step in bfloat16, the precision below the
    configuration's float32 (no matrix product here, so TF32 does not
    apply)."""
    if precision != "bf16":
        raise ValueError(f"jsd has a bf16 control, not {precision!r}")
    return pairwise(q.to(torch.bfloat16), x.to(torch.bfloat16)).float()
