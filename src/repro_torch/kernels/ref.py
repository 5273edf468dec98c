"""Plain PyTorch versions of the port's kernels — the port of
``repro.kernels.ref`` (:11-51).

Each kernel wrapper runs its plain version for tensors on the CPU (the
tests compare these with the JAX Pallas kernels); ``chip_smoke.py`` holds
every CUDA kernel against its plain version on the card.  They repeat the
kernels' arithmetic in the reference's order and are no yardstick of speed.
"""

from __future__ import annotations

import torch

from repro_torch.core.constants import DEGENERATE_DELTA, MIN_DELTA
from repro_torch.core.distances import check_ieee_fp32

__all__ = [
    "pairwise_l2_ref",
    "masked_pairwise_l2_ref",
    "masked_pairwise_metric_ref",
    "planar_lower_bound_ref",
]


def pairwise_l2_ref(x: torch.Tensor, y: torch.Tensor, squared: bool = False) -> torch.Tensor:
    x = x.float()
    y = y.float()
    check_ieee_fp32(x)
    sq = (
        torch.sum(x * x, dim=1)[:, None]
        + torch.sum(y * y, dim=1)[None, :]
        - 2.0 * (x @ y.T)
    )
    sq = torch.clamp_min(sq, 0.0)
    return sq if squared else torch.sqrt(sq)


def masked_pairwise_metric_ref(
    dense: torch.Tensor, tile_mask: torch.Tensor, bm: int, bn: int
) -> torch.Tensor:
    """Apply a (ceil(m/bm), ceil(n/bn)) tile mask to a dense (m, n)
    distance matrix: +inf in every element of a dead tile."""
    live = tile_mask != 0
    mrep = live.repeat_interleave(bm, dim=0).repeat_interleave(bn, dim=1)
    mrep = mrep[: dense.shape[0], : dense.shape[1]]
    return torch.where(mrep, dense, torch.inf)


def masked_pairwise_l2_ref(
    x: torch.Tensor, y: torch.Tensor, tile_mask: torch.Tensor, bm: int, bn: int,
    squared: bool = False,
) -> torch.Tensor:
    return masked_pairwise_metric_ref(
        pairwise_l2_ref(x, y, squared=squared), tile_mask, bm, bn
    )


def planar_lower_bound_ref(
    d1: torch.Tensor, d2: torch.Tensor, deltas: torch.Tensor, boxes: torch.Tensor
) -> torch.Tensor:
    d1 = d1.float()
    d2 = d2.float()
    raw = deltas.float()[None, :]
    delta = torch.clamp_min(raw, MIN_DELTA)
    qx = torch.where(
        raw < DEGENERATE_DELTA, 0.0, (d1 * d1 - d2 * d2) / (2.0 * delta)
    )
    qy = torch.sqrt(torch.clamp_min(d1 * d1 - (qx + delta / 2.0) ** 2, 0.0))
    qxe = qx[:, None, :]
    qye = qy[:, None, :]
    bx = boxes.float()[None]
    dx = torch.clamp_min(torch.maximum(bx[..., 0] - qxe, qxe - bx[..., 1]), 0.0)
    dy = torch.clamp_min(torch.maximum(bx[..., 2] - qye, qye - bx[..., 3]), 0.0)
    return torch.amax(torch.sqrt(dx * dx + dy * dy), dim=-1)
