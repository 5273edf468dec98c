"""Plain PyTorch versions of the port's kernels — the port of
``repro.kernels.ref`` (:11-74).

Each kernel wrapper runs its plain version for tensors on the CPU (the
tests compare these with the JAX Pallas kernels); ``chip_smoke.py`` holds
every CUDA kernel against its plain version on the card.  They repeat the
kernels' arithmetic in the reference's order and are no yardstick of speed.
The JSD and Triangular versions are the registry's own functions
(``repro_torch.core.distances``), which run over column chunks of ``y`` so
a paper-size exact phase fits on the card.  ``y`` may be the bfloat16
corpus mirror of the bf16 exact phase: every plain version upcasts it to
float32 on entry, as every Pallas tile does; ``x`` stays float32.
"""

from __future__ import annotations

import torch

from repro_torch.core.constants import DEGENERATE_DELTA, MIN_DELTA
from repro_torch.core.distances import check_ieee_fp32, jsd, row_dot, triangular

__all__ = [
    "pairwise_l2_ref",
    "masked_pairwise_l2_ref",
    "masked_pairwise_metric_ref",
    "pairwise_jsd_ref",
    "pairwise_tri_ref",
    "planar_lower_bound_ref",
    "planar_lower_bound_pairs_ref",
]


def pairwise_l2_ref(x: torch.Tensor, y: torch.Tensor, squared: bool = False) -> torch.Tensor:
    x = x.float()
    y = y.float()
    check_ieee_fp32(x)
    sq = (
        torch.sum(x * x, dim=1)[:, None]
        + torch.sum(y * y, dim=1)[None, :]
        - 2.0 * row_dot(x, y)
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


def pairwise_jsd_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``sqrt(max(sum_k (x/2 log x + y/2 log y - m log m), 0) / ln 2)``,
    m = (x + y) / 2, xlogx guarded at 1e-12 (reference ``ref.py:54-65``)."""
    return jsd.pairwise(x, y)


def pairwise_tri_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``sqrt(max(0.5 * sum_k (x - y)^2 / max(x + y, 1e-12), 0))``
    (reference ``ref.py:68-74``)."""
    return triangular.pairwise(x, y)


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


def planar_lower_bound_pairs_ref(
    dqp: torch.Tensor, pairs: torch.Tensor, deltas: torch.Tensor, boxes: torch.Tensor
) -> torch.Tensor:
    """The bound from the (Q, P) query -> pivot matrix and the (M, 2) pivot
    pairs: gather each plane's two columns, then ``planar_lower_bound_ref``."""
    d1 = torch.index_select(dqp, 1, pairs[:, 0])
    d2 = torch.index_select(dqp, 1, pairs[:, 1])
    return planar_lower_bound_ref(d1, d2, deltas, boxes)
