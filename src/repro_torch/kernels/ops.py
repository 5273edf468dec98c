"""Public entry points of the port's kernels — the port of
``repro.kernels.ops``: short aliases and ``bss_query_fused``, the BSS range
query composed from the three kernels."""

from __future__ import annotations

import torch

from repro_torch.kernels.pairwise_dist import (
    KERNEL_METRICS,
    masked_pairwise_kernel_call,
    masked_pairwise_l2_kernel_call,
    pairwise_kernel_call,
    pairwise_l2_kernel_call,
)
from repro_torch.kernels.planar_exclusion import planar_lower_bound_kernel_call
from repro_torch.kernels.tiles import TILE_BLOCK, TILE_BQ

__all__ = [
    "pairwise_l2",
    "masked_pairwise_l2",
    "pairwise_metric",
    "masked_pairwise_metric",
    "KERNEL_METRICS",
    "planar_lower_bound",
    "bss_query_fused",
]

pairwise_l2 = pairwise_l2_kernel_call
masked_pairwise_l2 = masked_pairwise_l2_kernel_call
pairwise_metric = pairwise_kernel_call
masked_pairwise_metric = masked_pairwise_kernel_call
planar_lower_bound = planar_lower_bound_kernel_call


def bss_query_fused(
    queries: torch.Tensor,
    pivots: torch.Tensor,
    pair_idx: torch.Tensor,
    deltas: torch.Tensor,
    boxes: torch.Tensor,
    data: torch.Tensor,
    t: float,
    *,
    block: int = TILE_BLOCK,
    bq: int = TILE_BQ,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full BSS range query (dense masked form) over the kernels.

    Returns (dist, tile_mask): dist (Q, N) with +inf where tiles were
    pruned, tile_mask (Qtiles, B) the per-tile survival matrix.  Exact:
    every true hit (d <= t) is live by the four-point lower bound."""
    dqp = pairwise_l2_kernel_call(queries, pivots)  # (Q, P)
    pair_idx = pair_idx.long()
    d1 = torch.index_select(dqp, 1, pair_idx[:, 0])
    d2 = torch.index_select(dqp, 1, pair_idx[:, 1])
    lb = planar_lower_bound_kernel_call(d1, d2, deltas, boxes)  # (Q, B)
    qtiles = -(-queries.shape[0] // bq)
    lb_pad = torch.cat(
        [lb, lb.new_full((qtiles * bq - lb.shape[0], lb.shape[1]), torch.inf)]
    )
    # a tile survives if ANY of its queries does
    tile_mask = lb_pad.reshape(qtiles, bq, -1).amin(dim=1) <= t
    dist = masked_pairwise_l2_kernel_call(
        queries, data, tile_mask, bm=bq, bn=block
    )
    return dist, tile_mask
