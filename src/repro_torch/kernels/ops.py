"""Public entry points of the port's kernels — the port of
``repro.kernels.ops``: short aliases (``pairwise_jsd`` / ``pairwise_tri``
are the JSD and Triangular tiles of the metric-dispatched family) and
``bss_query_fused``, the BSS range query composed from the kernels."""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.pairwise_dist import (
    KERNEL_METRICS,
    masked_pairwise_kernel_call,
    masked_pairwise_l2_kernel_call,
    pairwise_kernel_call,
    pairwise_l2_kernel_call,
)
from repro_torch.kernels.planar_exclusion import (
    planar_lower_bound_kernel_call,
    planar_lower_bound_pairs_kernel_call,
)
from repro_torch.kernels.tiles import TILE_BLOCK, TILE_BQ

__all__ = [
    "pairwise_l2",
    "masked_pairwise_l2",
    "pairwise_metric",
    "masked_pairwise_metric",
    "KERNEL_METRICS",
    "planar_lower_bound",
    "bss_query_fused",
    "pairwise_jsd",
    "pairwise_tri",
]

pairwise_l2 = pairwise_l2_kernel_call
masked_pairwise_l2 = masked_pairwise_l2_kernel_call
pairwise_metric = pairwise_kernel_call
masked_pairwise_metric = masked_pairwise_kernel_call
planar_lower_bound = planar_lower_bound_kernel_call
# the reference's standalone JSD call (jsd_dist.py:91) computes the same
# function as its dispatched tile, so both run the one JSD kernel
pairwise_jsd = functools.partial(pairwise_kernel_call, "jsd")
pairwise_tri = functools.partial(pairwise_kernel_call, "triangular")


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
    metric_name: str = "l2",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full BSS range query (dense masked form) over the kernels of
    ``metric_name`` (any of ``KERNEL_METRICS``; cosine arrives as l2 on the
    unit sphere).

    Returns (dist, tile_mask): dist (Q, N) with +inf where tiles were
    pruned, tile_mask (Qtiles, B) the per-tile survival matrix.  Exact:
    every true hit (d <= t) is live by the four-point lower bound."""
    dqp = pairwise_kernel_call(metric_name, queries, pivots)  # (Q, P)
    # the kernel gathers each plane's two columns of dqp; pair_idx must lie
    # in [0, P), which the kernel does not check
    lb = planar_lower_bound_pairs_kernel_call(dqp, pair_idx.long(), deltas, boxes)  # (Q, B)
    qtiles = -(-queries.shape[0] // bq)
    lb_pad = torch.cat(
        [lb, lb.new_full((qtiles * bq - lb.shape[0], lb.shape[1]), torch.inf)]
    )
    # a tile survives if ANY of its queries does
    tile_mask = lb_pad.reshape(qtiles, bq, -1).amin(dim=1) <= t
    dist = masked_pairwise_kernel_call(
        metric_name, queries, data, tile_mask, bm=bq, bn=block
    )
    return dist, tile_mask
