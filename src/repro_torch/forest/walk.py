"""Frontier-per-level batched range search over encoded forests — the port
of ``repro.forest.walk``.

The host walks (``core/tree.py``, ``core/lrt.py``) pop one (node, active
query subset) at a time.  This walker takes a whole level at once: the
frontier is a dense (query x node-at-level) survival matrix, and each level
is

    one distance evaluation for every alive (query, node) pair
                                         -> reference / pivot hits
    the exclusion predicates             -> per-child survival
    one gather                           -> the next level's frontier

Surviving leaf buckets gather into a (query x leaf) candidate matrix that
one masked exact phase checks at the end.

The reference jits the whole walk into one call; here it is eager torch,
about 30 operations a level and one masked tile launch a level plus the
leaf phase.  None of them waits for the host: no ``.item()``, no Python
branch on a tensor and no ``nonzero`` until result assembly, so a batch's
launches queue on the stream back to back
(``tests/test_torch_cuda_forest.py`` runs a walk under
``torch.cuda.set_sync_debug_mode("error")``).

Backends, as in the BSS engine: ``"cuda"`` computes the level distances
and the leaf phase with the masked tile kernels
(``masked_pairwise_kernel_call``: dead (query-tile x block) cells are not
computed); ``"torch"`` computes the same dense shapes with the plain
metric; ``"auto"`` picks by the encoding's device.  The exclusion geometry
is ``core/exclusion.py``'s, the same bodies the host walks run in numpy.

Distance accounting is analytic and exact: a query is charged ``k`` at
every (query, node) cell it keeps alive and ``len(bucket)`` per surviving
leaf, which is what ``DistanceCounter`` tallies in the host walk.  Result
sets and per-query counts match the host walks whenever float32 and
float64 agree on every predicate.

``precision="bf16"`` runs the leaf phase over the bfloat16 leaf mirror with
every comparison widened by the measured margin (``core/precision.py``);
the band is re-checked against the fp32 leaf table through the same masked
tiles, which give a computed cell the same bits whatever the mask, so hit
sets are the fp32 walk's bit for bit.  The exclusion predicates and their
tables stay fp32: pruning, and with it the per-query counts, does not
depend on the precision.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import exclusion
from repro_torch.core.backends import (
    EngineOpts,
    resolve_backend,
    resolve_engine_opts,
    tile_survival,
)
from repro_torch.core.distances import get_metric
from repro_torch.core.exclusion import HILBERT, HYPERBOLIC
from repro_torch.core.flat_index import _bf16_stats
from repro_torch.core.projection import project
from repro_torch.forest.encode import (
    EncodedForest,
    EncodedMonotone,
    ForestDev,
    LeafDev,
    MonotoneDev,
)
from repro_torch.kernels.pairwise_dist import (
    KERNEL_METRICS,
    masked_pairwise_kernel_call,
)
from repro_torch.kernels.tiles import TILE_BLOCK, TILE_BQ
from repro_torch.obs import schema as obs_schema

__all__ = ["forest_range_search", "monotone_range_search"]


# ---------------------------------------------------------------------------
# shared masked distance plumbing
# ---------------------------------------------------------------------------


def _owner_alive(alive: torch.Tensor, owner_of_row: torch.Tensor) -> torch.Tensor:
    """(Q, n_owners) survival -> (Q, rows) per-row survival through an
    owner-of-row map (-1 rows, the padding, are never alive)."""
    n_owners = alive.shape[1]
    safe = torch.clamp(owner_of_row, 0, max(n_owners - 1, 0))
    return (owner_of_row[None, :] >= 0) & alive[:, safe]


def _masked_dists(
    metric_name: str,
    queries: torch.Tensor,
    rows_data: torch.Tensor,
    row_alive: torch.Tensor,
    *,
    backend: str,
) -> torch.Tensor:
    """(Q, rows) distances.  On ``"cuda"`` the masked tile skips the dead
    (query-tile x block) cells, which come back +inf; on ``"torch"`` the
    dense plain metric runs.  Callers mask out the rows they did not ask
    for."""
    if backend == "cuda" and metric_name in KERNEL_METRICS:
        block_alive = row_alive.reshape(row_alive.shape[0], -1, TILE_BLOCK).any(dim=2)
        return masked_pairwise_kernel_call(
            metric_name, queries, rows_data, tile_survival(block_alive, TILE_BQ),
            bm=TILE_BQ, bn=TILE_BLOCK,
        )
    return get_metric(metric_name).pairwise(queries, rows_data)


def _leaf_exact(
    metric_name: str,
    queries: torch.Tensor,
    leaves: LeafDev,
    leaf_alive: torch.Tensor,
    t: torch.Tensor,
    leaf16: torch.Tensor | None,
    eps: torch.Tensor | None,
    *,
    backend: str,
):
    """The final exact phase: (hit bitmask (Q, rows), per-query re-checked
    points, re-checked tiles).  With ``leaf16`` the distances come from the
    bf16 mirror and only the band ``t - eps < d16 <= t + eps`` is re-run
    against the fp32 table; a computed cell's bits do not depend on the
    mask, so band cells read the fp32 walk's values."""
    nq = queries.shape[0]
    dev = queries.device
    if leaf_alive.shape[1] == 0:
        return (
            torch.zeros((nq, leaves.leaf_data.shape[0]), dtype=torch.bool, device=dev),
            torch.zeros((nq,), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev),
        )
    row_alive = _owner_alive(leaf_alive, leaves.leaf_of_row)
    ok = leaves.leaf_valid[None, :] & row_alive
    if leaf16 is None:
        d = _masked_dists(metric_name, queries, leaves.leaf_data, row_alive,
                          backend=backend)
        return (
            (d <= t) & ok,
            torch.zeros((nq,), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev),
        )
    d16 = _masked_dists(metric_name, queries, leaf16, row_alive, backend=backend)
    sure = (d16 <= t - eps) & ok  # final by the margin guarantee
    band = (d16 <= t + eps) & ok & ~sure
    del d16
    d32 = _masked_dists(metric_name, queries, leaves.leaf_data, band, backend=backend)
    hit = sure | (band & (d32 <= t))
    band_blocks = band.reshape(nq, -1, TILE_BLOCK).any(dim=2)
    rtiles = tile_survival(band_blocks, TILE_BQ).sum()
    return hit, band.sum(dim=1, dtype=torch.int32), rtiles


def _count_alive(alive: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Per-query distance charge: ``weight`` summed over the query's alive
    cells, in int32 (the host counter's integers exactly)."""
    return torch.sum(
        torch.where(alive, weight[None, :].to(torch.int32), 0), dim=1,
        dtype=torch.int32,
    )


def _n_root_leaves(dev) -> int:
    """Leaf buckets hanging off the root, alive for every query.  Encode
    numbers them first, then the leaves level by level, so they are the
    ids no level's edge table claims."""
    return dev.leaves.leaf_len.shape[0] - sum(
        lv.leaf_parent_pos.shape[0] for lv in dev.levels
    )


def _stack(frontier: list, dev: torch.device) -> torch.Tensor:
    if frontier:
        return torch.stack(frontier)
    return torch.zeros((0,), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# n-ary partition-tree walker (all 12 variants)
# ---------------------------------------------------------------------------


def _forest_walk(
    metric_name: str,
    queries: torch.Tensor,
    t: torch.Tensor,
    dev: ForestDev,
    leaf16: torch.Tensor | None,
    eps: torch.Tensor | None,
    *,
    mechanism: str,
    backend: str,
):
    """One batch through every level (the reference's ``_forest_walk_jit``).
    Returns (per-level ref-hit bitmasks, leaf-row hit bitmask, counts,
    per-query band sizes, re-checked tiles, obs), all on the device.

    ``obs`` is the walk's observability: per-query exclusion attribution
    (cover / hyperplane / centre, made disjoint by that priority, so the
    three sum to the excluded slots) and per-level frontier occupancy,
    reductions over masks the walk computes anyway."""
    nq = queries.shape[0]
    device = queries.device
    zeros = lambda: torch.zeros((nq,), dtype=torch.int32, device=device)  # noqa: E731
    counts, obs_cover, obs_hyper, obs_centre = zeros(), zeros(), zeros(), zeros()
    frontier = []
    ref_hits = []
    leaf_alive_parts = [
        torch.ones((nq, _n_root_leaves(dev)), dtype=torch.bool, device=device)
    ]

    alive = dcent = None  # (nq, Na_l) frontier; inherited centre distance
    for li, lv in enumerate(dev.levels):
        na, kmax = lv.na, lv.kmax
        if li == 0:
            alive = torch.ones((nq, na), dtype=torch.bool, device=device)
            # the root has no centre: NaN compares False
            dcent = torch.full((nq, na), torch.nan, dtype=torch.float32, device=device)
        counts += _count_alive(alive, lv.n_refs)
        row_alive = _owner_alive(alive, lv.node_of_row)
        d = _masked_dists(metric_name, queries, lv.ref_data, row_alive, backend=backend)
        dq = d[:, : na * kmax].reshape(nq, na, kmax)
        dq = torch.where(lv.ref_valid[None], dq, torch.inf)  # pad slots inert
        ref_hits.append(alive[:, :, None] & lv.ref_valid[None] & (dq <= t))
        e_cov = exclusion.cover_radius_exclusion_mask(dq, lv.cover_r[None], t)
        e_hyp = exclusion.hyperplane_exclusion_mask(dq, lv.ref_dists, t, mechanism)
        live = alive[:, :, None] & lv.ref_valid[None]
        obs_cover += torch.sum(live & e_cov, dim=(1, 2), dtype=torch.int32)
        obs_hyper += torch.sum(live & ~e_cov & e_hyp, dim=(1, 2), dtype=torch.int32)
        excl = e_cov | e_hyp
        if lv.any_centre:
            # the SAT centre witness where the node has one and the walk
            # carried the centre distance down (a level without one, the
            # host knows, excludes nothing by it)
            e_cen = (
                exclusion.centre_witness_exclusion_mask(
                    dq, dcent, lv.centre_dists, t, mechanism
                )
                & lv.centre_on[None, :, None]
            )
            obs_centre += torch.sum(live & ~excl & e_cen, dim=(1, 2), dtype=torch.int32)
            excl = excl | e_cen
        frontier.append(torch.sum(alive, dtype=torch.int32))
        keep = live & ~excl
        if lv.leaf_parent_pos.shape[0]:
            leaf_alive_parts.append(keep[:, lv.leaf_parent_pos, lv.leaf_parent_slot])
        if li + 1 < len(dev.levels):
            nxt = dev.levels[li + 1]
            alive = keep[:, nxt.parent_pos, nxt.parent_slot]
            dcent = dq[:, nxt.parent_pos, nxt.parent_slot]

    leaf_alive = torch.cat(leaf_alive_parts, dim=1)
    counts += _count_alive(leaf_alive, dev.leaves.leaf_len)
    leaf_hit, band_counts, rtiles = _leaf_exact(
        metric_name, queries, dev.leaves, leaf_alive, t, leaf16, eps, backend=backend,
    )
    obs = {
        "excluded_cover": obs_cover,
        "excluded_hyperplane": obs_hyper,
        "excluded_centre": obs_centre,
        "frontier": _stack(frontier, device),
    }
    return tuple(ref_hits), leaf_hit, counts, band_counts, rtiles, obs


def _hit_lists(nq: int, masks: list, col_ids: np.ndarray) -> list[list[int]]:
    """Per-query hit lists from bitmasks laid side by side (each (Q, cols),
    their columns named by ``col_ids``): one ``nonzero`` and one copy to
    the host.  ``nonzero`` is row-major, so a query's hits come in column
    order: level by level, then the leaves, as the reference appends
    them."""
    pos = torch.nonzero(torch.cat([m.reshape(nq, -1) for m in masks], dim=1))
    pos = pos.cpu().numpy()
    ids = col_ids[pos[:, 1]]
    counts = np.bincount(pos[:, 0], minlength=nq)
    return [r.tolist() for r in np.split(ids, np.cumsum(counts)[:-1])]


def _prepare(enc, queries, t, mechanism, opts, backend, precision):
    """Validated engine options and the batch's device inputs."""
    if mechanism not in (HILBERT, HYPERBOLIC):
        raise ValueError(mechanism)
    opts = resolve_engine_opts(opts, backend=backend, precision=precision)
    backend = resolve_backend(opts.backend, enc.torch_device)
    queries = np.asarray(queries, np.float32)
    bf16 = opts.precision == "bf16"
    eps = enc.bf16_eps() if bf16 else 0.0
    dev = enc.torch_device
    return (
        opts.precision, backend, queries, eps,
        torch.as_tensor(queries, device=dev),
        torch.tensor(t, dtype=torch.float32, device=dev),
        torch.tensor(eps, dtype=torch.float32, device=dev) if bf16 else None,
        enc.leaf_bf16 if bf16 else None,
    )


def forest_range_search(
    forest: EncodedForest,
    queries: np.ndarray,
    t: float,
    mechanism: str = HILBERT,
    *,
    opts: EngineOpts | None = None,
    backend: str | None = None,
    precision: str | None = None,
) -> tuple[list[list[int]], dict]:
    """Batched exact range search over an encoded partition tree.

    Engine options travel as ``opts=EngineOpts(...)`` (the per-knob kwargs
    are the legacy spelling); the walker tiles by the tree's own shapes, so
    only ``backend`` and ``precision`` apply.

    Returns per-query hit lists of original dataset ids and the stats dict
    of ``repro_torch.obs.schema``.  ``stats["per_query_dists"]`` is the
    paper's figure of merit, equal to ``DistanceCounter.per_query`` of the
    host ``tree.range_search`` whenever float32 and float64 agree on every
    predicate.  ``precision="bf16"``: hits and counts equal the fp32
    walk's, and the re-check volume rides the bf16 stats keys (see
    ``bss_query_batched``)."""
    precision, backend, queries, eps, q_dev, t_dev, eps_dev, leaf16 = _prepare(
        forest, queries, t, mechanism, opts, backend, precision)
    nq = queries.shape[0]
    if nq == 0:
        stats = _stats(
            forest, np.zeros(0, np.int64), backend, precision, engine="forest",
            excluded={m: np.zeros(0, np.int64) for m in ("cover", mechanism, "centre")},
        )
        if precision == "bf16":
            _bf16_stats(stats, eps, 0, np.zeros(0, np.int64))
        return [], stats
    ref_hits, leaf_hit, counts, band_counts, rtiles, obs = _forest_walk(
        forest.metric, q_dev, t_dev, forest.device, leaf16, eps_dev,
        mechanism=mechanism, backend=backend,
    )
    results = _hit_lists(nq, [*ref_hits, leaf_hit], _forest_col_ids(forest))
    stats = _stats(
        forest, counts.cpu().numpy().astype(np.int64), backend, precision,
        engine="forest",
        # the walker counts hyperplane exclusions mechanism-neutrally; the
        # label is the hyperplane rule this walk ran
        excluded={
            "cover": obs["excluded_cover"].cpu().numpy().astype(np.int64),
            mechanism: obs["excluded_hyperplane"].cpu().numpy().astype(np.int64),
            "centre": obs["excluded_centre"].cpu().numpy().astype(np.int64),
        },
        frontier=obs["frontier"].cpu().numpy(),
    )
    if precision == "bf16":
        _bf16_stats(stats, eps, int(rtiles), band_counts.cpu().numpy())
    return results, stats


def _forest_col_ids(forest: EncodedForest) -> np.ndarray:
    """The original id of each column of ``_hit_lists``' side-by-side
    masks: every level's (node, slot) refs, then the leaf rows."""
    return np.concatenate(
        [lv.ref_idx.reshape(-1) for lv in forest.levels] + [forest.leaf.member_of_row]
    )


def _stats(enc, per_query: np.ndarray, backend: str, precision: str, *,
           engine: str, excluded: dict | None = None, frontier=None) -> dict:
    stats = {
        "per_query_dists": per_query,
        "dists_per_query": float(per_query.mean()) if per_query.size else 0.0,
        "n_levels": len(enc.levels),
        "n_nodes": enc.n_nodes,
        "n_leaves": enc.leaf.n_leaves,
        "backend": backend,
        "precision": precision,
        # nodes alive across all queries, per level
        "frontier_occupancy": (
            np.zeros(len(enc.levels), np.int64) if frontier is None
            else np.asarray(frontier, np.int64)
        ),
    }
    return obs_schema.normalise_stats(
        stats, engine=engine, kind="range", backend=backend,
        n_queries=int(per_query.shape[0]), excluded=excluded,
    )


# ---------------------------------------------------------------------------
# monotone binary walker (closer / median_x / median_y / pca / lrt)
# ---------------------------------------------------------------------------


def _monotone_walk(
    metric_name: str,
    queries: torch.Tensor,
    t: torch.Tensor,
    dev: MonotoneDev,
    leaf16: torch.Tensor | None,
    eps: torch.Tensor | None,
    *,
    mechanism: str,
    backend: str,
):
    """One batch through every level (the reference's
    ``_monotone_walk_jit``).  Returns (root hit, per-level p2-hit
    bitmasks, leaf-row hits, counts, per-query band sizes, re-checked
    tiles, obs: per-query hyperplane exclusions and per-level frontier
    occupancy).

    One new distance per (query, visited node): the inherited pivot's
    distance rides the frontier, the Monotonous Bisector Tree invariant
    the host walk exploits.  The root distance is the plain metric, as in
    the reference (outside any tile kernel)."""
    nq = queries.shape[0]
    device = queries.device
    d_root = get_metric(metric_name).pairwise(queries, dev.root_p1_data)[:, 0]
    counts = torch.ones((nq,), dtype=torch.int32, device=device)  # the root distance
    obs_hyper = torch.zeros((nq,), dtype=torch.int32, device=device)
    frontier = []
    root_hit = d_root <= t
    p2_hits = []
    leaf_alive_parts = [
        torch.ones((nq, _n_root_leaves(dev)), dtype=torch.bool, device=device)
    ]

    alive = dinh = None  # (nq, Na_l) frontier; inherited-pivot distance
    for li, lv in enumerate(dev.levels):
        na = lv.na
        if li == 0:
            alive = torch.ones((nq, na), dtype=torch.bool, device=device)
            dinh = d_root[:, None].expand(nq, na)
        counts += torch.sum(alive, dim=1, dtype=torch.int32)
        row_alive = _owner_alive(alive, lv.p2_owner)
        d = _masked_dists(metric_name, queries, lv.p2_data, row_alive, backend=backend)
        d2 = d[:, :na]
        d1 = dinh
        p2_hits.append(alive & (d2 <= t))
        if mechanism == HYPERBOLIC:
            margin = exclusion.hyperbolic_margin(d1, d2)
        else:
            x, y = project(d1, d2, lv.delta[None, :])
            margin = exclusion.planar_margin_cs(
                x, y, lv.cos_theta[None, :], lv.sin_theta[None, :], lv.h[None, :],
                lv.nx[None, :], lv.ny[None, :], lv.split[None, :],
            )
        keep_l = alive & (margin < t)  # left is excluded only when m >= t
        keep_r = alive & (margin > -t)
        # each alive node has two semispaces: count the ones excluded
        obs_hyper += torch.sum(alive & ~keep_l, dim=1, dtype=torch.int32)
        obs_hyper += torch.sum(alive & ~keep_r, dim=1, dtype=torch.int32)
        frontier.append(torch.sum(alive, dtype=torch.int32))
        if lv.leaf_parent_pos.shape[0]:
            pos, right = lv.leaf_parent_pos, lv.leaf_parent_right
            leaf_alive_parts.append(
                torch.where(right[None, :], keep_r[:, pos], keep_l[:, pos])
            )
        if li + 1 < len(dev.levels):
            nxt = dev.levels[li + 1]
            pos, right = nxt.parent_pos, nxt.parent_right
            alive = torch.where(right[None, :], keep_r[:, pos], keep_l[:, pos])
            dinh = torch.where(right[None, :], d2[:, pos], d1[:, pos])

    leaf_alive = torch.cat(leaf_alive_parts, dim=1)
    counts += _count_alive(leaf_alive, dev.leaves.leaf_len)
    leaf_hit, band_counts, rtiles = _leaf_exact(
        metric_name, queries, dev.leaves, leaf_alive, t, leaf16, eps, backend=backend,
    )
    obs = {"excluded_hyperplane": obs_hyper, "frontier": _stack(frontier, device)}
    return root_hit, tuple(p2_hits), leaf_hit, counts, band_counts, rtiles, obs


def monotone_range_search(
    forest: EncodedMonotone,
    queries: np.ndarray,
    t: float,
    mechanism: str = HILBERT,
    *,
    opts: EngineOpts | None = None,
    backend: str | None = None,
    precision: str | None = None,
) -> tuple[list[list[int]], dict]:
    """Batched exact range search over an encoded monotone tree, the
    counterpart of ``lrt.range_search_monotone`` with its mechanism rule
    (Hyperbolic only for the 'closer' split).  ``opts`` / ``precision`` as
    in ``forest_range_search``."""
    if mechanism == HYPERBOLIC and forest.partition != "closer":
        raise ValueError("hyperbolic exclusion is only sound for the 'closer' split")
    precision, backend, queries, eps, q_dev, t_dev, eps_dev, leaf16 = _prepare(
        forest, queries, t, mechanism, opts, backend, precision)
    nq = queries.shape[0]
    if nq == 0:
        stats = _stats(
            forest, np.zeros(0, np.int64), backend, precision, engine="monotone",
            excluded={mechanism: np.zeros(0, np.int64)},
        )
        if precision == "bf16":
            _bf16_stats(stats, eps, 0, np.zeros(0, np.int64))
        return [], stats
    (root_hit, p2_hits, leaf_hit, counts, band_counts, rtiles,
     obs) = _monotone_walk(
        forest.metric, q_dev, t_dev, forest.device, leaf16, eps_dev,
        mechanism=mechanism, backend=backend,
    )
    col_ids = np.concatenate(
        [[forest.root_p1]] + [lv.p2_idx for lv in forest.levels]
        + [forest.leaf.member_of_row]
    ).astype(np.int64)
    results = _hit_lists(nq, [root_hit[:, None], *p2_hits, leaf_hit], col_ids)
    stats = _stats(
        forest, counts.cpu().numpy().astype(np.int64), backend, precision,
        engine="monotone",
        excluded={
            mechanism: obs["excluded_hyperplane"].cpu().numpy().astype(np.int64),
        },
        frontier=obs["frontier"].cpu().numpy(),
    )
    if precision == "bf16":
        _bf16_stats(stats, eps, int(rtiles), band_counts.cpu().numpy())
    return results, stats
