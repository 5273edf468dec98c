# Copy of src/repro/core/tree.py, kept so the port imports nothing of the JAX
# package; tests/test_torch_copies.py pins it to the original.
"""Hyperplane partition trees (paper §4): 12 structural variants × 2
exclusion mechanisms (Hyperbolic / Hilbert).

Variants (paper §4.2), differentiated ONLY by reference-point selection —
query code is shared, exactly mirroring the paper's "same Java classes,
specialised only by selection strategy" methodology:

    sat_pure            SAT neighbour set, ascending-distance scan
    sat_distal_pure     SAT neighbour set, descending-distance scan
    sat_distal_fixed    distal scan, capped at arity 4
    sat_distal_log      distal scan, capped at ln|S|
    sat_global_fixed    distal scan ordered by distance from GLOBAL root centre, arity 4
    sat_global_log      ... capped at ln|S|
    hpt_fft_binary      FFT (farthest-first) pivots, arity 2
    hpt_fft_fixed       FFT pivots, arity 4
    hpt_fft_log         FFT pivots, arity ln|S|      <-- paper's best
    hpt_random_binary   random pivots, arity 2
    hpt_random_fixed    random pivots, arity 4
    hpt_random_log      random pivots, arity ln|S|

Exclusion at query time (paper Alg. 2 + §2.2):
  * cover radius:   d(q, p_x) > cr_x + t
  * hyperbolic:     exists y:  d(q,p_x) - d(q,p_y) > 2t
  * Hilbert:        exists y: (d(q,p_x)^2 - d(q,p_y)^2) / d(p_x,p_y) > 2t
  * SAT-family trees additionally use the parent *centre* as a free witness
    (its query distance is passed down; d(p_x, centre) stored at build).

Queries run batched: the engine walks the array-encoded tree with an explicit
stack of (node, active-query-subset), evaluating distances for all active
queries at once (vectorised numpy) while tallying per-query distance counts —
bitwise identical counts to a one-query-at-a-time walk.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from repro_torch.core import exclusion, refpoints
from repro_torch.core.exclusion import HILBERT, HYPERBOLIC
from repro_torch.core.npdist import DistanceCounter, pairwise_np

__all__ = ["TREE_VARIANTS", "PartitionTree", "build_tree", "range_search"]


@dataclasses.dataclass
class _Node:
    ref_idx: np.ndarray          # (k,) dataset indices of reference points
    ref_dists: np.ndarray        # (k, k) pairwise ref distances (build-time)
    centre_dists: np.ndarray     # (k,) d(ref_i, parent centre); NaN if none
    cover_r: np.ndarray          # (k,) cover radius of child subtree i
    children: list               # k entries: _Node | np.ndarray(leaf idx) | None


@dataclasses.dataclass
class PartitionTree:
    variant: str
    metric: str
    data: np.ndarray
    root: _Node
    build_distances: int
    n_nodes: int
    max_depth: int


# --------------------------------------------------------------------------
# arity policies
# --------------------------------------------------------------------------


def _arity_binary(n: int, depth: int) -> int:
    return 2


def _arity_fixed(n: int, depth: int) -> int:
    return 4


def _arity_log(n: int, depth: int) -> int:
    return max(2, int(math.log(max(n, 3))))


# --------------------------------------------------------------------------
# reference selection
# --------------------------------------------------------------------------


def _sat_neighbours(
    metric: str,
    data: np.ndarray,
    subset: np.ndarray,
    d_c: np.ndarray,
    order: np.ndarray,
    cap: int | None,
    build_count: list,
) -> np.ndarray:
    """Serial SAT neighbour selection: scan ``subset`` in ``order``; s joins N
    iff it is closer to the centre than to every current member of N.

    Only the running min-distance-to-refs is kept (the membership criterion
    needs nothing more), so wide distal nodes stay O(n) memory."""
    refs: list[int] = []
    min_d = np.full(len(subset), np.inf)
    for pos in order:
        if cap is not None and len(refs) >= cap:
            break
        if len(refs) == 0 or d_c[pos] < min_d[pos]:
            new_ref = subset[pos]
            d_new = pairwise_np(metric, data[subset], data[new_ref][None, :])[:, 0]
            build_count[0] += len(subset)
            min_d = np.minimum(min_d, d_new)
            refs.append(int(new_ref))
    return np.asarray(refs, dtype=np.int64)


def _make_selector(variant: str):
    """Returns (select_fn, arity_fn, is_sat).  select_fn(data, subset, centre,
    global_order_rank, rng, build_count) -> ref indices (into dataset)."""
    if variant.startswith("sat"):
        if variant == "sat_pure":
            cap, order_kind = None, "asc"
        elif variant == "sat_distal_pure":
            cap, order_kind = None, "desc"
        elif variant == "sat_distal_fixed":
            cap, order_kind = 4, "desc"
        elif variant == "sat_distal_log":
            cap, order_kind = "log", "desc"
        elif variant == "sat_global_fixed":
            cap, order_kind = 4, "global"
        elif variant == "sat_global_log":
            cap, order_kind = "log", "global"
        else:
            raise ValueError(variant)

        def select(metric, data, subset, centre_idx, global_rank, rng, build_count):
            n = len(subset)
            k_cap = cap if not isinstance(cap, str) else _arity_log(n, 0)
            c = data[centre_idx][None, :]
            d_c = pairwise_np(metric, data[subset], c)[:, 0]
            build_count[0] += n
            if order_kind == "global":
                order = np.argsort(global_rank[subset])[::-1]
            else:
                order = np.argsort(d_c)
                if order_kind == "desc":
                    order = order[::-1]
            return _sat_neighbours(
                metric, data, subset, d_c, order, k_cap, build_count
            )

        return select, None, True

    kind, strategy, arity_name = variant.split("_")
    if kind != "hpt":
        raise ValueError(f"unknown tree variant family {kind!r} in {variant!r}")
    arity_fn = {
        "binary": _arity_binary,
        "fixed": _arity_fixed,
        "log": _arity_log,
    }[arity_name]

    def select(metric, data, subset, centre_idx, global_rank, rng, build_count):
        k = min(arity_fn(len(subset), 0), len(subset))
        if strategy == "random":
            loc = refpoints.select_random(rng, len(subset), k)
        else:  # fft
            loc = refpoints.select_fft(metric, data[subset], k, rng)
            build_count[0] += k * min(len(subset), 4096)  # FFT scan cost
        return subset[loc]

    return select, arity_fn, False


TREE_VARIANTS = (
    "sat_pure",
    "sat_distal_pure",
    "sat_distal_fixed",
    "sat_distal_log",
    "sat_global_fixed",
    "sat_global_log",
    "hpt_fft_binary",
    "hpt_fft_fixed",
    "hpt_fft_log",
    "hpt_random_binary",
    "hpt_random_fixed",
    "hpt_random_log",
)


# --------------------------------------------------------------------------
# build
# --------------------------------------------------------------------------


def build_tree(
    variant: str,
    metric: str,
    data: np.ndarray,
    seed: int = 0,
    leaf_cap: int = 8,
) -> PartitionTree:
    if variant not in TREE_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    import sys

    if sys.getrecursionlimit() < 100_000:
        sys.setrecursionlimit(100_000)
    rng = np.random.default_rng(seed)
    data = np.asarray(data, np.float64)  # lint: disable=R3
    n = data.shape[0]
    select, _, is_sat = _make_selector(variant)
    # Centre-witness hyperplane exclusion is only SOUND for uncapped ("pure")
    # SAT construction: capping breaks the every-point-closer-to-some-ref-
    # than-to-centre invariant (paper §4.1 "SAT construction").
    centre_witness = variant in ("sat_pure", "sat_distal_pure")
    build_count = [0]
    stats = {"nodes": 0, "max_depth": 0}

    # SAT-family trees need a centre; root centre is an outlier (SAT_out).
    root_centre = refpoints.select_outlier(metric, data, rng) if is_sat else -1
    global_rank = None
    if variant.startswith("sat_global"):
        d_root = pairwise_np(metric, data, data[root_centre][None, :])[:, 0]
        build_count[0] += n
        global_rank = d_root

    def make_node(subset: np.ndarray, centre_idx: int, depth: int):
        stats["max_depth"] = max(stats["max_depth"], depth)
        if len(subset) == 0:
            return None
        if len(subset) <= leaf_cap:
            return subset  # leaf bucket
        stats["nodes"] += 1
        ref_idx = select(metric, data, subset, centre_idx, global_rank, rng, build_count)
        k = len(ref_idx)
        refs = data[ref_idx]
        ref_dists = pairwise_np(metric, refs, refs)
        if centre_witness and centre_idx >= 0:
            centre_dists = pairwise_np(metric, refs, data[centre_idx][None, :])[:, 0]
        else:
            centre_dists = np.full(k, np.nan)
        rest_mask = ~np.isin(subset, ref_idx)
        rest = subset[rest_mask]
        children: list = [None] * k
        cover_r = np.zeros(k)
        if len(rest) > 0:
            d_assign = pairwise_np(metric, data[rest], refs)  # (m, k)
            build_count[0] += len(rest) * k
            owner = np.argmin(d_assign, axis=1)
            for j in range(k):
                sub_j = rest[owner == j]
                if len(sub_j) > 0:
                    cover_r[j] = float(d_assign[owner == j, j].max())
                children[j] = make_node(sub_j, int(ref_idx[j]), depth + 1)
        return _Node(ref_idx, ref_dists, centre_dists, cover_r, children)

    subset0 = np.arange(n, dtype=np.int64)
    if is_sat:
        # the root centre itself is stored at the root as a 1-ref super-node
        subset0 = subset0[subset0 != root_centre]
        inner = make_node(subset0, root_centre, 1)
        stats["nodes"] += 1
        root = _Node(
            ref_idx=np.array([root_centre], dtype=np.int64),
            ref_dists=np.zeros((1, 1)),
            centre_dists=np.full(1, np.nan),
            cover_r=np.array(
                [float(pairwise_np(metric, data[subset0], data[root_centre][None, :]).max())]
                if len(subset0)
                else [0.0]
            ),
            children=[inner],
        )
        build_count[0] += len(subset0)
    else:
        root = make_node(subset0, -1, 0)
        if not isinstance(root, _Node):  # degenerate tiny dataset
            root = _Node(
                ref_idx=np.array([], dtype=np.int64),
                ref_dists=np.zeros((0, 0)),
                centre_dists=np.zeros(0),
                cover_r=np.zeros(0),
                children=[root],
            )
    return PartitionTree(
        variant=variant,
        metric=metric,
        data=data,
        root=root,
        build_distances=build_count[0],
        n_nodes=stats["nodes"],
        max_depth=stats["max_depth"],
    )


# --------------------------------------------------------------------------
# batched counting range query
# --------------------------------------------------------------------------


def _exclusion_masks(
    dq: np.ndarray,
    node: _Node,
    t: float,
    mechanism: str,
    d_centre: np.ndarray | None,
) -> np.ndarray:
    """(nq, k) True where child x is excluded for that query.

    All three predicates come from ``core/exclusion.py`` (numpy namespace,
    float64) — the same bodies the device forest walker runs under jit, so
    the host walk IS the oracle for the accelerated one."""
    excl = exclusion.cover_radius_exclusion_mask(
        dq, node.cover_r[None, :], t, xp=np
    )
    excl |= exclusion.hyperplane_exclusion_mask(
        dq, node.ref_dists, t, mechanism, xp=np
    )
    # SAT-family bonus witness: the parent centre (free query distance).
    if d_centre is not None and not np.any(np.isnan(node.centre_dists)):
        excl |= exclusion.centre_witness_exclusion_mask(
            dq, d_centre, node.centre_dists[None, :], t, mechanism, xp=np
        )
    return excl


def range_search(
    tree: PartitionTree,
    queries: np.ndarray,
    t: float,
    mechanism: str = HILBERT,
) -> tuple[list[list[int]], DistanceCounter]:
    """Batched exact range search; returns per-query hit lists + counter."""
    if mechanism not in (HILBERT, HYPERBOLIC):
        raise ValueError(mechanism)
    queries = np.asarray(queries, np.float64)  # lint: disable=R3
    nq = queries.shape[0]
    counter = DistanceCounter(tree.metric, nq)
    results: list[list[int]] = [[] for _ in range(nq)]
    data = tree.data

    # stack entries: (node_or_leaf, active query idx array, centre dists | None)
    stack: list = [(tree.root, np.arange(nq, dtype=np.int64), None)]
    while stack:
        node, qidx, d_centre = stack.pop()
        if node is None or len(qidx) == 0:
            continue
        if isinstance(node, np.ndarray):  # leaf bucket
            d = counter.pairwise(qidx, queries[qidx], data[node])
            hit_mask = d <= t
            for row in np.nonzero(hit_mask.any(axis=1))[0]:
                qi = qidx[row]
                results[qi].extend(int(h) for h in node[hit_mask[row]])
            continue
        k = len(node.ref_idx)
        if k == 0:
            for ch in node.children:
                stack.append((ch, qidx, None))
            continue
        dq = counter.pairwise(qidx, queries[qidx], data[node.ref_idx])
        hit_mask = dq <= t
        for row in np.nonzero(hit_mask.any(axis=1))[0]:
            qi = qidx[row]
            results[qi].extend(int(r) for r in node.ref_idx[hit_mask[row]])
        excl = _exclusion_masks(dq, node, t, mechanism, d_centre)
        for j, child in enumerate(node.children):
            if child is None:
                continue
            keep = ~excl[:, j]
            if np.any(keep):
                stack.append((child, qidx[keep], dq[keep, j]))
    return results, counter


def exhaustive_search(
    metric: str, data: np.ndarray, queries: np.ndarray, t: float
) -> list[list[int]]:
    """Ground truth (chunked to bound memory)."""
    data = np.asarray(data, np.float64)  # lint: disable=R3
    queries = np.asarray(queries, np.float64)  # lint: disable=R3
    out: list[list[int]] = []
    for q0 in range(0, len(queries), 256):
        qs = queries[q0 : q0 + 256]
        d = pairwise_np(metric, qs, data)
        for row in range(len(qs)):
            out.append([int(i) for i in np.nonzero(d[row] <= t)[0]])
    return out
