# Copy of src/repro/core/lrt.py, kept so the port imports nothing of the JAX
# package; tests/test_torch_copies.py pins it to the original.
"""Monotone binary hyperplane trees over the projected plane, including the
paper's novel Linear Regression Tree (§5) and the arbitrary-planar-partition
family (§3.4).

All trees here are *monotone* (each child shares one pivot with its parent,
as in the Monotonous Bisector Tree): at query time only ONE new distance is
evaluated per visited node — the inherited pivot's distance is passed down.

Partition strategies (all are 1-Lipschitz functionals of the projected plane,
so |margin(q) - split| > t soundly excludes the far side under the four-point
property):

    closer     sign of planar x  == classic closer-pivot split (unbalanced;
               also admits the Hyperbolic mechanism for non-supermetric use)
    median_x   balanced split at median planar x   (Fig. 8 left)
    median_y   balanced split at median height y   (Fig. 8 right)
    pca        balanced split along the 1st principal axis of the node's
               projected cloud (Fig. 9)
    lrt        LRT: least-squares line fit, rotate about X-intercept so the
               line becomes the X-axis, split at median rotated x (Alg. 3)

Selection strategies for the fresh pivot: "rand" and "far" (farthest from the
inherited pivot — free, since inherited distances are already known).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from repro_torch.core import exclusion, projection
from repro_torch.core.constants import DEGENERATE_DELTA
from repro_torch.core.exclusion import HILBERT, HYPERBOLIC
from repro_torch.core.npdist import DistanceCounter, pairwise_np

__all__ = ["PARTITIONS", "MonotoneTree", "build_monotone_tree", "range_search_monotone"]

PARTITIONS = ("closer", "median_x", "median_y", "pca", "lrt")


@dataclasses.dataclass
class _MNode:
    p1: int              # inherited pivot (dataset index)
    p2: int              # fresh pivot
    delta: float         # d(p1, p2)
    theta: float         # rotation angle (lrt) or pca axis angle
    h: float             # rotation X-intercept (lrt only)
    ny: float            # margin = nx*r_x + ny*r_y; (nx,ny) unit
    nx: float
    split: float
    left: object         # _MNode | np.ndarray leaf | None
    right: object


@dataclasses.dataclass
class MonotoneTree:
    partition: str
    select: str
    metric: str
    data: np.ndarray
    root: object
    root_p1: int
    build_distances: int
    n_nodes: int
    max_depth: int


# Planar geometry comes from core/projection.py (numpy namespace, float64)
# — the SAME bodies the jitted engines run in float32, so build, host walk
# and device forest walk agree on the degenerate-plane (duplicate-pivot)
# handling by construction.  Build refuses nodes with delta below
# DEGENERATE_DELTA (leaf-bucket fallback), so the walk-side ring collapse
# inside ``projection.project`` never fires for an encoded node.


def _fit_partition(partition: str, x: np.ndarray, y: np.ndarray,
                   q: float = 0.5):
    """Returns (theta, h, nx, ny, split).

    ``q``: split quantile.  0.5 = the paper's balanced median split; other
    values implement the *controlled unbalancing* the paper proposes as
    future work (§3.5/§6: "the effect of controlling the balance ... will
    increase the probability of exclusion at cost of excluding smaller
    subsets").
    """
    if partition == "closer":
        return 0.0, 0.0, 1.0, 0.0, 0.0
    if partition == "median_x":
        return 0.0, 0.0, 1.0, 0.0, float(np.quantile(x, q))
    if partition == "median_y":
        return 0.0, 0.0, 0.0, 1.0, float(np.quantile(y, q))
    if partition == "pca":
        xc, yc = x - x.mean(), y - y.mean()
        cov = np.array(
            [[np.mean(xc * xc), np.mean(xc * yc)], [np.mean(xc * yc), np.mean(yc * yc)]]
        )
        w, v = np.linalg.eigh(cov)
        pc1 = v[:, int(np.argmax(w))]  # split ALONG pc1 (max spread direction)
        nx, ny = float(pc1[0]), float(pc1[1])
        m = nx * x + ny * y
        return 0.0, 0.0, nx, ny, float(np.quantile(m, q))
    if partition == "lrt":
        xb, yb = float(x.mean()), float(y.mean())
        den = float(np.sum((x - xb) ** 2))
        num = float(np.sum((x - xb) * (y - yb)))
        if den < 1e-12 or abs(num) < 1e-12 * max(den, 1.0):
            theta, h = 0.0, 0.0
        else:
            m = num / den
            theta = float(np.arctan(m))
            h = xb - yb / m if abs(m) > 1e-9 else 0.0
        rx, _ = projection.rotate(x, y, theta, h, xp=np)
        return theta, h, 1.0, 0.0, float(np.quantile(rx, q))
    raise ValueError(partition)


def build_monotone_tree(
    partition: str,
    select: str,
    metric: str,
    data: np.ndarray,
    seed: int = 0,
    leaf_cap: int = 8,
    split_quantile: float = 0.5,
) -> MonotoneTree:
    """``split_quantile`` != 0.5 gives the paper's proposed *controlled
    unbalancing* (§6 future work): deterministic skew instead of the
    serendipitous skew of the 'closer' split."""
    if partition not in PARTITIONS:
        raise ValueError(partition)
    if select not in ("rand", "far"):
        raise ValueError(select)
    if sys.getrecursionlimit() < 100_000:
        sys.setrecursionlimit(100_000)
    rng = np.random.default_rng(seed)
    data = np.asarray(data, np.float64)  # lint: disable=R3
    n = data.shape[0]
    build_count = [0]
    stats = {"nodes": 0, "depth": 0}

    def pick_p2(subset: np.ndarray, d1: np.ndarray) -> int:
        if select == "far":
            return int(subset[int(np.argmax(d1))])
        return int(subset[int(rng.integers(len(subset)))])

    def make(subset: np.ndarray, p1: int, d1: np.ndarray, depth: int):
        stats["depth"] = max(stats["depth"], depth)
        if len(subset) <= leaf_cap:
            return subset
        stats["nodes"] += 1
        p2 = pick_p2(subset, d1)
        delta = float(pairwise_np(metric, data[p1], data[p2][None, :])[0, 0])
        build_count[0] += 1
        keep = subset != p2
        subset, d1 = subset[keep], d1[keep]
        d2 = pairwise_np(metric, data[subset], data[p2][None, :])[:, 0]
        build_count[0] += len(subset)
        if delta < DEGENERATE_DELTA:
            # degenerate (duplicate or near-duplicate) pivots: the plane
            # cannot be trusted — projection would collapse it to the ring
            # bound at query time (PR 2 fix), so no linear split of it can
            # separate anything.  Fall back to a leaf bucket.
            return np.concatenate([subset, np.array([p2], dtype=np.int64)])
        x, y = projection.project(d1, d2, delta, xp=np)
        theta, h, nx, ny, split = _fit_partition(partition, x, y, split_quantile)
        margin = exclusion.planar_margin(x, y, theta, h, nx, ny, split, xp=np)
        lmask = margin < 0.0
        # One-sided splits are legitimate for the unbalanced 'closer' tree
        # (paper §5: "the unbalanced tree is always the best performer"); for
        # balanced partitions they mean the median is tied — nudge the split
        # to a strict separator, or give up on a degenerate cloud.  The split
        # stored in the node is ALWAYS the true boundary, so the |margin|>t
        # exclusion stays sound.
        if partition != "closer" and (lmask.all() or (~lmask).all()):
            uniq = np.unique(margin)
            if len(uniq) < 2:
                return np.concatenate([subset, np.array([p2], dtype=np.int64)])
            cut = float(uniq[max(1, len(uniq) // 2)])
            split += cut
            margin = margin - cut
            lmask = margin < 0.0
        left = make(subset[lmask], p1, d1[lmask], depth + 1)
        right = make(subset[~lmask], p2, d2[~lmask], depth + 1)
        return _MNode(p1, p2, delta, theta, h, ny, nx, split, left, right)

    all_idx = np.arange(n, dtype=np.int64)
    p1 = int(rng.integers(n))
    subset = all_idx[all_idx != p1]
    d1 = pairwise_np(metric, data[subset], data[p1][None, :])[:, 0]
    build_count[0] += len(subset)
    root = make(subset, p1, d1, 1)
    return MonotoneTree(
        partition=partition,
        select=select,
        metric=metric,
        data=data,
        root=root,
        root_p1=p1,
        build_distances=build_count[0],
        n_nodes=stats["nodes"],
        max_depth=stats["depth"],
    )


def range_search_monotone(
    tree: MonotoneTree,
    queries: np.ndarray,
    t: float,
    mechanism: str = HILBERT,
) -> tuple[list[list[int]], DistanceCounter]:
    """Batched counting range search (paper Alg. 5, generalised partitions).

    Only ``partition='closer'`` admits the Hyperbolic mechanism; every other
    partition is planar-geometric and requires the four-point property.
    """
    if mechanism == HYPERBOLIC and tree.partition != "closer":
        raise ValueError("hyperbolic exclusion is only sound for the 'closer' split")
    queries = np.asarray(queries, np.float64)  # lint: disable=R3
    nq = queries.shape[0]
    counter = DistanceCounter(tree.metric, nq)
    results: list[list[int]] = [[] for _ in range(nq)]
    data = tree.data

    d_root = counter.pairwise(
        np.arange(nq, dtype=np.int64), queries, data[tree.root_p1][None, :]
    )[:, 0]
    for qi in np.nonzero(d_root <= t)[0]:
        results[qi].append(tree.root_p1)

    stack = [(tree.root, np.arange(nq, dtype=np.int64), d_root)]
    while stack:
        node, qidx, dq1 = stack.pop()
        if node is None or len(qidx) == 0:
            continue
        if isinstance(node, np.ndarray):
            if len(node) == 0:
                continue
            d = counter.pairwise(qidx, queries[qidx], data[node])
            hit = d <= t
            for row in np.nonzero(hit.any(axis=1))[0]:
                results[qidx[row]].extend(int(i) for i in node[hit[row]])
            continue
        dq2 = counter.pairwise(qidx, queries[qidx], data[node.p2][None, :])[:, 0]
        for row in np.nonzero(dq2 <= t)[0]:
            results[qidx[row]].append(node.p2)
        if mechanism == HYPERBOLIC:
            # <0 closer to p1; exclude iff |.| > t
            margin = exclusion.hyperbolic_margin(dq1, dq2, xp=np)
        else:
            x, y = projection.project(dq1, dq2, node.delta, xp=np)
            margin = exclusion.planar_margin(
                x, y, node.theta, node.h, node.nx, node.ny, node.split, xp=np
            )
        go_left = margin < t       # cannot exclude left unless margin >= t
        go_right = margin > -t
        if np.any(go_left):
            stack.append((node.left, qidx[go_left], dq1[go_left]))
        if np.any(go_right):
            stack.append((node.right, qidx[go_right], dq2[go_right]))
    return results, counter
