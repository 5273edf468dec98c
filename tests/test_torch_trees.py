"""The port's host trees (``repro_torch.core.tree`` / ``lrt``, copies of the
reference's) on the CPU: exactness against exhaustive search and the
paper's claims, the mirror of the host-walk cases of ``tests/test_trees.py``,
plus the copies' builds and walks against the reference's on the same
seeds (the same tree, the same hits and counts) and the planar geometry of
the port's torch branch.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro.core import lrt as jax_lrt
from repro.core import tree as jax_tree
from repro_torch.core import lrt, projection, tree
from repro_torch.core.constants import DEGENERATE_DELTA
from repro_torch.core.exclusion import HILBERT, HYPERBOLIC
from repro_torch.data import metricsets


@functools.lru_cache(maxsize=None)
def _small_space():
    data = metricsets.euc10(1500, seed=1)
    db, q = metricsets.split_queries(data, 0.05, seed=2)
    q = q[:25]
    t = metricsets.calibrate_threshold("l2", db, 2e-3)
    return db, q, t, tree.exhaustive_search("l2", db, q, t)


@functools.lru_cache(maxsize=None)
def _clustered_space():
    data = metricsets.colors_surrogate(1200, dim=24, seed=3)
    db, q = metricsets.split_queries(data, 0.05, seed=4)
    q = q[:20]
    t = metricsets.calibrate_threshold("l2", db, 5e-3)
    return db, q, t, tree.exhaustive_search("l2", db, q, t)


def _same(res, truth):
    return all(sorted(r) == sorted(g) for r, g in zip(res, truth))


@pytest.mark.parametrize("mech", [HYPERBOLIC, HILBERT])
@pytest.mark.parametrize("variant", tree.TREE_VARIANTS)
def test_partition_tree_exact_and_equal_to_reference(variant, mech):
    """Exact against exhaustive search, and the reference's build and walk
    on the same seed give the same hits and per-query counts."""
    db, q, t, truth = _small_space()
    tr = tree.build_tree(variant, "l2", db, seed=7)
    res, counter = tree.range_search(tr, q, t, mech)
    assert _same(res, truth)
    jtr = jax_tree.build_tree(variant, "l2", db, seed=7)
    jres, jcounter = jax_tree.range_search(jtr, q, t, mech)
    assert res == jres
    np.testing.assert_array_equal(counter.per_query, jcounter.per_query)
    assert (tr.build_distances, tr.n_nodes, tr.max_depth) == (
        jtr.build_distances, jtr.n_nodes, jtr.max_depth)


@pytest.mark.parametrize("variant", ["hpt_fft_log", "sat_pure", "hpt_random_binary"])
def test_hilbert_never_worse(variant):
    """Paper §4.3: supermetric exclusion always gives better performance."""
    db, q, t, _ = _small_space()
    tr = tree.build_tree(variant, "l2", db, seed=11)
    _, c_hyp = tree.range_search(tr, q, t, HYPERBOLIC)
    _, c_hil = tree.range_search(tr, q, t, HILBERT)
    assert c_hil.mean <= c_hyp.mean + 1e-9
    assert np.all(c_hil.per_query <= c_hyp.per_query)


@pytest.mark.parametrize("select", ["rand", "far"])
@pytest.mark.parametrize("partition", lrt.PARTITIONS)
def test_monotone_trees_exact_and_equal_to_reference(partition, select):
    db, q, t, truth = _clustered_space()
    tr = lrt.build_monotone_tree(partition, select, "l2", db, seed=5)
    res, counter = lrt.range_search_monotone(tr, q, t, HILBERT)
    assert _same(res, truth)
    jtr = jax_lrt.build_monotone_tree(partition, select, "l2", db, seed=5)
    jres, jcounter = jax_lrt.range_search_monotone(jtr, q, t, HILBERT)
    assert res == jres
    np.testing.assert_array_equal(counter.per_query, jcounter.per_query)
    assert (tr.n_nodes, tr.max_depth, tr.build_distances) == (
        jtr.n_nodes, jtr.max_depth, jtr.build_distances)


def test_monotone_closer_hyperbolic_exact():
    db, q, t, truth = _clustered_space()
    tr = lrt.build_monotone_tree("closer", "far", "l2", db, seed=5)
    res, _ = lrt.range_search_monotone(tr, q, t, HYPERBOLIC)
    assert _same(res, truth)


def test_hyperbolic_rejected_for_planar_partitions():
    db, q, t, _ = _clustered_space()
    tr = lrt.build_monotone_tree("lrt", "rand", "l2", db, seed=5)
    with pytest.raises(ValueError):
        lrt.range_search_monotone(tr, q, t, HYPERBOLIC)


def test_balanced_trees_are_balanced():
    db, *_ = _clustered_space()
    for part in ["median_x", "lrt", "pca"]:
        tr = lrt.build_monotone_tree(part, "rand", "l2", db, seed=6)
        assert tr.max_depth <= int(np.ceil(np.log2(len(db)))) + 3, (part, tr.max_depth)


def test_sat_centre_witness_soundness():
    """Capped SAT variants must not use the centre witness (unsound)."""
    db, *_ = _small_space()
    for variant in ["sat_distal_fixed", "sat_global_log"]:
        tr = tree.build_tree(variant, "l2", db, seed=3)
        stack = [tr.root]
        while stack:
            n = stack.pop()
            if isinstance(n, tree._Node):
                assert np.all(np.isnan(n.centre_dists)) or n is tr.root
                stack.extend(c for c in n.children if c is not None)


@pytest.mark.parametrize("seed", [3, 71, 908])
def test_hilbert_dominates(seed):
    """Hilbert never evaluates more distances than Hyperbolic on the same
    tree, for seeded data."""
    rng = np.random.default_rng(seed)
    db = rng.random((300, 8))
    q = rng.random((10, 8))
    tr = tree.build_tree("hpt_random_fixed", "l2", db, seed=seed % 89)
    _, c_hyp = tree.range_search(tr, q, 0.2, HYPERBOLIC)
    _, c_hil = tree.range_search(tr, q, 0.2, HILBERT)
    assert np.all(c_hil.per_query <= c_hyp.per_query)


@pytest.mark.parametrize("mech", [HYPERBOLIC, HILBERT])
def test_tree_duplicate_refs_delta_zero_sound(mech):
    """A corpus thick with exact duplicates forces duplicate reference
    points (ref_dists == 0): exclusion through the MIN_DELTA floor stays
    sound."""
    rng = np.random.default_rng(21)
    locs = rng.random((40, 6))
    db = np.concatenate([np.repeat(locs, 8, axis=0), rng.random((80, 6))])
    q = rng.random((12, 6))
    t = 0.25
    truth = tree.exhaustive_search("l2", db, q, t)
    for variant in ("hpt_fft_fixed", "sat_pure"):
        res, _ = tree.range_search(tree.build_tree(variant, "l2", db, seed=5), q, t, mech)
        assert _same(res, truth), (variant, mech)


def test_monotone_duplicate_and_near_duplicate_pivots_sound():
    """Duplicate and near-duplicate pivots (closer than DEGENERATE_DELTA)
    fall back to leaf buckets at build and stay exact."""
    rng = np.random.default_rng(22)
    locs = rng.random((25, 5))
    jitter = 1e-8 * rng.random((25, 5))
    for db in (np.repeat(locs, 10, axis=0),
               np.concatenate([locs, locs + jitter, rng.random((40, 5))])):
        q = rng.random((10, 5))
        truth = tree.exhaustive_search("l2", db, q, 0.2)
        for partition in ("closer", "median_x", "lrt"):
            tr = lrt.build_monotone_tree(partition, "far", "l2", db, seed=6)
            res, _ = lrt.range_search_monotone(tr, q, 0.2, HILBERT)
            assert _same(res, truth), partition


def test_projection_degenerate_plane_shared_collapse():
    """Both namespaces of the port's ``project`` collapse near-duplicate
    pivot planes to the ring bound (x = 0, y = d1), and ``rotate`` /
    ``rotate_cs`` are one rigid motion in both."""
    d1 = np.array([0.3, 0.7, 1.1])
    d2 = np.array([0.30000001, 0.69999999, 1.1])
    tiny = DEGENERATE_DELTA / 10.0
    for xp in (np, torch):
        x, y = projection.project(d1, d2, tiny, xp=xp)
        assert np.allclose(np.asarray(x), 0.0)
        assert np.allclose(np.asarray(y), d1, atol=1e-6)
        x2, y2 = projection.project(d1, d1 + 0.2, 0.5, xp=xp)
        assert np.all(np.abs(np.asarray(x2)) > 0.01)
        rx, ry = projection.rotate(x2, y2, 0.4, 0.1, xp=xp)
        cx, cy = projection.rotate_cs(x2, y2, np.cos(0.4), np.sin(0.4), 0.1, xp=xp)
        np.testing.assert_allclose(np.asarray(rx), np.asarray(cx), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(ry), np.asarray(cy), rtol=1e-6)
        # a rigid motion keeps planar distances
        d_before = projection.planar_lower_bound(x2[0], y2[0], x2[2], y2[2], xp=xp)
        d_after = projection.planar_lower_bound(rx[0], ry[0], rx[2], ry[2], xp=xp)
        np.testing.assert_allclose(float(d_before), float(d_after), rtol=1e-5)
