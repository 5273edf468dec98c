"""Edge shapes, degenerate geometry, the other supermetrics and the bf16
leaf phase of the port's forest walks, against the JAX package's walks and
the host walks on the CPU (the mirror of ``tests/test_forest.py``'s edge,
degenerate and metric cases; comparisons as in ``torch_forest_common``).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

from repro import forest as jax_forest
from repro.core.backends import EngineOpts as JaxOpts
from repro_torch import forest
from repro_torch.core import lrt, tree
from repro_torch.core.backends import EngineOpts
from repro_torch.core.exclusion import HILBERT, HYPERBOLIC
from repro_torch.data import metricsets
from torch_forest_common import (
    assert_walks_agree,
    build_monotone_pair,
    build_tree_pair,
    same_sets,
    space,
)


@functools.lru_cache(maxsize=None)
def _space():
    return space()


@functools.lru_cache(maxsize=None)
def _fft_log():
    db, _, _ = _space()
    return build_tree_pair("hpt_fft_log", "l2", db, seed=7)


@pytest.mark.parametrize("nq", [1, 5])
def test_forest_non_multiple_batch_widths(nq):
    """Batches far from the 128-row tile width and levels whose node counts
    do not divide the block: the padding paths."""
    _, q, t = _space()
    ptr, penc, carried, jenc = _fft_log()
    assert_walks_agree(
        forest.forest_range_search, jax_forest.forest_range_search,
        penc, carried, jenc, q[:nq], t, HILBERT,
        tree.range_search(ptr, q[:nq], t, HILBERT),
    )


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_empty_query_batch(precision):
    db, q, t = _space()
    _, penc, _, _ = _fft_log()
    opts = EngineOpts(precision=precision)
    res, stats = forest.forest_range_search(penc, q[:0], t, HILBERT, opts=opts)
    assert res == [] and stats["per_query_dists"].shape == (0,)
    assert set(stats["excluded"]) == {"cover", HILBERT, "centre"}
    _, menc, _, _ = build_monotone_pair("lrt", "far", "l2", db, seed=5)
    res, stats = forest.monotone_range_search(menc, q[:0], t, HILBERT, opts=opts)
    assert res == [] and stats["per_query_dists"].shape == (0,)
    assert ("per_query_recheck" in stats) == (precision == "bf16")


@functools.lru_cache(maxsize=None)
def _duplicate_space():
    """A corpus thick with exact duplicates: duplicate reference points at
    inner nodes (ref_dists == 0) and oversized fallback leaf buckets in the
    monotone family."""
    rng = np.random.default_rng(21)
    locs = rng.random((30, 6))
    db = np.concatenate([np.repeat(locs, 8, axis=0), rng.random((60, 6))])
    q = rng.random((10, 6))
    t = 0.25
    return db, q, t, tree.exhaustive_search("l2", db, q, t)


@pytest.mark.parametrize("mech", [HYPERBOLIC, HILBERT])
@pytest.mark.parametrize("variant", ["hpt_fft_fixed", "sat_pure"])
def test_forest_duplicate_refs_sound(variant, mech):
    db, q, t, truth = _duplicate_space()
    ptr, penc, carried, jenc = build_tree_pair(variant, "l2", db, seed=5)
    res, _ = assert_walks_agree(
        forest.forest_range_search, jax_forest.forest_range_search,
        penc, carried, jenc, q, t, mech, tree.range_search(ptr, q, t, mech),
    )
    assert same_sets(res, truth)


@pytest.mark.parametrize("partition", ["closer", "median_x", "lrt"])
def test_monotone_duplicate_pivots_sound(partition):
    """Duplicate pivot pairs force the degenerate leaf-bucket fallback:
    buckets larger than leaf_cap, the padded leaf table."""
    db, q, t, truth = _duplicate_space()
    ptr, penc, carried, jenc = build_monotone_pair(partition, "far", "l2", db, seed=6)
    res, _ = assert_walks_agree(
        forest.monotone_range_search, jax_forest.monotone_range_search,
        penc, carried, jenc, q, t, HILBERT,
        lrt.range_search_monotone(ptr, q, t, HILBERT),
    )
    assert same_sets(res, truth)


def test_tiny_dataset_root_leaf():
    """Datasets at or below leaf_cap give the k == 0 wrapper root
    (partition tree) or a bare leaf root (monotone): root-attached buckets,
    alive for every query."""
    rng = np.random.default_rng(9)
    db = rng.random((6, 4))
    q = rng.random((3, 4))
    t = 0.4
    truth = tree.exhaustive_search("l2", db, q, t)
    ptr, penc, carried, jenc = build_tree_pair("hpt_random_fixed", "l2", db, seed=1)
    assert not penc.levels
    res, _ = assert_walks_agree(
        forest.forest_range_search, jax_forest.forest_range_search,
        penc, carried, jenc, q, t, HILBERT, tree.range_search(ptr, q, t, HILBERT),
    )
    assert same_sets(res, truth)
    mtr, menc, mcarried, mjenc = build_monotone_pair("closer", "far", "l2", db, seed=1)
    mres, _ = assert_walks_agree(
        forest.monotone_range_search, jax_forest.monotone_range_search,
        menc, mcarried, mjenc, q, t, HILBERT,
        lrt.range_search_monotone(mtr, q, t, HILBERT),
    )
    assert same_sets(mres, truth)


@pytest.mark.parametrize("metric", ["cosine", "jsd", "triangular"])
def test_forest_other_metrics(metric):
    """The walk is metric-dispatched: JSD and Triangular run their tiles'
    plain versions here, cosine its registry formula."""
    rng = np.random.default_rng(8)
    data = rng.random((500, 12)) + 1e-3
    if metric in ("jsd", "triangular"):
        data /= data.sum(axis=1, keepdims=True)
    db, q = data[:440], data[440:452]
    t = metricsets.calibrate_threshold(metric, db, 5e-3)
    ptr, penc, carried, jenc = build_tree_pair("hpt_fft_log", metric, db, seed=11)
    res, _ = assert_walks_agree(
        forest.forest_range_search, jax_forest.forest_range_search,
        penc, carried, jenc, q, t, HILBERT, tree.range_search(ptr, q, t, HILBERT),
    )
    assert sum(map(len, res)) > 0


@pytest.mark.parametrize("kind", ["hpt_fft_log", "sat_distal_pure", "monotone", "jsd"])
def test_bf16_leaf_phase_equals_fp32(kind):
    """``precision="bf16"``: hits, counts, attribution and frontier equal
    the fp32 walk's bit for bit; the margin equals the JAX package's and
    the band re-check counts equal its walk's."""
    db, q, t = _space()
    search, jax_search = forest.forest_range_search, jax_forest.forest_range_search
    if kind == "monotone":
        _, penc, _, jenc = build_monotone_pair("lrt", "far", "l2", db, seed=5)
        search, jax_search = forest.monotone_range_search, jax_forest.monotone_range_search
    elif kind == "jsd":
        rng = np.random.default_rng(8)
        data = rng.random((500, 12)) + 1e-3
        data /= data.sum(axis=1, keepdims=True)
        db, q = data[:440], data[440:452]
        t = metricsets.calibrate_threshold("jsd", db, 5e-2)
        _, penc, _, jenc = build_tree_pair("hpt_fft_log", "jsd", db, seed=11)
    else:
        _, penc, _, jenc = build_tree_pair(kind, "l2", db, seed=7)
    res32, st32 = search(penc, q, t, HILBERT)
    res16, st16 = search(penc, q, t, HILBERT, opts=EngineOpts(precision="bf16"))
    assert res16 == res32
    for key in ("per_query_dists", "frontier_occupancy"):
        np.testing.assert_array_equal(st16[key], st32[key])
    for m in st32["excluded"]:
        np.testing.assert_array_equal(st16["excluded"][m], st32["excluded"][m])
    assert st16["precision"] == "bf16" and st32["precision"] == "fp32"
    _, jst = jax_search(jenc, q, t, HILBERT, opts=JaxOpts(backend="jnp", precision="bf16"))
    assert st16["band_eps"] == jst["band_eps"] > 0
    np.testing.assert_array_equal(st16["per_query_recheck"], jst["per_query_recheck"])
    assert st16["recheck_tiles"] == jst["recheck_tiles"]
    assert st16["per_query_recheck"].sum() > 0 or kind == "jsd"
