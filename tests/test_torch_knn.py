"""The port's kNN engine (``repro_torch.core.flat_index.bss_knn_batched``)
against the JAX package on the CPU.

On the very index JAX built (``index_from_arrays``), the port's
``bss_knn_batched(backend="torch")`` returns exactly what JAX's
``bss_knn_batched`` returns under ``realisation="dense"`` — on its jnp
backend and on its Pallas kernels in interpret mode (``bq=8``): the same
ids, rounds, ``per_query_dists``, ``excluded["hilbert"]`` and
``tiles_computed``, with distances within 1e-5.  The reference is pinned
to dense because its cell-gather rounds may differ in the last ulp and so
shift the radius schedule (``repro.core.flat_index.bss_knn_batched``
docstring), and the port is pinned to dense rounds too
(``tests/test_torch_adaptive.py`` compares the adaptive rounds).  The cases mirror
``tests/test_bss_engine.py`` (uniform random data, on which no float32
near-tie moves the schedule).
"""

import numpy as np
import pytest

from repro.core import flat_index as r_flat
from repro.core.backends import EngineOpts as REngineOpts
from repro.core.npdist import pairwise_np
from repro_torch.core import flat_index as t_flat
from repro_torch.core.backends import EngineOpts
from test_torch_bss_engine import _assert_stats_equal, _space

_JNP = REngineOpts(backend="jnp", realisation="dense")
_PALLAS = REngineOpts(backend="pallas", interpret=True, bq=8, realisation="dense")
_TORCH = EngineOpts(backend="torch", realisation="dense")

# tests/test_bss_engine.py:124-131
KNN_SHAPES = [
    ("l2", 900, 16, 64, 37, 7),
    ("l2", 1111, 24, 128, 128, 1),
    ("cosine", 640, 12, 128, 19, 10),
    ("jsd", 385, 9, 32, 11, 5),
    ("triangular", 300, 8, 64, 9, 4),
    ("l1^0.5", 420, 10, 64, 13, 6),
]


def _indexes(metric, db, **build):
    r_idx = r_flat.build_bss(metric, db, **build)
    t_idx = t_flat.index_from_arrays(
        {f: getattr(r_idx, f) for f in t_flat.INDEX_FIELDS}, device="cpu")
    return r_idx, t_idx


def _assert_knn_identical(got, want):
    g_ids, g_d, g_stats = got
    w_ids, w_d, w_stats = want
    assert g_ids.dtype == np.int64 and g_d.dtype == np.float32
    np.testing.assert_array_equal(g_ids, w_ids)
    np.testing.assert_allclose(g_d, w_d, rtol=1e-5, atol=1e-5)
    _assert_stats_equal(g_stats, w_stats)
    assert g_stats["kind"] == "knn" and g_stats["backend"] == "torch"


@pytest.mark.parametrize("metric,n,dim,block,nq,k", KNN_SHAPES)
@pytest.mark.parametrize("ref_opts,bq", [(_JNP, None), (_PALLAS, 8)])
def test_knn_identical_to_jax_dense(metric, n, dim, block, nq, k, ref_opts, bq):
    data = _space(metric, n + nq, dim, seed=n * 3 + k)
    db, q = data[:n], data[n:]
    r_idx, t_idx = _indexes(metric, db, n_pivots=8, n_pairs=10, block=block, seed=4)
    want = r_flat.bss_knn_batched(r_idx, q, k, opts=ref_opts)
    got = t_flat.bss_knn_batched(t_idx, q, k,
                                 opts=EngineOpts(backend="torch", bq=bq, realisation="dense"))
    _assert_knn_identical(got, want)
    assert got[2]["rounds"] >= 1


@pytest.mark.parametrize("metric,n,dim,block,nq,k", KNN_SHAPES)
def test_knn_matches_bruteforce(metric, n, dim, block, nq, k):
    """tests/test_bss_engine.py:133: the neighbour sets of the float64
    brute force, with ascending exact distances."""
    data = _space(metric, n + nq, dim, seed=n * 3 + k)
    db, q = data[:n], data[n:]
    t_idx = t_flat.build_bss(metric, db, n_pivots=8, n_pairs=10, block=block, seed=4,
                             device="cpu")
    truth = pairwise_np(metric, q, db)
    ids, dists, stats = t_flat.bss_knn_batched(t_idx, q, k, opts=_TORCH)
    for i in range(nq):
        assert set(ids[i].tolist()) == set(np.argsort(truth[i])[:k].tolist()), i
        np.testing.assert_allclose(dists[i], np.sort(truth[i])[:k], rtol=1e-5, atol=1e-5)
    assert stats["dists_per_query"] >= stats["pivot_dists_per_query"]


def test_knn_k_exceeding_corpus_pads():
    db, q = _space("l2", 40, 6, seed=8), _space("l2", 3, 6, seed=9)
    r_idx, t_idx = _indexes("l2", db, n_pivots=4, n_pairs=4, block=32, seed=6)
    got = t_flat.bss_knn_batched(t_idx, q, 50, opts=_TORCH)
    _assert_knn_identical(got, r_flat.bss_knn_batched(r_idx, q, 50, opts=_JNP))
    ids, dists, _ = got
    assert ids.shape == (3, 50)
    assert (ids[:, :40] >= 0).all() and (ids[:, 40:] == -1).all()
    assert np.isinf(dists[:, 40:]).all()
    truth = pairwise_np("l2", q, db)
    for i in range(3):
        assert set(ids[i, :40].tolist()) == set(range(40))
        np.testing.assert_allclose(dists[i, :40], np.sort(truth[i]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("r0", [1e-6, 0.3, 100.0])
def test_knn_fixed_r0(r0):
    """An initial radius that starts too tight or too wide stays exact and
    follows the reference's schedule."""
    db, q = _space("l2", 700, 14, seed=11), _space("l2", 17, 14, seed=12)
    r_idx, t_idx = _indexes("l2", db, n_pivots=8, n_pairs=10, block=64, seed=7)
    got = t_flat.bss_knn_batched(t_idx, q, 5, r0=r0, opts=_TORCH)
    _assert_knn_identical(got, r_flat.bss_knn_batched(r_idx, q, 5, r0=r0, opts=_JNP))
    truth = np.argsort(pairwise_np("l2", q, db), axis=1)[:, :5]
    for i in range(len(q)):
        assert set(got[0][i].tolist()) == set(truth[i].tolist()), (r0, i)


def test_knn_accounting_excludes_padding():
    """tests/test_bss_engine.py:308: a radius that admits every block in
    round one charges the 200 valid points, not the 256 padded slots."""
    db, q = _space("l2", 200, 8, seed=3), _space("l2", 5, 8, seed=4)
    r_idx, t_idx = _indexes("l2", db, n_pivots=6, n_pairs=8, block=128, seed=3)
    got = t_flat.bss_knn_batched(t_idx, q, 3, r0=1e6, opts=_TORCH)
    _assert_knn_identical(got, r_flat.bss_knn_batched(r_idx, q, 3, r0=1e6, opts=_JNP))
    stats = got[2]
    assert stats["rounds"] == 1
    assert stats["exact_dists_per_query"] == pytest.approx(200.0)
    assert stats["dists_per_query"] == pytest.approx(206.0)


def test_knn_duplicate_pivots():
    """tests/test_bss_engine.py:325: two distinct locations force duplicate
    pivots and delta == 0 planes.  The results equal the reference's: the
    ids in its tie order (lowest position first among the 50 exact
    duplicates per location) and its distances.  The counts are not
    compared here: a block that holds one location has a point box, so its
    bound equals its distance up to rounding, and whether ``kth <= radius``
    ends a query's rounds is decided by the last ulp of either side (the
    float32 tie the reference's docstring names)."""
    rng = np.random.default_rng(7)
    db = np.repeat(rng.random((2, 8)).astype(np.float32), 50, axis=0)
    q = rng.random((11, 8)).astype(np.float32)
    r_idx, t_idx = _indexes("l2", db, n_pivots=8, n_pairs=28, block=32, seed=5)
    assert (t_idx.deltas == 0.0).any()
    ids, dists, stats = t_flat.bss_knn_batched(t_idx, q, 4, opts=_TORCH)
    w_ids, w_dists, _ = r_flat.bss_knn_batched(r_idx, q, 4, opts=_JNP)
    np.testing.assert_array_equal(ids, w_ids)
    np.testing.assert_allclose(dists, w_dists, rtol=1e-5, atol=1e-5)
    truth = np.sort(pairwise_np("l2", q, db), axis=1)[:, :4]
    np.testing.assert_allclose(dists, truth, rtol=1e-5, atol=1e-5)
    assert np.isfinite(t_flat.bss_lower_bounds(t_idx, q)).all()
    assert stats["rounds"] >= 1


def test_knn_zero_queries_and_validation():
    db, q = _space("l2", 200, 6, seed=1), _space("l2", 5, 6, seed=2)
    r_idx, t_idx = _indexes("l2", db, n_pivots=4, n_pairs=4, block=32, seed=1)
    got = t_flat.bss_knn_batched(t_idx, q[:0], 3, opts=_TORCH)
    assert got[0].shape == (0, 3) and got[1].shape == (0, 3)
    _assert_knn_identical(got, r_flat.bss_knn_batched(r_idx, q[:0], 3, opts=_JNP))
    with pytest.raises(ValueError, match="k must be positive"):
        t_flat.bss_knn_batched(t_idx, q, 0, opts=_TORCH)
    ids16, d16, s16 = t_flat.bss_knn_batched(
        t_idx, q, 3, opts=EngineOpts(precision="bf16", realisation="dense"))
    ids32, d32, _ = t_flat.bss_knn_batched(t_idx, q, 3, opts=_TORCH)
    assert np.array_equal(ids16, ids32) and np.array_equal(d16, d32)
    assert s16["precision"] == "bf16" and s16["band_eps"] == t_idx.bf16_margin()
    with pytest.raises(ValueError, match="CUDA device"):
        t_flat.bss_knn_batched(t_idx, q, 3, opts=EngineOpts(backend="cuda"))
    with pytest.raises(ValueError, match="not both"):
        t_flat.bss_knn_batched(t_idx, q, 3, opts=_TORCH, bq=8)
    ids, _, stats = t_flat.bss_knn_batched(t_idx, q, 3, backend="torch")  # legacy kwargs
    assert stats["backend"] == "torch" and ids.shape == (5, 3)
