"""The port's bf16 exact phase (``precision="bf16"``) on the CPU.

On the very index JAX built (``index_from_arrays``), the port's range
search and kNN with ``precision="bf16"`` on the ``"torch"`` backend

* equal the port's float32 results bit for bit: hit lists, kNN ids and
  distances, and every stats key the float32 pass has;
* equal JAX's bf16 results on its jnp backend with ``realisation="dense"``
  (both pinned to the dense scheme; ``tests/test_torch_adaptive.py`` holds
  the sparse one): hits, the dense hit mask and ``alive`` of one
  pass, ``per_query_dists``, ``excluded``, kNN ids and rounds, ``band_eps``
  (bit-equal), ``recheck_tiles`` and ``per_query_recheck``.

Under l2, cosine, jsd and triangular, with a scalar threshold and with a
per-query threshold vector (negative radii included), at thresholds
snapped to gaps of the float64 distances.  Also the empty batch, option
validation, kNN with ``k`` above the valid corpus, and the mirror itself.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat_index as r_flat
from repro.core.backends import EngineOpts as REngineOpts
from repro.core.npdist import pairwise_np
from repro_torch.core import flat_index as t_flat
from repro_torch.core import precision as t_precision
from repro_torch.core.backends import EngineOpts
from test_torch_bss_engine import _assert_stats_equal, _space, safe_threshold

METRICS = ("l2", "cosine", "jsd", "triangular")
_R16 = REngineOpts(backend="jnp", realisation="dense", precision="bf16")
_T32 = EngineOpts(backend="torch", realisation="dense")
_T16 = EngineOpts(backend="torch", precision="bf16", realisation="dense")
BF16_KEYS = ("band_eps", "recheck_tiles", "per_query_recheck", "recheck_points_per_query")


@pytest.fixture(scope="module")
def case():
    cache = {}

    def get(metric):
        if metric not in cache:
            data = _space(metric, 640 + 23, 12, seed=31)
            db, q = data[:640], data[640:]
            r_idx = r_flat.build_bss(metric, db, n_pivots=8, n_pairs=10, block=64, seed=2)
            t_idx = t_flat.index_from_arrays(
                {f: getattr(r_idx, f) for f in t_flat.INDEX_FIELDS}, device="cpu")
            d = pairwise_np(metric, q, db)
            t = safe_threshold(d, 0.04)
            # per-query radii: two quantiles, and two rows at -1 (padding)
            t_vec = np.where(np.arange(len(q)) % 2 == 0, t, safe_threshold(d, 0.01))
            t_vec = t_vec.astype(np.float32)
            t_vec[[3, 11]] = -1.0
            cache[metric] = db, q, r_idx, t_idx, t, t_vec
        return cache[metric]

    return get


def _assert_same_as_fp32(s16, s32):
    """Every key of the float32 stats is equal; bf16 adds only its own."""
    assert s16["precision"] == "bf16" and s32["precision"] == "fp32"
    assert set(s16) - set(s32) == set(BF16_KEYS)
    _assert_stats_equal({k: v for k, v in s16.items() if k not in BF16_KEYS},
                        dict(s32, precision="bf16"))


def _assert_bf16_keys_equal(got, want):
    assert np.float64(got["band_eps"]).view(np.uint64) == np.float64(
        want["band_eps"]).view(np.uint64)
    assert got["recheck_tiles"] == want["recheck_tiles"]
    assert got["per_query_recheck"].dtype == np.int64
    np.testing.assert_array_equal(got["per_query_recheck"], want["per_query_recheck"])
    assert got["recheck_points_per_query"] == want["recheck_points_per_query"]


@pytest.mark.parametrize("per_query_t", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_range_bf16_equals_fp32_and_jax(case, metric, per_query_t):
    _, q, r_idx, t_idx, t, t_vec = case(metric)
    th = t_vec if per_query_t else t
    h16, s16 = t_flat.bss_query_batched(t_idx, q, th, opts=_T16)
    h32, s32 = t_flat.bss_query_batched(t_idx, q, th, opts=_T32)
    assert h16 == h32
    assert sum(map(len, h16)) > 0
    _assert_same_as_fp32(s16, s32)
    rh, rs = r_flat.bss_query_batched(r_idx, q, th, opts=_R16)
    assert h16 == rh
    _assert_stats_equal(s16, rs)
    _assert_bf16_keys_equal(s16, rs)
    assert s16["band_eps"] == t_idx.bf16_margin() == r_idx.bf16_margin()
    if per_query_t:
        assert h16[3] == h16[11] == []


@pytest.mark.parametrize("metric", METRICS)
def test_range_bf16_pass_equals_jax_pass(case, metric):
    """One pass of each scheme on the same inputs: the dense hit mask,
    ``alive``, ``tile_mask``, the re-checked tiles and the band counts."""
    _, q, r_idx, t_idx, _, t_vec = case(metric)
    eps = t_idx.bf16_margin()
    qe = t_flat._engine_queries(metric, q)
    eng = t_flat._engine_metric(metric)
    got = t_flat._query_batched_bf16(
        eng, torch.from_numpy(qe), torch.from_numpy(t_vec), t_idx.device,
        t_idx.device_bf16, torch.tensor(eps, dtype=torch.float32),
        block=t_idx.block, bq=8, backend="torch")
    want = r_flat._query_batched_bf16_jit(
        eng, jnp.asarray(qe), jnp.asarray(t_vec), r_idx.device, r_idx.device_bf16,
        jnp.float32(eps), block=r_idx.block, bq=8, backend="jnp", interpret=None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    hit32 = t_flat._query_batched(eng, torch.from_numpy(qe), torch.from_numpy(t_vec),
                                  t_idx.device, block=t_idx.block, bq=8, backend="torch")
    assert torch.equal(got[0], hit32[0] <= torch.from_numpy(t_vec)[:, None])
    assert torch.equal(got[1], hit32[1]) and torch.equal(got[2], hit32[2])


@pytest.mark.parametrize("metric", METRICS)
def test_knn_bf16_equals_fp32_and_jax(case, metric):
    _, q, r_idx, t_idx, _, _ = case(metric)
    i16, d16, s16 = t_flat.bss_knn_batched(t_idx, q, 7, opts=_T16)
    i32, d32, s32 = t_flat.bss_knn_batched(t_idx, q, 7, opts=_T32)
    np.testing.assert_array_equal(i16, i32)
    np.testing.assert_array_equal(d16, d32)
    _assert_same_as_fp32(s16, s32)
    assert s16["rounds"] > 1
    ri, rd, rs = r_flat.bss_knn_batched(r_idx, q, 7, opts=_R16)
    np.testing.assert_array_equal(i16, ri)
    np.testing.assert_allclose(d16, rd, rtol=1e-5, atol=1e-5)
    _assert_stats_equal(s16, rs)
    _assert_bf16_keys_equal(s16, rs)


def test_knn_bf16_k_above_valid_corpus_pads():
    db, q = _space("jsd", 40, 6, seed=4), _space("jsd", 5, 6, seed=5)
    r_idx = r_flat.build_bss("jsd", db, n_pivots=4, n_pairs=4, block=16, seed=1)
    t_idx = t_flat.index_from_arrays(
        {f: getattr(r_idx, f) for f in t_flat.INDEX_FIELDS}, device="cpu")
    got = t_flat.bss_knn_batched(t_idx, q, 50, opts=_T16)
    want = r_flat.bss_knn_batched(r_idx, q, 50, opts=_R16)
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[0][:, 40:] == -1).all() and np.isinf(got[1][:, 40:]).all()
    np.testing.assert_array_equal(got[0], t_flat.bss_knn_batched(t_idx, q, 50, opts=_T32)[0])
    _assert_stats_equal(got[2], want[2])
    _assert_bf16_keys_equal(got[2], want[2])


def test_bf16_empty_batch_and_empty_corpus(case):
    _, q, r_idx, t_idx, t, _ = case("l2")
    hits, stats = t_flat.bss_query_batched(t_idx, q[:0], t, opts=_T16)
    r_hits, r_stats = r_flat.bss_query_batched(r_idx, q[:0], t, opts=_R16)
    assert hits == r_hits == []
    _assert_stats_equal(stats, r_stats)
    _assert_bf16_keys_equal(stats, r_stats)
    got = t_flat.bss_knn_batched(t_idx, q[:0], 4, opts=_T16)
    want = r_flat.bss_knn_batched(r_idx, q[:0], 4, opts=_R16)
    assert got[0].shape == (0, 4)
    _assert_stats_equal(got[2], want[2])
    _assert_bf16_keys_equal(got[2], want[2])
    # no valid row left: every id -1, zero work
    empty = dataclasses.replace(t_idx, valid=np.zeros_like(t_idx.valid))
    r_empty = dataclasses.replace(r_idx, valid=np.zeros_like(r_idx.valid))
    got = t_flat.bss_knn_batched(empty, q, 4, opts=_T16)
    want = r_flat.bss_knn_batched(r_empty, q, 4, opts=_R16)
    assert (got[0] == -1).all()
    _assert_stats_equal(got[2], want[2])
    _assert_bf16_keys_equal(got[2], want[2])


def test_bf16_option_validation(case):
    _, q, _, t_idx, t, _ = case("l2")
    with pytest.raises(ValueError, match="precision"):
        t_flat.bss_query_batched(t_idx, q, t, precision="fp16")
    with pytest.raises(ValueError, match="precision"):
        t_flat.bss_knn_batched(t_idx, q, 3, precision="f32")
    with pytest.raises(ValueError, match="CUDA device"):
        t_flat.bss_query_batched(t_idx, q, t, opts=EngineOpts(backend="cuda",
                                                              precision="bf16"))
    with pytest.raises(ValueError, match="shape"):
        t_flat.bss_query_batched(t_idx, q, np.ones(3, np.float32), opts=_T16)
    # the legacy per-knob spelling reaches the same path
    assert (t_flat.bss_query_batched(t_idx, q, t, backend="torch", precision="bf16")[0]
            == t_flat.bss_query_batched(t_idx, q, t, opts=_T16)[0])


@pytest.mark.parametrize("metric", METRICS)
def test_bf16_mirror_holds_the_host_rounded_bits(case, metric):
    _, _, r_idx, t_idx, _, _ = case(metric)
    mirror = t_idx.device_bf16
    assert mirror is t_idx.device_bf16  # built once
    assert mirror.dtype == torch.bfloat16 and tuple(mirror.shape) == t_idx.data.shape
    np.testing.assert_array_equal(mirror.float().numpy(), t_precision.bf16_round_np(t_idx.data))
    np.testing.assert_array_equal(mirror.float().numpy(),
                                  np.asarray(r_idx.device_bf16, np.float32))
    assert t_idx.bf16_margin() == r_idx.bf16_margin()
    # the fp32 mirror and the host arrays are untouched
    np.testing.assert_array_equal(t_idx.device.data.numpy(), t_idx.data)
