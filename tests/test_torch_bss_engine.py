"""The port's BSS engine (``repro_torch.core.flat_index``) against the JAX
package on the CPU.

* ``build_bss`` lays the index out bit for bit as the reference does.
* On the very index JAX built (``index_from_arrays``), the port's
  ``bss_query_batched(backend="torch")`` returns the hit lists, ``alive``
  masks, ``per_query_dists`` and ``excluded["hilbert"]`` of JAX's Pallas
  kernels (interpret mode, ``bq=8``) and of its jnp backend, and of both
  numpy oracles — at thresholds snapped to gaps of the float64 distance
  distribution (``safe_threshold``, as ``tests/test_bss_engine.py``), so
  float32 and float64 cannot disagree on ``d <= t``.
* Device rules: no CUDA device means no default device and no ``"cuda"``
  backend.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import supermetric as r_configs
from repro.core import flat_index as r_flat
from repro.core.backends import EngineOpts as REngineOpts
from repro.core.distances import METRICS as R_METRICS
from repro.core.distances import get_metric as r_get_metric
from repro.core.npdist import pairwise_np
from repro_torch.configs import supermetric as t_configs
from repro_torch.core import backends as t_backends
from repro_torch.core import flat_index as t_flat
from repro_torch.core.backends import EngineOpts
from repro_torch.parallel import ShardMesh

_JNP = REngineOpts(backend="jnp")
_PALLAS = REngineOpts(backend="pallas", interpret=True, bq=8)

# the l2 / cosine cases of tests/test_bss_engine.py's SHAPES, then the rest
L2_SHAPES = [
    ("l2", 801, 17, 64, 33),
    ("l2", 1024, 32, 128, 128),
    ("cosine", 513, 9, 128, 21),
]
OTHER_SHAPES = [
    ("jsd", 330, 11, 32, 7),
    ("triangular", 257, 7, 64, 5),
    ("l1^0.5", 410, 13, 64, 9),
]
r_get_metric("l1^0.5")  # registered before METRICS is read


def _space(metric, n, dim, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, dim)).astype(np.float32) + 1e-3
    if metric in R_METRICS and R_METRICS[metric].probability_space:
        x /= x.sum(axis=1, keepdims=True)
    return x


def safe_threshold(dvals: np.ndarray, frac: float) -> float:
    """A threshold at ~the given quantile, snapped to the midpoint of a
    well-separated gap so float32 and float64 agree on every d <= t
    (copied from tests/test_bss_engine.py)."""
    vals = np.unique(np.sort(np.asarray(dvals, np.float64).ravel()))
    i = int(np.clip(frac * len(vals), 0, len(vals) - 2))
    for j in range(i, len(vals) - 1):
        if vals[j + 1] - vals[j] > 1e-4 * max(1.0, vals[j]):
            return float(0.5 * (vals[j] + vals[j + 1]))
    return float(vals[-1] + 1.0)


def _case(metric, n, dim, block, nq):
    data = _space(metric, n + nq, dim, seed=n + dim)
    db, q = data[:n], data[n:]
    r_idx = r_flat.build_bss(metric, db, n_pivots=8, n_pairs=10, block=block, seed=1)
    t_idx = t_flat.index_from_arrays(
        {f: getattr(r_idx, f) for f in t_flat.INDEX_FIELDS}, device="cpu")
    return db, q, r_idx, t_idx


def _assert_stats_equal(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key == "backend":
            continue
        if key == "excluded":
            assert set(g) == set(w)
            for mech in w:
                assert g[mech].dtype == w[mech].dtype
                np.testing.assert_array_equal(g[mech], w[mech])
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w, key


def _alive_ref(r_idx, q, t_vec, backend, bq, interpret):
    queries = r_flat._engine_queries(r_idx.metric_name, q)
    _, alive, _ = r_flat._query_batched_jit(
        r_flat._engine_metric(r_idx.metric_name), jnp.asarray(queries),
        jnp.asarray(t_vec), r_idx.device, block=r_idx.block, bq=bq,
        backend=backend, interpret=interpret,
    )
    return np.asarray(alive)


def _alive_port(t_idx, q, t_vec, bq):
    queries = t_flat._engine_queries(t_idx.metric_name, q)
    _, alive, _ = t_flat._query_batched(
        t_flat._engine_metric(t_idx.metric_name), torch.from_numpy(queries),
        torch.from_numpy(t_vec), t_idx.device, block=t_idx.block, bq=bq,
        backend="torch",
    )
    return alive.numpy()


# ------------------------------------------------------------------ build


@pytest.mark.parametrize("metric,n,dim,block,nq", L2_SHAPES + OTHER_SHAPES)
def test_build_layout_bit_identical(metric, n, dim, block, nq):
    db, _, r_idx, _ = _case(metric, n, dim, block, nq)
    t_idx = t_flat.build_bss(metric, db, n_pivots=8, n_pairs=10, block=block,
                             seed=1, device="cpu")
    for f in t_flat.INDEX_FIELDS:
        g, w = getattr(t_idx, f), getattr(r_idx, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, f


def test_build_duplicate_pivots_bit_identical():
    """tests/test_bss_engine.py:325: two distinct locations force duplicate
    pivots and delta == 0 planes."""
    rng = np.random.default_rng(7)
    locs = rng.random((2, 8)).astype(np.float32)
    db = np.repeat(locs, 50, axis=0)
    q = rng.random((11, 8)).astype(np.float32)
    r_idx = r_flat.build_bss("l2", db, n_pivots=8, n_pairs=28, block=32, seed=5)
    t_idx = t_flat.build_bss("l2", db, n_pivots=8, n_pairs=28, block=32, seed=5,
                             device="cpu")
    assert (t_idx.deltas == 0.0).any()
    for f in ("data", "perm", "valid", "pivots", "pairs", "deltas", "boxes"):
        np.testing.assert_array_equal(getattr(t_idx, f), getattr(r_idx, f), err_msg=f)
    lb = t_flat.bss_lower_bounds(t_idx, q)
    assert np.isfinite(lb).all()
    np.testing.assert_allclose(lb, r_flat.bss_lower_bounds(r_idx, q), rtol=1e-5, atol=1e-6)
    d = pairwise_np("l2", q, db)
    t = safe_threshold(d, 0.05)
    want, _ = r_flat.bss_query_batched(r_idx, q, t, opts=_JNP)
    got, _ = t_flat.bss_query_batched(t_idx, q, t, opts=EngineOpts(backend="torch"))
    assert got == want == t_flat.bss_query(t_idx, q, t)[0]


# ------------------------------------------------------------ range search


@pytest.mark.parametrize("metric,n,dim,block,nq", L2_SHAPES)
@pytest.mark.parametrize("ref_opts,bq", [(_PALLAS, 8), (_JNP, None)])
def test_range_identical_to_jax(metric, n, dim, block, nq, ref_opts, bq):
    db, q, r_idx, t_idx = _case(metric, n, dim, block, nq)
    t = safe_threshold(pairwise_np(metric, q, db), 0.02)
    want, w_stats = r_flat.bss_query_batched(r_idx, q, t, opts=ref_opts)
    got, g_stats = t_flat.bss_query_batched(
        t_idx, q, t, opts=EngineOpts(backend="torch", bq=bq))
    assert got == want  # same ids AND same per-query order
    assert got == r_flat.bss_query(r_idx, q, t)[0] == t_flat.bss_query(t_idx, q, t)[0]
    _assert_stats_equal(g_stats, w_stats)
    assert (g_stats["backend"], w_stats["backend"]) == ("torch", ref_opts.backend)
    t_vec = np.full(len(q), t, np.float32)
    bq_eff = bq or r_flat._DEFAULT_BQ
    np.testing.assert_array_equal(
        _alive_port(t_idx, q, t_vec, bq_eff),
        _alive_ref(r_idx, q, t_vec, ref_opts.backend, bq_eff, ref_opts.interpret),
    )


@pytest.mark.parametrize("metric,n,dim,block,nq", L2_SHAPES)
def test_per_query_t_with_padding_rows(metric, n, dim, block, nq):
    """Per-query radii (each snapped to its own row's gaps) with negative
    padding rows, as the serving front sends them."""
    db, q, r_idx, t_idx = _case(metric, n, dim, block, nq)
    d = pairwise_np(metric, q, db)
    t_vec = np.array([safe_threshold(d[i], 0.01 + 0.002 * i) for i in range(len(q))],
                     np.float32)
    t_vec[::4] = -1.0
    want, w_stats = r_flat.bss_query_batched(r_idx, q, t_vec, opts=_PALLAS)
    got, g_stats = t_flat.bss_query_batched(t_idx, q, t_vec,
                                            opts=EngineOpts(backend="torch", bq=8))
    assert got == want == r_flat.bss_query_batched(r_idx, q, t_vec, opts=_JNP)[0]
    assert got == t_flat.bss_query(t_idx, q, t_vec)[0]
    assert all(got[i] == [] for i in range(0, len(q), 4))
    _assert_stats_equal(g_stats, w_stats)
    assert (g_stats["per_query_dists"][::4] == t_idx.pivots.shape[0]).all()
    np.testing.assert_array_equal(_alive_port(t_idx, q, t_vec, 8),
                                  _alive_ref(r_idx, q, t_vec, "pallas", 8, True))


@pytest.mark.parametrize("ref_opts,bq", [(_PALLAS, 8), (_JNP, None)])
def test_zero_queries(ref_opts, bq):
    _, q, r_idx, t_idx = _case(*L2_SHAPES[0])
    want, w_stats = r_flat.bss_query_batched(r_idx, q[:0], 0.5, opts=ref_opts)
    got, g_stats = t_flat.bss_query_batched(t_idx, q[:0], 0.5,
                                            opts=EngineOpts(backend="torch", bq=bq))
    assert got == want == []
    _assert_stats_equal(g_stats, w_stats)


@pytest.mark.parametrize("metric,n,dim,block,nq", OTHER_SHAPES)
def test_range_other_metrics_match_jax_and_oracle(metric, n, dim, block, nq):
    """jsd / triangular / power transforms on the torch backend against the
    reference's jnp backend and the oracle."""
    db, q, r_idx, t_idx = _case(metric, n, dim, block, nq)
    t = safe_threshold(pairwise_np(metric, q, db), 0.02)
    want, w_stats = r_flat.bss_query_batched(r_idx, q, t, opts=_JNP)
    got, g_stats = t_flat.bss_query_batched(t_idx, q, t, opts=EngineOpts(backend="torch"))
    assert got == want == t_flat.bss_query(t_idx, q, t)[0]
    _assert_stats_equal(g_stats, w_stats)


@pytest.mark.parametrize("metric", ["jsd", "triangular"])
def test_range_prob_metrics_paper_layout_match_pallas(metric):
    """The paper's layout, 128-row blocks and 128-query tiles, against the
    reference's JSD / Triangular Pallas tiles in interpret mode: hits,
    ``alive`` and every stat identical."""
    db, q, r_idx, t_idx = _case(metric, 600, 16, 128, 150)
    t = safe_threshold(pairwise_np(metric, q, db), 0.02)
    pallas = REngineOpts(backend="pallas", interpret=True, bq=128)
    want, w_stats = r_flat.bss_query_batched(r_idx, q, t, opts=pallas)
    got, g_stats = t_flat.bss_query_batched(t_idx, q, t,
                                            opts=EngineOpts(backend="torch", bq=128))
    assert got == want == t_flat.bss_query(t_idx, q, t)[0]
    assert sum(map(len, got)) > 0
    _assert_stats_equal(g_stats, w_stats)
    t_vec = np.full(len(q), t, np.float32)
    np.testing.assert_array_equal(_alive_port(t_idx, q, t_vec, 128),
                                  _alive_ref(r_idx, q, t_vec, "pallas", 128, True))


@pytest.mark.parametrize("t,expect_all", [(-1.0, False), (1e6, True)])
def test_range_all_and_none_excluded(t, expect_all):
    db, q, _, t_idx = _case("l2", 400, 10, 64, 23)
    got, stats = t_flat.bss_query_batched(t_idx, q, t, opts=EngineOpts(backend="torch"))
    assert got == t_flat.bss_query(t_idx, q, t)[0]
    if expect_all:
        assert all(len(r) == len(db) for r in got)
        assert stats["block_exclusion_rate"] == 0.0
    else:
        assert all(len(r) == 0 for r in got)
        assert stats["block_exclusion_rate"] == 1.0


def test_lower_bounds_sound_and_close_to_jax():
    db, q, r_idx, t_idx = _case("l2", 801, 17, 64, 33)
    lb = t_flat.bss_lower_bounds(t_idx, q)
    np.testing.assert_allclose(lb, r_flat.bss_lower_bounds(r_idx, q), rtol=1e-5, atol=1e-6)
    d = pairwise_np("l2", q, t_idx.data)
    d = np.where(t_idx.valid[None, :], d, np.inf)
    per_block_min = d.reshape(len(q), t_idx.n_blocks, t_idx.block).min(axis=2)
    assert np.all(lb <= per_block_min + 1e-4)


# ----------------------------------------------------------- device rules


def test_no_cuda_device_means_no_default_device(monkeypatch):
    db = _space("l2", 64, 6, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_flat.build_bss("l2", db, n_pivots=4, n_pairs=4, block=32)
    r_idx = r_flat.build_bss("l2", db, n_pivots=4, n_pairs=4, block=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_flat.index_from_arrays({f: getattr(r_idx, f) for f in t_flat.INDEX_FIELDS})


def test_backend_rules_on_a_cpu_index():
    db, q, _, t_idx = _case("l2", 200, 6, 32, 5)
    with pytest.raises(ValueError, match="CUDA device"):
        t_flat.bss_query_batched(t_idx, q, 0.5, opts=EngineOpts(backend="cuda"))
    for metric in ("jsd", "triangular"):
        _, pq, _, p_idx = _case(metric, 200, 6, 32, 5)
        with pytest.raises(ValueError, match="CUDA device"):
            t_flat.bss_query_batched(p_idx, pq, 0.5, opts=EngineOpts(backend="cuda"))
        with pytest.raises(ValueError, match="CUDA device"):
            t_flat.bss_knn_batched(p_idx, pq, 3, opts=EngineOpts(backend="cuda"))
    auto, stats = t_flat.bss_query_batched(t_idx, q, 0.5, opts=EngineOpts())
    assert stats["backend"] == "torch"
    assert auto == t_flat.bss_query_batched(t_idx, q, 0.5, backend="torch")[0]
    assert t_backends.resolve_backend("auto", torch.device("cpu")) == "torch"
    h16, s16 = t_flat.bss_query_batched(t_idx, q, 0.5, opts=EngineOpts(precision="bf16"))
    assert h16 == auto and s16["precision"] == "bf16" and s16["backend"] == "torch"
    with pytest.raises(ValueError, match="fp32\\|bf16"):
        EngineOpts(precision="fp16")
    with pytest.raises(ValueError, match="not both"):
        t_flat.bss_query_batched(t_idx, q, 0.5, opts=EngineOpts(), bq=8)
    with pytest.raises(ValueError, match="auto\\|cuda\\|torch"):
        EngineOpts(backend="pallas")
    # a mesh shards the index (tests/test_torch_sharded.py): one without a
    # data axis raises, and a one-shard mesh answers as the meshless index
    with pytest.raises(ValueError, match="data axis"):
        t_flat.build_bss("l2", db, device="cpu",
                         mesh=ShardMesh(("cpu",), axis_names=("model",)))
    with pytest.raises(TypeError, match="ShardMesh"):
        t_flat.build_bss("l2", db, device="cpu", mesh=object())
    one = dataclasses.replace(t_idx, mesh=ShardMesh(("cpu",)), _device=None)
    h1, s1 = t_flat.bss_query_batched(one, q, 0.5, backend="torch")
    assert h1 == auto and s1["engine"] == "sharded" and s1["n_shards"] == 1
    with pytest.raises(ValueError, match="four-point"):
        t_flat.build_bss("l1", db, n_pivots=4, n_pairs=4, block=32, device="cpu")
    with pytest.raises(ValueError, match="per-query t"):
        t_flat.bss_query_batched(t_idx, q, np.ones(3), backend="torch")
    assert t_backends.bucket_for(9) == 32
    with pytest.raises(ValueError):
        t_backends.bucket_for(513)


def test_tile_survival_matches_reference():
    from repro.core.backends import tile_survival as r_tile_survival

    alive = np.random.default_rng(0).random((21, 7)) < 0.2
    for bq in (1, 4, 8, 32):
        np.testing.assert_array_equal(
            t_backends.tile_survival(torch.from_numpy(alive), bq).numpy(),
            np.asarray(r_tile_survival(jnp.asarray(alive), bq)),
        )


# ---------------------------------------------------------------- configs


def test_config_corpus_and_index_match_reference():
    assert set(t_configs.CONFIGS) == set(r_configs.CONFIGS)
    for name, cfg in t_configs.CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(r_configs.CONFIGS[name])
    t_cfg = dataclasses.replace(t_configs.SISAP_COLORS, n_points=2000)
    r_cfg = dataclasses.replace(r_configs.SISAP_COLORS, n_points=2000)
    (t_db, t_q), (r_db, r_q) = t_configs.load_corpus(t_cfg), r_configs.load_corpus(r_cfg)
    np.testing.assert_array_equal(t_db, r_db)
    np.testing.assert_array_equal(t_q, r_q)
    t_idx = t_configs.build_index(t_cfg, t_db, device="cpu")
    r_idx = r_configs.build_index(r_cfg, r_db)
    for f in ("data", "perm", "pairs", "deltas", "boxes"):
        np.testing.assert_array_equal(getattr(t_idx, f), getattr(r_idx, f), err_msg=f)
    # the host trees of the forest engines: the reference's builds
    for engine in ("tree", "lrt"):
        t_tr = t_configs.build_index(t_cfg, t_db, engine=engine, device="cpu")
        r_tr = r_configs.build_index(r_cfg, r_db, engine=engine)
        assert type(t_tr).__name__ == type(r_tr).__name__
        assert (t_tr.n_nodes, t_tr.max_depth, t_tr.build_distances) == (
            r_tr.n_nodes, r_tr.max_depth, r_tr.build_distances), engine
        np.testing.assert_array_equal(t_tr.data, r_tr.data)
    with pytest.raises(ValueError):
        t_configs.build_index(t_cfg, t_db, engine="nope", device="cpu")
