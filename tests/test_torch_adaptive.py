"""The ``"torch"`` backend's adaptive realisation against the reference's
jnp ``realisation="adaptive"`` on the CPU.

On clustered data at a low threshold the planar bound leaves at most
``_DENSE_ALIVE_FRAC`` (0.08) of the (query, block) cells alive, so both
packages evaluate only the alive cells (the cell-gather realisation); the
test asserts the alive share and that the port's sparse functions ran.
Range search, fp32 and bf16: the hit lists and every stats key equal the
reference's (bf16: ``recheck_tiles`` 0 and the band points per query, as
its sparse branch reports them).  kNN, fp32 and bf16: the ids and rounds
equal, the distances within 1e-5 (two fp32 implementations), and the
per-query counts equal: the reference's contract lets them move only
where a last-ulp difference moves the radius schedule, and no distance of
these cases lies that close to a radius.  Also: the port's sparse bf16
results equal its sparse fp32 results bit for bit, and ``"dense"`` pins
the dense pass.
"""

import numpy as np
import pytest

from repro.core import flat_index as r_flat
from repro.core.backends import EngineOpts as REngineOpts
from repro.core.npdist import pairwise_np
from repro_torch.core import flat_index as t_flat
from repro_torch.core.backends import EngineOpts
from test_torch_bss_engine import _assert_stats_equal, safe_threshold

METRICS = ("l2", "cosine", "jsd", "triangular")
SPARSE = ("_cells_exact", "_cells_exact_bf16", "_knn_round_cells", "_knn_round_cells_bf16",
          "_dense_hit_mask")


def clustered(metric, n, dim, seed, centres=40, spread=0.1):
    """Rows around ``centres`` random points (probability rows for JSD and
    Triangular, centred on the origin for l2 and cosine), so that the
    planar bound excludes most blocks at a low threshold."""
    rng = np.random.default_rng(seed)
    if metric in ("jsd", "triangular"):
        c = rng.random((centres, dim))
        x = c[rng.integers(0, centres, n)] + spread * rng.random((n, dim)) + 1e-3
        x /= x.sum(axis=1, keepdims=True)
    else:
        c = rng.random((centres, dim)) - 0.5
        x = c[rng.integers(0, centres, n)] + spread * (rng.random((n, dim)) - 0.5)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def case():
    cache = {}

    def get(metric):
        if metric not in cache:
            data = clustered(metric, 3040, 12, seed=5)
            db, q = data[:3000], data[3000:]
            r_idx = r_flat.build_bss(metric, db, n_pivots=8, n_pairs=12, block=32, seed=3)
            t_idx = t_flat.index_from_arrays(
                {f: getattr(r_idx, f) for f in t_flat.INDEX_FIELDS}, device="cpu")
            t = safe_threshold(pairwise_np(metric, q, db), 0.003)
            cache[metric] = q, r_idx, t_idx, t
        return cache[metric]

    return get


@pytest.fixture
def calls(monkeypatch):
    """Counts of the port's realisation functions called in the test."""
    counts = dict.fromkeys(SPARSE, 0)
    for name in SPARSE:
        real = getattr(t_flat, name)

        def spy(*args, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(t_flat, name, spy)
    return counts


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("metric", METRICS)
def test_range_adaptive_equals_jax_adaptive(case, calls, metric, precision):
    q, r_idx, t_idx, t = case(metric)
    alive = t_flat.bss_lower_bounds(t_idx, q) <= np.float32(t)
    assert alive.mean() <= t_flat._DENSE_ALIVE_FRAC == r_flat._DENSE_ALIVE_FRAC
    want, w_stats = r_flat.bss_query_batched(
        r_idx, q, t, opts=REngineOpts(backend="jnp", precision=precision))
    got, g_stats = t_flat.bss_query_batched(
        t_idx, q, t, opts=EngineOpts(backend="torch", precision=precision))
    assert got == want == t_flat.bss_query(t_idx, q, t)[0]
    assert sum(map(len, got)) > 0
    _assert_stats_equal(g_stats, w_stats)
    if precision == "bf16":
        assert g_stats["recheck_tiles"] == 0
        assert calls["_cells_exact_bf16"] == 1
        assert calls["_cells_exact"] == (g_stats["per_query_recheck"].sum() > 0)
        fp32 = t_flat.bss_query_batched(t_idx, q, t, opts=EngineOpts(backend="torch"))
        assert fp32[0] == got
    else:
        assert calls["_cells_exact"] == 1
    assert calls["_dense_hit_mask"] == 0
    # "dense" pins the dense pass: the same hits
    dense, _ = t_flat.bss_query_batched(
        t_idx, q, t, opts=EngineOpts(backend="torch", precision=precision,
                                     realisation="dense"))
    assert dense == got


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("metric", METRICS)
def test_knn_adaptive_equals_jax_adaptive(case, calls, metric, precision):
    q, r_idx, t_idx, _ = case(metric)
    want = r_flat.bss_knn_batched(r_idx, q, 5, opts=REngineOpts(backend="jnp",
                                                              precision=precision))
    got = t_flat.bss_knn_batched(t_idx, q, 5, opts=EngineOpts(backend="torch",
                                                             precision=precision))
    assert calls["_knn_round_cells"] >= 1
    assert calls["_knn_round_cells_bf16"] == (calls["_knn_round_cells"]
                                              if precision == "bf16" else 0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    _assert_stats_equal(got[2], want[2])
    if precision == "bf16":
        fp32 = t_flat.bss_knn_batched(t_idx, q, 5, opts=EngineOpts(backend="torch"))
        np.testing.assert_array_equal(got[0], fp32[0])
        np.testing.assert_array_equal(got[1], fp32[1])
        assert got[2]["rounds"] == fp32[2]["rounds"]
        np.testing.assert_array_equal(got[2]["per_query_dists"], fp32[2]["per_query_dists"])
