"""The port's ``RetrievalServer`` against the JAX package's, on the CPU.

Both servers are built on the same numpy-seeded corpus (1,600 x 16 rows,
8 pivots, 10 planes, 64-row blocks, as ``tests/test_async_front.py``
sizes its index) and must return the same range hits, kNN ids and
distances, per-query distance counts and index generations, before and
after ``append`` / ``delete`` / ``compact``.  Exact results are compared
without tolerance: thresholds are snapped to a gap between distances
(``_snap``, the reference tests' idiom) so float32 and float64 agree on
every ``d <= t``.  kNN distances are held to the JAX package's within
1e-5, as ``tests/test_torch_knn.py`` holds the engines: torch and XLA sum
a distance in another order, so the last ulp may differ; ids and counts
are equal.  The mirror of ``tests/test_serving.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.serve.retrieval import RetrievalServer as JaxServer
from repro_torch.core.backends import EngineOpts
from repro_torch.core.npdist import pairwise_np
from repro_torch.parallel import ShardMesh
from repro_torch.serve.retrieval import (
    FOREST_IMMUTABLE,
    FOREST_KNN_ERROR,
    RetrievalServer,
    ServeStats,
    distance_to_score,
    score_to_distance,
)

DIM = 16
KNN_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_knn.py
BUILD = dict(n_pivots=8, n_pairs=10, block=64, seed=5)
METRICS = ["cosine", "l2", "jsd", "triangular"]
DENSE = EngineOpts(realisation="dense")


def _space(metric: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.random((n, DIM)).astype(np.float32) + 1e-3
    if metric in ("jsd", "triangular"):
        x /= x.sum(axis=1, keepdims=True)
    return x


def _snap(dvals: np.ndarray, frac: float) -> float:
    vals = np.unique(np.sort(np.asarray(dvals, np.float64).ravel()))
    i = int(np.clip(frac * len(vals), 0, len(vals) - 2))
    for j in range(i, len(vals) - 1):
        if vals[j + 1] - vals[j] > 1e-4 * max(1.0, vals[j]):
            return float(0.5 * (vals[j] + vals[j + 1]))
    return float(vals[-1] + 1.0)


def _servers(metric: str, n: int = 1600):
    data = _space(metric, n + 40, seed=3)
    db, q = data[:n], data[n:]
    port = RetrievalServer(db, metric=metric, device="cpu", **BUILD)
    ref = JaxServer(db, metric=metric, **BUILD)
    # thresholds in the engine's space (cosine: l2 on the unit sphere)
    d = pairwise_np("l2" if metric == "cosine" else metric,
                    port._prep(q), port.corpus)
    return port, ref, q, _snap(d, 0.03)


def _same_search(port, ref, q, t, k=4):
    a, b = port.search(q, "range", t=t), ref.search(q, "range", t=t)
    assert a.hits == b.hits
    np.testing.assert_array_equal(a.stats["per_query_dists"], b.stats["per_query_dists"])
    assert a.generation == b.generation
    ka, kb = port.search(q, "knn", k=k), ref.search(q, "knn", k=k)
    np.testing.assert_array_equal(ka.indices, kb.indices)
    np.testing.assert_allclose(ka.distances, kb.distances, **KNN_TOL)
    np.testing.assert_array_equal(ka.stats["per_query_dists"], kb.stats["per_query_dists"])
    assert ka.generation == kb.generation == a.generation
    return a, ka


@pytest.mark.parametrize("metric", METRICS)
def test_search_matches_jax_server(metric):
    port, ref, q, t = _servers(metric)
    a, ka = _same_search(port, ref, q, t)
    assert port.stats.n_queries == ref.stats.n_queries == 2 * len(q)
    assert port.stats.total_dists == ref.stats.total_dists
    assert sum(map(len, a.hits)) > 0
    assert a.stats["backend"] == "torch" and a.generation == 0
    # the delegates return the same rows
    assert port.range_by_distance(q, t) == a.hits
    top = port.top_k(q, 4)
    for i, row in enumerate(top):
        np.testing.assert_array_equal(row, ka.indices[i])


@pytest.mark.parametrize("metric", ["l2", "jsd"])
def test_mutations_match_jax_server(metric):
    port, ref, q, t = _servers(metric)
    new = _space(metric, 200, seed=11)
    dead = np.random.default_rng(2).choice(1800, size=60, replace=False).tolist()
    for op in (lambda s: s.append(new), lambda s: s.delete(dead),
               lambda s: s.compact()):
        ms_port, ms_ref = op(port), op(ref)
        assert ms_port.generation == ms_ref.generation
        assert ms_port.op == ms_ref.op and ms_port.rows == ms_ref.rows
        assert ms_port.table_dists == ms_ref.table_dists
        a, _ = _same_search(port, ref, q, t)
        assert a.generation == ms_port.generation
        assert not set(dead) & {h for row in a.hits for h in row} or ms_port.op == "append"
    assert port.index.generation == 3
    np.testing.assert_array_equal(port.corpus, ref.corpus)
    for got, want in zip(port.top_k_oracle(q, 5), ref.top_k_oracle(q, 5)):
        np.testing.assert_array_equal(got, want)
    snap_port, snap_ref = port.metrics.snapshot(), ref.metrics.snapshot()
    assert snap_port["gauges"]["index/generation"] == snap_ref["gauges"]["index/generation"] == 3
    assert snap_port["counters"] == snap_ref["counters"]


def test_top_k_oracle_matches_jax_and_engine():
    port, ref, q, _ = _servers("triangular")
    oracle = port.top_k_oracle(q, 5)
    for got, want in zip(oracle, ref.top_k_oracle(q, 5)):
        np.testing.assert_array_equal(got, want)
    top = port.top_k(q, 5)
    for i in range(len(q)):
        assert set(np.asarray(top[i]).tolist()) == set(oracle[i].tolist()), i


def test_range_query_is_the_cosine_specialisation():
    port, ref, q, _ = _servers("cosine")
    port.stats = ServeStats()
    hits = port.range_query(q, 0.97)
    assert hits == ref.range_query(q, 0.97)
    t = float(score_to_distance(np.asarray(0.97)))
    d = pairwise_np("l2", port._prep(q), port.corpus)
    for i in range(len(q)):
        assert set(hits[i]) == set(np.nonzero(d[i] <= t)[0].tolist())
    assert port.stats.saving > 0.0
    np.testing.assert_allclose(
        np.linalg.norm(port.index.data[port.index.valid], axis=1), 1.0, rtol=1e-5)
    _, _, qp, _ = _servers("jsd", n=400)
    jsd = RetrievalServer(_space("jsd", 400, seed=1), metric="jsd", device="cpu", **BUILD)
    with pytest.raises(ValueError, match="cosine"):
        jsd.range_query(qp, 0.9)


def test_score_distance_duality():
    s = np.linspace(-1, 1, 101)
    d = score_to_distance(s)
    assert np.all(np.diff(d) <= 1e-9)
    np.testing.assert_allclose(distance_to_score(d), s, atol=1e-12)


def test_unported_options_raise_naming_their_roadmap_items():
    x = _space("l2", 300, seed=1)
    # the mesh shards BSS only (tests/test_torch_sharded.py); a one-shard
    # mesh answers as the meshless server
    with pytest.raises(ValueError, match="forest serving is single-device"):
        RetrievalServer(x, metric="l2", index="forest", mesh=ShardMesh(("cpu",)))
    one = RetrievalServer(x, metric="l2", mesh=ShardMesh(("cpu",)))
    plain = RetrievalServer(x, metric="l2", device="cpu")
    got, want = one.search(x[:7], "knn", k=3), plain.search(x[:7], "knn", k=3)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.distances, want.distances)
    assert got.stats["engine"] == "sharded" and got.stats["n_shards"] == 1
    with pytest.raises(ValueError, match="bss"):
        RetrievalServer(x, metric="l2", index="tree", device="cpu")


def test_device_none_needs_a_card(monkeypatch):
    """``device=None`` builds for the CUDA device and raises without one:
    no silent CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetrievalServer(_space("l2", 300, seed=1), metric="l2")


def test_search_validation():
    port, _, q, t = _servers("l2", n=400)
    with pytest.raises(ValueError, match="needs t="):
        port.search(q, "range")
    with pytest.raises(ValueError, match="positive k"):
        port.search(q, "knn", k=0)
    with pytest.raises(ValueError, match="kind"):
        port.search(q, "nearest", t=t)


def test_async_front_matches_sync_paths():
    """``RetrievalServer.async_front``: per-request futures over the same
    index; results equal the server's own batched calls and the JAX
    server's front on the same stream."""
    port, ref, q, t = _servers("cosine", n=1200)
    # the front pins realisation="dense"; so does the direct call
    sync = port.search(q, "range", t=t, opts=DENSE)
    sync_k = port.search(q, "knn", k=4, opts=DENSE)
    with port.async_front(max_delay_s=0.02) as front:
        assert front.opts.realisation == "dense" and front.opts.backend == "auto"
        rres = [f.result(timeout=120) for f in front.submit_many(q, "range", t=t)]
        kres = [f.result(timeout=120) for f in front.submit_many(q, "knn", k=4)]
    with ref.async_front(max_delay_s=0.02) as jfront:
        jr = [f.result(timeout=120) for f in jfront.submit_many(q, "range", t=t)]
        jk = [f.result(timeout=120) for f in jfront.submit_many(q, "knn", k=4)]
    for i in range(len(q)):
        assert rres[i].hits == sync.hits[i] == jr[i].hits, i
        assert rres[i].n_dists == jr[i].n_dists == sync.stats["per_query_dists"][i], i
        np.testing.assert_array_equal(kres[i].indices, sync_k.indices[i])
        np.testing.assert_array_equal(kres[i].indices, jk[i].indices)
        # the front ran these rows in a 128-row bucket: the plain l2 gives
        # a row the same bits in a batch of any size
        np.testing.assert_array_equal(kres[i].distances, sync_k.distances[i])
        np.testing.assert_allclose(kres[i].distances, jk[i].distances, **KNN_TOL)


# ---------------------------------------------------------------- forest


def _forest_servers(metric: str, n: int = 1600):
    data = _space(metric, n + 40, seed=3)
    db, q = data[:n], data[n:]
    kw = dict(seed=5, index="forest")
    port = RetrievalServer(db, metric=metric, device="cpu", **kw)
    ref = JaxServer(db, metric=metric, **kw)
    bss = RetrievalServer(db, metric=metric, device="cpu", **BUILD)
    d = pairwise_np("l2" if metric == "cosine" else metric, port._prep(q), port.corpus)
    return port, ref, bss, q, _snap(d, 0.03)


@pytest.mark.parametrize("metric", ["cosine", "l2", "jsd"])
def test_forest_server_matches_jax_and_bss(metric):
    """``index="forest"``: the JAX forest server's hits and per-query
    counts, the BSS server's hit sets, and the server accounting."""
    port, ref, bss, q, t = _forest_servers(metric)
    a, b = port.search(q, "range", t=t), ref.search(q, "range", t=t)
    assert a.hits == b.hits
    np.testing.assert_array_equal(a.stats["per_query_dists"], b.stats["per_query_dists"])
    assert a.stats["engine"] == "forest" and a.stats["backend"] == "torch"
    assert [sorted(h) for h in a.hits] == [sorted(h) for h in bss.range_by_distance(q, t)]
    assert sum(map(len, a.hits)) > 0
    assert port.stats.n_queries == ref.stats.n_queries == len(q)
    assert port.stats.total_dists == ref.stats.total_dists
    assert port.range_by_distance(q, t) == a.hits
    # the tree is built under the engine metric (cosine rides l2)
    assert port.index.metric == ("l2" if metric == "cosine" else metric)
    with port.async_front(max_delay_s=0.02) as front:
        assert front.mechanism == port.forest_mechanism
        res = [f.result(timeout=120) for f in front.submit_many(q, "range", t=t)]
    assert [sorted(r.hits) for r in res] == [sorted(h) for h in a.hits]


def test_forest_server_refuses_knn_and_mutations():
    port, *_, q, t = _forest_servers("l2", n=400)
    for call in (lambda: port.top_k(q, 3), lambda: port.search(q, "knn", k=3)):
        with pytest.raises(NotImplementedError) as e:
            call()
        assert str(e.value) == FOREST_KNN_ERROR
    for op in (lambda: port.append(q), lambda: port.delete([0]),
               lambda: port.compact(), lambda: port.maybe_compact()):
        with pytest.raises(NotImplementedError) as e:
            op()
        assert str(e.value) == FOREST_IMMUTABLE
    assert len(port.corpus) == 400 and port.search(q, "range", t=t).hits is not None
    with pytest.raises(ValueError, match="unknown variant"):
        RetrievalServer(port.corpus, metric="l2", index="forest", device="cpu",
                        forest_variant="nope")
