"""The port's async ``ServingFront`` on the CPU: against direct engine calls
of the port, and against the JAX package's front on the same stream.

The mirror of ``tests/test_async_front.py`` (1,600 x 16 rows, 8 pivots,
10 planes, 64-row blocks; thresholds snapped to a gap between distances
so float32 and float64 agree on every ``d <= t``).

Bit-identity with direct calls: on the CPU the ``"torch"`` backend's l2
runs a BLAS matmul whose bits may depend on how many rows the batch holds,
so the direct call is made on the very batch the front dispatched (the
requests are queued before the driver starts, which makes the grouping
deterministic; ``_dispatched``).  On the card the kernels give each row
the same bits in any batch, and ``tests/test_torch_cuda_serving.py``
holds the front to direct calls on other batches.  Against the JAX
package's front, hits, kNN ids and per-query distance counts are equal
and kNN distances agree within 1e-5 (``tests/test_torch_knn.py``: torch
and XLA sum in another order).
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import pytest

from repro.core import flat_index as jax_flat_index
from repro.serve.front import ServingFront as JaxFront
from repro.serve.front import _cache_key as jax_cache_key
from repro_torch.core import flat_index
from repro_torch.core.backends import EngineOpts, bucket_for
from repro_torch.core.npdist import pairwise_np
from repro_torch.kernels import _build
from repro_torch.serve import front as front_mod
from repro_torch.serve.front import ServingFront, ShedError, _cache_key

DIM = 16
DENSE = EngineOpts(realisation="dense")
KNN_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_knn.py


def _space(metric: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.random((n, DIM)).astype(np.float32) + 1e-3
    if metric == "jsd":
        x /= x.sum(axis=1, keepdims=True)
    return x


def _snap(dvals: np.ndarray, frac: float) -> float:
    vals = np.unique(np.sort(np.asarray(dvals, np.float64).ravel()))
    i = int(np.clip(frac * len(vals), 0, len(vals) - 2))
    for j in range(i, len(vals) - 1):
        if vals[j + 1] - vals[j] > 1e-4 * max(1.0, vals[j]):
            return float(0.5 * (vals[j] + vals[j + 1]))
    return float(vals[-1] + 1.0)


@functools.lru_cache(maxsize=None)
def _built(metric: str):
    """(port index, queries, [t_small, t_mid, t_large], db) per metric."""
    data = _space(metric, 1640, seed=3)
    db, q = data[:1600], data[1600:]
    idx = flat_index.build_bss(metric, db, n_pivots=8, n_pairs=10, block=64,
                               seed=5, device="cpu")
    d = pairwise_np("l2" if metric == "cosine" else metric,
                    flat_index._engine_queries(metric, q), idx.data[idx.valid])
    return idx, q, [_snap(d, 0.01), _snap(d, 0.03), _snap(d, 0.06)], db


def _drain(futs, timeout=120):
    return [f.result(timeout=timeout) for f in futs]


def _submit(front, q, reqs, **kw):
    return [front.submit(q[i], "range", t=arg, **kw) if kind == "range"
            else front.submit(q[i], "knn", k=arg, **kw)
            for i, (kind, arg) in enumerate(reqs)]


def _dispatched(reqs, buckets):
    """The micro-batches a front forms from ``reqs`` queued before its
    driver starts: the head's group, up to the largest bucket, FIFO."""
    group = [kind if kind == "range" else (kind, arg) for kind, arg in reqs]
    pending = list(range(len(reqs)))
    out = []
    while pending:
        take = [i for i in pending if group[i] == group[pending[0]]][:buckets[-1]]
        out.append(take)
        pending = [i for i in pending if i not in take]
    return out


def _assert_direct(idx, q, reqs, res, buckets, opts=DENSE):
    """Every row of ``res`` equals a direct engine call on the padded batch
    the front dispatched it in, bit for bit."""
    for batch in _dispatched(reqs, buckets):
        bucket = bucket_for(len(batch), buckets)
        pad = bucket - len(batch)
        qs = np.concatenate([q[batch], np.repeat(q[batch[:1]], pad, axis=0)])
        kind, arg = reqs[batch[0]]
        if kind == "range":
            t_vec = np.array([reqs[i][1] for i in batch] + [-1.0] * pad, np.float32)
            hits, s = flat_index.bss_query_batched(idx, qs, t_vec, opts=opts)
        else:
            ids, dists, s = flat_index.bss_knn_batched(idx, qs, arg, opts=opts)
        for j, i in enumerate(batch):
            assert (res[i].batch_size, res[i].padded_to) == (len(batch), bucket), i
            assert res[i].n_dists == s["per_query_dists"][j], i
            if kind == "range":
                assert res[i].hits == hits[j], i
            else:
                np.testing.assert_array_equal(res[i].indices, ids[j])
                np.testing.assert_array_equal(res[i].distances, dists[j])
            if opts.precision == "bf16":
                assert res[i].n_recheck == s["per_query_recheck"][j], i


def _serve(idx, q, reqs, buckets=(8, 32), **kw):
    """Queue every request, then start the driver: deterministic batches."""
    front = ServingFront(idx, buckets=buckets, max_delay_s=0.05, start=False, **kw)
    futs = _submit(front, q, reqs)
    front.start()
    res = _drain(futs)
    stats = front.stats()
    front.close()
    return res, stats, front


# --------------------------------------------------------- bit-identity


@pytest.mark.parametrize("metric", ["l2", "cosine", "jsd"])
def test_interleaved_stream_bit_identical(metric):
    """Mixed range (three per-request thresholds) + kNN stream through the
    front == direct port calls row for row (hits, kNN ids and distances,
    per-query counts), and == the JAX package's front on the same stream."""
    idx, q, ts, db = _built(metric)
    reqs = [("range", ts[i % 3]) if i % 3 != 1 else ("knn", 4) for i in range(len(q))]
    res, stats, _ = _serve(idx, q, reqs)
    _assert_direct(idx, q, reqs, res, (8, 32))
    assert stats["errors"] == 0 and stats["completed"] == len(q)

    # the JAX front forms the same batches: a kNN row's count follows its
    # query tile (the rows that share it can tighten its radius)
    jidx = jax_flat_index.build_bss(metric, db, n_pivots=8, n_pairs=10, block=64, seed=5)
    jfront = JaxFront(jidx, buckets=(8, 32), max_delay_s=0.05, start=False)
    jfuts = _submit(jfront, q, reqs)
    jfront.start()
    jres = _drain(jfuts)
    jfront.close()
    for i, (kind, _) in enumerate(reqs):
        assert res[i].n_dists == jres[i].n_dists, (metric, i)
        if kind == "range":
            assert res[i].hits == jres[i].hits, (metric, i)
        else:
            np.testing.assert_array_equal(res[i].indices, jres[i].indices)
            np.testing.assert_allclose(res[i].distances, jres[i].distances, **KNN_TOL)


def test_batch_sizes_one_and_beyond_largest_bucket():
    """A lone request rides the smallest bucket; a burst larger than the
    top bucket splits into ladder-sized dispatches."""
    idx, q, ts, _ = _built("l2")
    reqs = [("range", ts[1])] * 21
    with ServingFront(idx, buckets=(4, 8), max_delay_s=0.02) as front:
        lone = front.submit(q[0], "range", t=ts[1]).result(timeout=120)
    assert lone.batch_size == 1 and lone.padded_to == 4
    res, stats, _ = _serve(idx, q, reqs, buckets=(4, 8))
    _assert_direct(idx, q, reqs, res, (4, 8))
    assert stats["batches"] == 3 and stats["per_bucket_batches"] == {8: 3}
    ref, ref_s = flat_index.bss_query_batched(idx, q[:21], ts[1], opts=DENSE)
    assert [r.hits for r in res] == ref


def test_batch_sizes_one_to_ten_through_a_small_ladder():
    """Every batch size 1..10 of range and kNN through a (4, 8) ladder."""
    idx, q, ts, _ = _built("l2")
    for n in range(1, 11):
        reqs = [("range", ts[1])] * n + [("knn", 3)] * n
        res, stats, _ = _serve(idx, q, reqs, buckets=(4, 8))
        _assert_direct(idx, q, reqs, res, (4, 8))
        assert set(stats["per_bucket_batches"]) <= {4, 8}, n


# ------------------------------------------- compile guard + padding proof


def test_padded_rows_provably_excluded_from_counts():
    """Rows with a negative radius survive no block, are charged only the
    pivot distances, and hit nothing; the real rows are the unpadded
    call's rows; the front folds real rows only."""
    idx, q, ts, _ = _built("l2")
    n_pivots = idx.pivots.shape[0]
    t_vec = np.full(8, ts[1], np.float32)
    t_vec[5:] = -1.0
    qpad = np.concatenate([q[:5], np.repeat(q[:1], 3, axis=0)])
    hits, stats = flat_index.bss_query_batched(idx, qpad, t_vec, opts=DENSE)
    assert (stats["per_query_dists"][5:] == n_pivots).all()
    assert (stats["excluded"]["hilbert"][5:] == idx.n_blocks).all()
    assert all(hits[i] == [] for i in range(5, 8))
    ref, ref_s = flat_index.bss_query_batched(idx, q[:5], ts[1], opts=DENSE)
    assert hits[:5] == ref
    assert (stats["per_query_dists"][:5] == ref_s["per_query_dists"]).all()
    oracle, oracle_s = flat_index.bss_query(idx, qpad, t_vec)
    assert hits == oracle
    assert (oracle_s["per_query_dists"] == stats["per_query_dists"]).all()

    res, fstats, front = _serve(idx, q, [("range", ts[1])] * 5, buckets=(8,))
    assert [r.hits for r in res] == hits[:5]
    c = front.metrics().snapshot()["counters"]
    assert c["engine/queries{engine=bss,kind=range}"] == 5.0
    assert c["engine/dists{engine=bss,kind=range}"] == float(sum(r.n_dists for r in res))
    assert c["serve/padded_rows"] == 3.0 and fstats["padded_rows"] == 3


def test_compile_guard_kernel_library_counts(monkeypatch):
    """Sweeping batch sizes through a (4, 8) ladder loads no kernel library
    mid-stream (``compile/recompiles`` stays absent), and a library loaded
    between two batches shows up as one recompile of its source."""
    idx, q, ts, _ = _built("l2")
    before = {name: _build.load_count(name) for name in _build.SOURCES}
    with ServingFront(idx, buckets=(4, 8), max_delay_s=0.02) as front:
        for n in range(1, 11):
            _drain([front.submit(v, "range", t=ts[1]) for v in q[:n]])
            _drain([front.submit(v, "knn", k=3) for v in q[:n]])
        snap = front.metrics().snapshot()
        assert set(front.stats()["per_bucket_batches"]) <= {4, 8}
    assert {name: _build.load_count(name) for name in _build.SOURCES} == before
    assert not [k for k in snap["counters"] if k.startswith("compile/recompiles")]
    assert {f"compile/cache_size{{fn={name}}}" for name in _build.SOURCES} <= set(snap["gauges"])
    assert snap["gauges"]["compile/ladder_buckets"] == 2.0

    monkeypatch.setitem(_build._LOADS, "prob_dist", _build.load_count("prob_dist"))
    with ServingFront(idx, buckets=(4, 8), max_delay_s=0.01) as front:
        front.submit(q[0], "range", t=ts[1]).result(timeout=120)
        _build._LOADS["prob_dist"] += 1  # a library loaded mid-stream
        front.submit(q[1], "range", t=ts[1]).result(timeout=120)
        c = front.metrics().snapshot()["counters"]
    assert c["compile/recompiles{fn=prob_dist}"] == 1.0
    assert len([k for k in c if k.startswith("compile/recompiles")]) == 1


def test_driver_exception_fails_every_future_of_its_batch(monkeypatch):
    """No fallback: an engine failure is set on every future of its batch,
    and the driver goes on serving the next batch."""
    idx, q, ts, _ = _built("l2")

    def broken(*a, **kw):
        raise RuntimeError("kernel launch refused")

    monkeypatch.setattr(front_mod.flat_index, "bss_query_batched", broken)
    front = ServingFront(idx, buckets=(8,), max_delay_s=0.02, start=False)
    bad = [front.submit(v, "range", t=ts[1]) for v in q[:5]]
    good = [front.submit(v, "knn", k=3) for v in q[:3]]
    front.start()
    for f in bad:
        with pytest.raises(RuntimeError, match="launch refused"):
            f.result(timeout=120)
    assert all(r.indices.shape == (3,) for r in _drain(good))
    front.close()
    assert front.stats()["errors"] == 1 and front.stats()["completed"] == 3


# ------------------------------------------- admission, cache, lifecycle


def test_admission_shed_and_block_timeout():
    idx, q, ts, _ = _built("l2")
    front = ServingFront(idx, max_queue=2, admission="shed", start=False)
    front.submit(q[0], "range", t=ts[0])
    front.submit(q[1], "range", t=ts[0])
    with pytest.raises(ShedError, match="shed"):
        front.submit(q[2], "range", t=ts[0])
    assert front.stats()["shed"] == 1
    assert front.stats()["submitted"] == 3
    front.close()

    blk = ServingFront(idx, max_queue=1, admission="block", start=False)
    blk.submit(q[0], "range", t=ts[0])
    with pytest.raises(ShedError, match="timed out"):
        blk.submit(q[1], "range", t=ts[0], timeout=0.05)
    blk.close()


def test_exact_hit_lru_cache():
    idx, q, ts, _ = _built("l2")
    with ServingFront(idx, cache_size=4, max_delay_s=0.005) as front:
        first = front.submit(q[0], "range", t=ts[1]).result(timeout=120)
        again = front.submit(q[0], "range", t=ts[1]).result(timeout=120)
        other_t = front.submit(q[0], "range", t=ts[2]).result(timeout=120)
        again.hits.append(-7)  # a client's edit must not reach the cache
        third = front.submit(q[0], "range", t=ts[1]).result(timeout=120)
        stats = front.stats()
    assert not first.cache_hit and again.cache_hit and third.cache_hit
    assert third.hits == first.hits and third.n_dists == first.n_dists
    assert not other_t.cache_hit
    assert stats["cache_hits"] == 2
    assert stats["batches"] == 2


def test_validation_and_lifecycle():
    idx, q, ts, _ = _built("l2")
    front = ServingFront(idx, start=False)
    with pytest.raises(ValueError, match="ONE query"):
        front.submit(q[:2], "range", t=ts[0])
    with pytest.raises(ValueError, match="need t="):
        front.submit(q[0], "range")
    with pytest.raises(ValueError, match="padding sentinel"):
        front.submit(q[0], "range", t=-0.5)
    with pytest.raises(ValueError, match="positive k"):
        front.submit(q[0], "knn")
    with pytest.raises(ValueError, match="kind"):
        front.submit(q[0], "nearest", t=ts[0])
    front.close()
    front.close()  # idempotent
    with pytest.raises(ShedError, match="closed"):
        front.submit(q[0], "range", t=ts[0])
    with pytest.raises(TypeError, match="BSSIndex.*Queue 1 item 4"):
        ServingFront(object())
    with pytest.raises(ValueError, match="ladder"):
        ServingFront(idx, buckets=(8, 4), start=False)
    with pytest.raises(ValueError, match="admission"):
        ServingFront(idx, admission="drop", start=False)
    with pytest.raises(TypeError, match="interpret"):
        ServingFront(idx, interpret=True, start=False)
    # engine knobs ride opts= only
    for knob, value in (("backend", "torch"), ("realisation", "dense")):
        with pytest.raises(TypeError, match=knob):
            ServingFront(idx, start=False, **{knob: value})


def test_cancelled_future_does_not_poison_batch():
    idx, q, ts, _ = _built("l2")
    front = ServingFront(idx, buckets=(8,), max_delay_s=0.5, start=False)
    futs = [front.submit(v, "range", t=ts[1]) for v in q[:6]]
    assert futs[2].cancel() and futs[4].cancel()
    front.start()
    res = [futs[i].result(timeout=120) for i in range(6) if i not in (2, 4)]
    front.close()
    ref, _ = flat_index.bss_query_batched(idx, q[:6], ts[1], opts=DENSE)
    for r, i in zip(res, (0, 1, 3, 5)):
        assert r.hits == ref[i], i
        assert r.batch_size == 4
    assert front.stats()["errors"] == 0


def test_queue_wait_and_padding_telemetry():
    idx, q, ts, _ = _built("l2")
    with ServingFront(idx, buckets=(8, 32), max_delay_s=0.01) as front:
        res = _drain([front.submit(v, "range", t=ts[1]) for v in q[:5]])
        stats = front.stats()
    assert all(r.queue_wait_s >= 0.0 for r in res)
    assert all(r.engine_s > 0.0 for r in res)
    assert stats["completed"] == 5
    assert stats["padded_rows"] >= 3
    assert 0.0 < stats["padding_waste"] < 1.0
    assert stats["queue_wait_s"]["p95"] >= stats["queue_wait_s"]["p50"] >= 0


def test_concurrent_clients_get_their_own_rows():
    """Eight client threads submit interleaved range and kNN requests at
    once; every future resolves to its own query's row."""
    idx, q, ts, _ = _built("l2")
    ref, ref_s = flat_index.bss_query_batched(idx, q, ts[1], opts=DENSE)
    ref_i, _, _ = flat_index.bss_knn_batched(idx, q, 3, opts=DENSE)
    out: dict = {}
    with ServingFront(idx, max_delay_s=0.005) as front:
        def client(c):
            for i in range(c, len(q), 8):
                out[i] = (front.submit(q[i], "range", t=ts[1]),
                          front.submit(q[i], "knn", k=3))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        for i, (fr, fk) in out.items():
            r, k = fr.result(timeout=120), fk.result(timeout=120)
            assert r.hits == ref[i] and r.n_dists == ref_s["per_query_dists"][i], i
            np.testing.assert_array_equal(k.indices, ref_i[i])
        assert front.stats()["completed"] == 2 * len(q)


# --------------------------------------- input hygiene + canonical cache key


def test_non_finite_queries_rejected_at_admission():
    idx, q, ts, _ = _built("l2")
    front = ServingFront(idx, cache_size=4, start=False)
    bad = q[0].copy()
    for poison in (np.nan, np.inf, -np.inf):
        bad[3] = poison
        with pytest.raises(ValueError, match="finite"):
            front.submit(bad, "range", t=ts[0])
    with pytest.raises(ValueError, match="finite"):
        front.submit(np.full(DIM, 1e40), "range", t=ts[0])
    with pytest.raises(ValueError, match="precision"):
        front.submit(q[0], "range", t=ts[0], precision="fp64")
    front.close()
    assert front.stats()["submitted"] == 0


def test_cache_key_is_canonical():
    idx, q, ts, _ = _built("l2")
    with ServingFront(idx, cache_size=16, max_delay_s=0.002) as front:
        a = front.submit(q[0], "range", t=1.0).result(timeout=120)
        b = front.submit(q[0], "range", t=1).result(timeout=120)
        assert b.cache_hit and b.hits == a.hits  # typed: int t == float t
        zp = np.full(DIM, 0.5, np.float32)
        zp[0] = 0.0
        zn = zp.copy()
        zn[0] = -0.0
        first = front.submit(zp, "range", t=ts[1]).result(timeout=120)
        second = front.submit(zn, "range", t=ts[1]).result(timeout=120)
        assert second.cache_hit and second.hits == first.hits
        c = front.submit(q[0], "knn", k=1).result(timeout=120)
        assert not c.cache_hit
        d = front.submit(q[0], "range", t=1.0, precision="bf16").result(timeout=120)
        assert not d.cache_hit and d.hits == a.hits


def test_cache_key_injective_header():
    """The key splits at the first NUL, every slot is typed, and the bytes
    are the JAX package's for the same request."""
    qa = np.array([1.5, 2.5], np.float32)
    qb = np.array([2.5, 1.5], np.float32)
    seen = set()
    for kind, t, k in [("range", 1.0, None), ("range", 1, None),
                       ("knn", None, 3), ("knn", None, 5)]:
        for qq in (qa, qb):
            args = (kind, "bss", "fp32", 0, t, k, None, 8 if kind == "knn" else None, qq)
            key = _cache_key(*args)
            assert key == jax_cache_key(*args)
            seen.add(key)
    assert len(seen) == 6
    assert _cache_key("range", "bss", "fp32", 0, 1.0, None, None, None, qa) \
        != _cache_key("range", "bss", "bf16", 0, 1.0, None, None, None, qa)
    assert _cache_key("range", "bss", "fp32", 0, 1.0, None, None, None, qa) \
        != _cache_key("range", "bss", "fp32", 1, 1.0, None, None, None, qa)


def test_stats_total_on_empty_window():
    idx, _, _, _ = _built("l2")
    front = ServingFront(idx, start=False)
    s = front.stats()
    front.close()
    assert s["submitted"] == 0 and s["completed"] == 0
    assert s["queue_wait_s"] == {"mean": 0.0, "p50": 0.0, "p95": 0.0, "max": 0.0}
    assert s["batch_size_mean"] == 0.0 and s["padding_waste"] == 0.0
    assert s["engine_s_per_batch"] == 0.0
    assert s["bf16_rows"] == 0 and s["recheck_points"] == 0


# ----------------------------------------------------------- bf16 serving


def test_front_bf16_bit_identical_and_grouped():
    """bf16 requests never share a micro-batch with fp32 ones, equal fp32
    bit for bit, equal a direct bf16 call on their batch (re-check counts
    included), and their re-check volume rides the telemetry."""
    idx, q, ts, _ = _built("l2")
    reqs = [("range", ts[1])] * 8 + [("knn", 4)] * 8
    front = ServingFront(idx, max_delay_s=0.05, start=False)
    f32 = _submit(front, q, reqs)
    f16 = _submit(front, q, reqs, precision="bf16")
    front.start()
    r32, r16 = _drain(f32), _drain(f16)
    stats = front.stats()
    front.close()
    assert stats["batches"] == 4
    _assert_direct(idx, q, reqs, r16, front.buckets,
                   opts=EngineOpts(realisation="dense", precision="bf16"))
    for a, b in zip(r32, r16):
        assert b.hits == a.hits and b.n_dists == a.n_dists
        if a.indices is not None:
            np.testing.assert_array_equal(b.indices, a.indices)
            np.testing.assert_array_equal(b.distances, a.distances)
        assert a.n_recheck == 0
    assert stats["bf16_rows"] == 16
    assert stats["recheck_points"] == sum(r.n_recheck for r in r16)
    assert stats["errors"] == 0


# --------------------------------------------------------- living corpus


def test_mutation_between_batches_names_its_generation():
    """Mutations swap the index between micro-batches; every result names
    the generation it ran on and equals a direct call on that snapshot;
    cache entries of an older generation stop matching."""
    idx, q, ts, _ = _built("l2")
    reqs = [("range", ts[1])] * 6 + [("knn", 3)] * 6
    snapshots, results = {}, {}
    with ServingFront(idx, buckets=(8, 32), max_delay_s=0.005, cache_size=64) as front:
        for step in range(3):
            snapshots[front.index.generation] = front.index
            results[front.index.generation] = _drain(_submit(front, q, reqs))
            if step == 0:
                front.append(_space("l2", 150, seed=8))
            elif step == 1:
                front.delete(list(range(0, 1700, 17)))
        again = front.submit(q[0], "range", t=ts[1]).result(timeout=120)
        snap = front.metrics().snapshot()
    assert sorted(results) == [0, 1, 2]
    for gen, res in results.items():
        assert all(r.generation == gen for r in res)
        ref, ref_s = flat_index.bss_query_batched(snapshots[gen], q[:6], ts[1], opts=DENSE)
        ref_i, _, _ = flat_index.bss_knn_batched(snapshots[gen], q[6:12], 3, opts=DENSE)
        for i in range(6):
            assert res[i].hits == ref[i] and res[i].n_dists == ref_s["per_query_dists"][i]
            np.testing.assert_array_equal(res[6 + i].indices, ref_i[i])
    assert not any(r.cache_hit for res in results.values() for r in res)
    assert again.cache_hit and again.generation == 2
    assert not set(range(0, 1700, 17)) & {h for r in results[2][:6] for h in r.hits}
    assert snap["gauges"]["index/generation"] == 2.0
    assert snap["counters"]["index/mutations{op=append}"] == 1.0
