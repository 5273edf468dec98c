"""Observability of the port (``repro_torch.obs`` and the serving wiring),
on the CPU, against the JAX package where both compute the same thing.

``fold_engine_stats`` of a port engine call must give the counters,
gauges and count histograms the JAX fold gives for the JAX call on the
same inputs (timing histograms, ``*_s``, are left out: they read clocks).
Around that: the kernel-library build counter behind ``poll_compile``,
metrics on/off bit-identity, spans and explain records through the
front, and the Prometheus exposition and Chrome trace a serving run
exports.  The mirror of ``tests/test_obs.py``'s serving half.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from repro.core import flat_index as jax_flat_index
from repro.core.backends import EngineOpts as JaxOpts
from repro.obs import MetricsRegistry as JaxRegistry
from repro.obs import fold_engine_stats as jax_fold
from repro.serve.front import ServingFront as JaxFront
from repro_torch.core import flat_index
from repro_torch.core.backends import EngineOpts
from repro_torch.core.npdist import pairwise_np
from repro_torch.obs import (
    MetricsRegistry,
    check_stats,
    fold_engine_stats,
    load_trace,
    poll_compile,
    validate_exposition,
    validate_trace,
)
from repro_torch.serve.front import ServingFront
from repro_torch.serve.retrieval import RetrievalServer

DIM = 12
_DENSE = EngineOpts(realisation="dense")


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


def _built(metric: str = "l2", n: int = 1600):
    data = _space(metric, n + 24, seed=7)
    db, q = data[:n], data[n:]
    build = dict(n_pivots=8, n_pairs=10, block=64, seed=9)
    idx = flat_index.build_bss(metric, db, device="cpu", **build)
    jidx = jax_flat_index.build_bss(metric, db, **build)
    t = _snap(pairwise_np(metric, q, db), 0.04)
    return idx, jidx, q, t


def _untimed(snap: dict) -> dict:
    """A registry snapshot without its timing histograms."""
    hist = {k: v for k, v in snap["histograms"].items()
            if not k.split("{")[0].endswith("_s")}
    return dict(counters=snap["counters"], gauges=snap["gauges"], histograms=hist)


# ----------------------------------------------------------------- folding


@pytest.mark.parametrize("metric,precision", [
    ("l2", "fp32"), ("l2", "bf16"), ("jsd", "fp32"), ("triangular", "bf16"),
])
def test_fold_of_port_engine_stats_equals_jax_fold(metric, precision):
    idx, jidx, q, t = _built(metric)
    opts = EngineOpts(realisation="dense", precision=precision)
    jopts = JaxOpts(realisation="dense", precision=precision)
    reg, jreg = MetricsRegistry(), JaxRegistry()
    _, s = flat_index.bss_query_batched(idx, q, t, opts=opts)
    _, js = jax_flat_index.bss_query_batched(jidx, q, t, opts=jopts)
    check_stats(s)
    if precision == "bf16":
        assert "per_query_recheck" in s and s["per_query_recheck"].shape == (len(q),)
    _, _, ks = flat_index.bss_knn_batched(idx, q, 4, opts=opts)
    _, _, jks = jax_flat_index.bss_knn_batched(jidx, q, 4, opts=jopts)
    check_stats(ks)
    for stats, jstats in ((s, js), (ks, jks)):
        fold_engine_stats(reg, stats)
        jax_fold(jreg, jstats)
    got, want = _untimed(reg.snapshot()), _untimed(jreg.snapshot())
    assert got == want
    assert got["counters"]["engine/queries{engine=bss,kind=knn}"] == len(q)
    assert any(k.startswith("engine/knn_rounds") for k in got["histograms"])
    if precision == "bf16":
        assert any(k.startswith("engine/recheck_points") for k in got["counters"])


def test_poll_compile_counts_growth():
    """``poll_compile`` reads zero-argument counters: a growth between two
    samples is a recompile of that name; a steady counter is none."""
    counts = {"f": 1, "g": 3}
    watched = {name: (lambda name=name: counts[name]) for name in counts}
    reg = MetricsRegistry()
    last = poll_compile(reg, watched)
    counts["f"] = 2
    last = poll_compile(reg, watched, last)
    poll_compile(reg, watched, last)
    snap = reg.snapshot()
    assert snap["counters"] == {"compile/recompiles{fn=f}": 1.0}
    assert snap["gauges"]["compile/cache_size{fn=f}"] == 2.0
    assert snap["gauges"]["compile/cache_size{fn=g}"] == 3.0


def test_front_metrics_equal_jax_front_metrics():
    """The same queued stream through the port's front and the JAX
    package's gives the same engine and padding counters and the same
    count histograms."""
    idx, jidx, q, t = _built("l2")

    def run(cls, index):
        front = cls(index, buckets=(8, 32), max_delay_s=0.02, start=False)
        futs = [front.submit(v, "knn", k=3) if i % 3 == 1 else front.submit(v, "range", t=t)
                for i, v in enumerate(q)]
        front.start()
        [f.result(timeout=120) for f in futs]
        front.close()
        snap = _untimed(front.metrics().snapshot())
        # the build counters are the port's own; the JAX front polls jit caches
        for part in ("counters", "gauges"):
            snap[part] = {k: v for k, v in snap[part].items() if not k.startswith("compile/")}
        snap["histograms"] = {k: v for k, v in snap["histograms"].items()
                              if not k.startswith("serve/span_s")}
        return snap

    got, want = run(ServingFront, idx), run(JaxFront, jidx)
    assert got == want
    assert got["counters"]["serve/padded_rows"] > 0


# --------------------------------------------------- metrics-on/off identity


@pytest.mark.parametrize("metric", ["l2", "cosine", "jsd", "triangular"])
def test_metrics_on_off_bit_identity(metric):
    """A metrics-on and a metrics-off front return the same bits on every
    supermetric — collection is observation, never perturbation."""
    data = _space(metric, 660, seed=7)
    db, q = data[:640], data[640:]
    idx = flat_index.build_bss(metric, db, n_pivots=8, n_pairs=10, block=64,
                               seed=9, device="cpu")
    t = _snap(pairwise_np("l2" if metric == "cosine" else metric,
                          flat_index._engine_queries(metric, q), idx.data[idx.valid]), 0.04)

    def run(metrics_on):
        front = ServingFront(idx, buckets=(8, 32), max_delay_s=0.02,
                             metrics=metrics_on, start=False)
        futs = [front.submit(v, "knn", k=4) if i % 3 == 1 else front.submit(v, "range", t=t)
                for i, v in enumerate(q)]
        front.start()
        out = [f.result(timeout=120) for f in futs]
        front.close()
        return out

    on, off = run(True), run(False)
    for i, (a, b) in enumerate(zip(on, off)):
        assert a.n_dists == b.n_dists, (metric, i)
        if i % 3 == 1:
            np.testing.assert_array_equal(a.indices, b.indices)
            np.testing.assert_array_equal(a.distances, b.distances)
        else:
            assert a.hits == b.hits, (metric, i)


def test_metrics_off_front_stays_dark():
    idx, _, q, t = _built()
    with ServingFront(idx, max_delay_s=0.01, metrics=False) as front:
        r = front.submit(q[0], "range", t=t).result(timeout=120)
        snap = front.metrics().snapshot()
    assert r.trace_id
    assert snap == {"counters": {}, "gauges": {}, "histograms": {}}
    assert front.explain() is None


# ------------------------------------------------- spans + explain through


def test_front_spans_and_explain():
    idx, _, q, t = _built()
    with ServingFront(idx, buckets=(8,), max_delay_s=0.01, cache_size=16) as front:
        res = [front.submit(v, "range", t=t).result(timeout=120) for v in q[:5]]
        hit = front.submit(q[0], "range", t=t).result(timeout=120)
        reg = front.metrics()
        snap = reg.snapshot()
        rec = front.explain(res[2].trace_id)
        latest = front.explain()
    ids = [r.trace_id for r in res]
    assert len(set(ids)) == 5 and all(ids)
    for r in res:
        assert set(r.spans) == {"queue", "batch", "engine", "demux", "total"}
        assert all(v >= 0.0 for v in r.spans.values())
        assert r.spans["total"] >= r.spans["engine"]
    assert hit.cache_hit and hit.trace_id not in ids
    with pytest.raises(KeyError, match="last 256 dispatched"):
        front.explain(hit.trace_id)
    assert rec["trace_id"] == res[2].trace_id and rec["n_dists"] == res[2].n_dists
    assert rec["backend"] == "torch" and rec["engine"] == "bss"
    assert set(rec["excluded"]) == {"hilbert"} and rec["excluded"]["hilbert"] >= 0
    assert latest["trace_id"] == res[-1].trace_id
    c = snap["counters"]
    assert c["engine/queries{engine=bss,kind=range}"] == 5.0
    assert c["serve/cache_hits"] == 1.0
    assert snap["histograms"]["serve/batch_size{kind=range}"]["count"] >= 1
    assert any(k.startswith("serve/span_s") for k in snap["histograms"])
    assert validate_exposition(reg.to_prometheus()) == []


def test_front_exposition_and_trace_export(tmp_path):
    """A serving run with ``profile_dir=`` exports a valid Prometheus text
    and a Perfetto-loadable trace holding the request spans, the driver's
    dispatch phases and the mutation events on one clock, and the
    torch.profiler wrote one Chrome trace per dispatch with the dispatch's
    ``record_function`` name inside."""
    idx, _, q, t = _built()
    prof = tmp_path / "prof"
    with ServingFront(idx, buckets=(8,), max_delay_s=0.01, cache_size=4,
                      profile_dir=str(prof)) as front:
        r1 = front.submit(q[0], "range", t=t).result(timeout=120)
        ms = front.append(_space("l2", 64, seed=6))
        r2 = front.submit(q[1], "knn", k=3).result(timeout=120)
        front.compact()
        r3 = front.submit(q[2], "range", t=t).result(timeout=120)
        path = front.export_trace(tmp_path / "trace.json")
        text = front.metrics().to_prometheus()
    assert validate_exposition(text) == []
    assert "index_generation" in text.replace("/", "_")
    payload = load_trace(path)
    assert validate_trace(payload) == []
    evs = payload["traceEvents"]
    names = {e["name"] for e in evs}
    assert {"queue", "batch", "engine", "demux"} <= names
    assert {"dispatch/assemble", "dispatch/engine", "dispatch/demux"} <= names
    assert {"mutation/append", "mutation/compact"} <= names
    assert payload["otherData"]["engine"] == "bss"
    assert ms.generation == 1
    assert (r1.generation, r2.generation, r3.generation) == (0, 1, 2)
    for r in (r1, r2, r3):
        tid = int(r.trace_id[1:])
        mine = {e["name"] for e in evs if e.get("tid") == tid and e["ph"] == "X"}
        assert mine == {"queue", "batch", "engine", "demux"}, r.trace_id
    append_ev = next(e for e in evs if e["name"] == "mutation/append")
    r1_demux = next(e for e in evs if e["name"] == "demux" and e["tid"] == int(r1.trace_id[1:]))
    r2_queue = next(e for e in evs if e["name"] == "queue" and e["tid"] == int(r2.trace_id[1:]))
    assert r1_demux["ts"] + r1_demux["dur"] <= append_ev["ts"] + 1.0
    assert append_ev["ts"] + append_ev["dur"] <= r2_queue["ts"] + 1.0
    files = sorted(prof.glob("dispatch-*.json"))
    assert len(files) == 3
    first = json.loads(files[0].read_text())
    assert any(str(e.get("name", "")).startswith("serve/engine kind=range")
               for e in first["traceEvents"])


def test_request_spans_are_in_the_trace_once_its_result_is(tmp_path, monkeypatch):
    """The driver puts a request's stage spans in the trace before it
    resolves the request's future: a caller that exports the trace as soon
    as it holds the result finds them, however slowly the driver goes on."""
    resolve = ServingFront._resolve

    def slow(fut, res):
        done = resolve(fut, res)
        time.sleep(0.2)  # the driver lags behind the caller
        return done

    monkeypatch.setattr(ServingFront, "_resolve", staticmethod(slow))
    idx, _, q, t = _built()
    with ServingFront(idx, buckets=(8,), max_delay_s=0.01) as front:
        r = front.submit(q[0], "range", t=t).result(timeout=120)
        evs = load_trace(front.export_trace(tmp_path / "trace.json"))["traceEvents"]
    mine = {e["name"] for e in evs if e.get("tid") == int(r.trace_id[1:]) and e["ph"] == "X"}
    assert mine == {"queue", "batch", "engine", "demux"}


def test_explain_and_spans_survive_generation_swap():
    idx, _, q, t = _built()
    with ServingFront(idx, buckets=(8,), max_delay_s=0.01) as front:
        r1 = front.submit(q[0], "range", t=t).result(timeout=120)
        front.append(_space("l2", 96, seed=16))
        r2 = front.submit(q[1], "range", t=t).result(timeout=120)
        front.compact()
        r3 = front.submit(q[2], "knn", k=3).result(timeout=120)
        recs = {r.trace_id: front.explain(r.trace_id) for r in (r1, r2, r3)}
        trace_evs = front._trace.events()
    assert [recs[r.trace_id]["generation"] for r in (r1, r2, r3)] == [0, 1, 2]
    tids = {e.get("tid") for e in trace_evs}
    for r in (r1, r2, r3):
        rec = recs[r.trace_id]
        assert rec["n_dists"] == r.n_dists
        assert set(rec["spans"]) >= {"queue", "engine", "total"}
        assert int(r.trace_id[1:]) in tids


def test_retrieval_server_folds_metrics():
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(400, DIM)).astype(np.float32)
    srv = RetrievalServer(corpus, metric="cosine", seed=1, device="cpu")
    q = rng.normal(size=(4, DIM)).astype(np.float32)
    srv.range_query(q, 0.2)
    srv.top_k(q, 3)
    snap = srv.metrics.snapshot()
    assert snap["counters"]["engine/queries{engine=bss,kind=range}"] == 4.0
    assert snap["counters"]["engine/queries{engine=bss,kind=knn}"] == 4.0
    assert snap["histograms"]["serve/call_s"]["count"] == 2
    assert validate_exposition(srv.metrics.to_prometheus()) == []
