"""The engine's spans and host-read counter (``repro_torch.obs.record``) on
the CPU: off, they record nothing and leave every result and stats key as
it was, bit for bit; under ``torch.profiler`` the ring holds the spans of
each call nested under its root, the profiler's trace holds the same
names, and the root counts the call's reads to the host."""

from __future__ import annotations

import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import flat_index
from repro_torch.core.backends import EngineOpts
from repro_torch.obs import record
from repro_torch.serve.front import ServingFront
from repro_torch.serve.retrieval import RetrievalServer

BUILD = dict(n_pivots=8, n_pairs=10, block=64, seed=5)
K = 5
CASES = [(kind, real, prec) for kind in ("range", "knn")
         for real in ("dense", "adaptive") for prec in ("fp32", "bf16")]
IDS = ["-".join(c) for c in CASES]

# each span's parent: the engine's phases under the call, the round's
# under the round; a sparse range pass reads its cells' hits inside the
# exact phase
CALL = "retrieval.search"
PARENTS = {
    CALL: {None},
    "bss.range.bound": {CALL},
    "bss.range.exact": {CALL},
    "bss.range.copy": {CALL, "bss.range.exact"},
    "bss.range.assemble": {CALL},
    "bss.range.stats": {CALL},
    "bss.knn.bound": {CALL},
    "bss.knn.copy": {CALL, "bss.knn.round"},
    "bss.knn.sort": {CALL},
    "bss.knn.round": {CALL},
    "bss.knn.exact": {"bss.knn.round"},
    "bss.knn.top_k": {"bss.knn.exact"},
    "bss.knn.schedule": {"bss.knn.round"},
}
NAMES = {kind: {n for n in PARENTS if n == CALL or n.startswith(f"bss.{kind}.")}
         for kind in ("range", "knn")}


@pytest.fixture(scope="module")
def data():
    """Points in the plane, where the bound prunes: the adaptive
    realisation gathers the alive cells of the range pass and of some kNN
    rounds."""
    rng = np.random.default_rng(3)
    x = rng.random((1640, 2)).astype(np.float32)
    corpus, q = x[:1600], x[1600:]
    d = np.sqrt(((q[:, None, :] - corpus[None]) ** 2).sum(-1))
    return corpus, q, float(np.quantile(d, 0.0005))


@pytest.fixture(scope="module")
def server(data):
    return RetrievalServer(data[0], metric="l2", device="cpu", **BUILD)


@pytest.fixture(autouse=True)
def empty_ring():
    record.clear()
    yield
    record.clear()


def _call(server, data, kind, real, prec):
    _, q, t = data
    opts = EngineOpts(realisation=real, precision=prec)
    if kind == "range":
        return server.search(q, "range", t=t, opts=opts)
    return server.search(q, "knn", k=K, opts=opts)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("kind,real,prec", CASES, ids=IDS)
def test_off_records_nothing_and_on_changes_nothing(server, data, kind, real, prec):
    off = _call(server, data, kind, real, prec)
    assert record.spans() == [] and record.dropped() == 0
    on, _ = _profiled(lambda: _call(server, data, kind, real, prec))
    assert record.spans()
    for field in ("hits", "indices", "distances", "stats", "generation"):
        assert _same(getattr(off, field), getattr(on, field)), field


@pytest.mark.parametrize("kind,real,prec", CASES, ids=IDS)
def test_spans_nest_under_one_root(server, data, kind, real, prec):
    res, prof = _profiled(lambda: _call(server, data, kind, real, prec))
    recs = record.spans()
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == [CALL]
    assert roots[0].args == {"kind": kind, "n": len(data[1])}
    assert {r.call for r in recs} == {roots[0].call}
    assert {r.name for r in recs} == NAMES[kind]
    for r in recs:
        assert r.parent in PARENTS[r.name], (r.name, r.parent)
        assert r.t0 <= r.t1 and -1e-9 <= r.self_s <= r.t1 - r.t0 + 1e-9
    # children lie inside their parent
    assert all(roots[0].t0 <= r.t0 and r.t1 <= roots[0].t1 for r in recs)
    if kind == "knn":
        rounds = [r for r in recs if r.name == "bss.knn.round"]
        assert [r.args["round"] for r in rounds] == list(range(1, res.stats["rounds"] + 1))
        top = [r for r in recs if r.name == "bss.knn.top_k"]
        assert len(top) == len(rounds)
        # the work ran on no card: no device ms
        assert all(r.device_ms is None for r in top)
        if real == "adaptive":  # a gathered round ran: fewer reads than dense rounds make
            assert roots[0].reads < 1 + (5 if prec == "fp32" else 7) * len(rounds)
    elif real == "adaptive":  # the gathered cells' hits are read inside the exact phase
        assert any(r.name == "bss.range.copy" and r.parent == "bss.range.exact" for r in recs)
    assert NAMES[kind] <= {e.name for e in prof.events()}


@pytest.mark.parametrize("kind,prec", [(k, p) for k in ("range", "knn") for p in ("fp32", "bf16")])
def test_root_counts_the_reads_to_the_host(server, data, kind, prec):
    """The dense realisation's reads: range, one (the hit positions beside
    the hit counts and the stats' sums, bf16's band counts too); kNN, the
    bounds once, then ``ci``, ``cd``, ``kth``, ``dn`` and ``alive`` a round
    (bf16 also the re-checked tiles and the band counts)."""
    res, _ = _profiled(lambda: _call(server, data, kind, "dense", prec))
    (root,) = [r for r in record.spans() if r.parent is None]
    if kind == "range":
        assert root.reads == 1
    else:
        assert root.reads == 1 + (5 if prec == "fp32" else 7) * res.stats["rounds"]
    assert all(r.reads is None for r in record.spans() if r.parent is not None)


# the range phases that carry a CUDA event pair (device ms on a card):
# every bound span, and the exact span of the fused pass (bf16's dense
# pass here; ``"cuda"``'s everywhere)
DEVICE_SPANS = {"bss.range.bound", "bss.range.exact"}
RANGE_CASES = [(real, prec) for real in ("dense", "adaptive") for prec in ("fp32", "bf16")]


@pytest.mark.parametrize("real,prec", RANGE_CASES, ids=["-".join(c) for c in RANGE_CASES])
def test_range_phase_spans_carry_the_device(server, data, real, prec, monkeypatch):
    """Every range bound span, and the fused bf16 pass's exact span, is
    opened with the queries' device; on the CPU its record has no device
    ms, and the call's results and stats are those of the profiler off."""
    opened = []

    def spy(name, device=None, **args):
        opened.append((name, device))
        return record.span(name, device=device, **args)

    monkeypatch.setattr(flat_index, "span", spy)
    off = _call(server, data, "range", real, prec)
    opened.clear()
    on, _ = _profiled(lambda: _call(server, data, "range", real, prec))
    for field in ("hits", "stats", "generation"):
        assert _same(getattr(off, field), getattr(on, field)), field
    with_device = [(n, d) for n, d in opened if d is not None]
    assert {n for n, _ in with_device} <= DEVICE_SPANS
    assert all(d == torch.device("cpu") for _, d in with_device)
    assert [d for n, d in opened if n == "bss.range.bound"] == [torch.device("cpu")]
    fused = real == "dense" and prec == "bf16"
    assert (("bss.range.exact", torch.device("cpu")) in with_device) == fused
    recs = record.spans()
    for name in DEVICE_SPANS:
        assert any(r.name == name for r in recs)
    assert all(r.device_ms is None and r.events is None for r in recs)


def test_fused_pass_spans_record_on_the_cpu(server, data):
    """``_query_batched``, the pass ``"cuda"`` runs, on the plain backend:
    its bound and exact spans record under a profiler with no device ms,
    and its outputs are those of the profiler off, bit for bit."""
    index = server.index
    _, q, t = data
    q_dev = torch.as_tensor(q)
    t_dev = torch.full((len(q),), t, dtype=torch.float32)

    def run():
        return flat_index._query_batched("l2", q_dev, t_dev, index.device, block=index.block,
                                         bq=16, backend="torch")

    off = run()
    assert record.spans() == []
    on, _ = _profiled(run)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)
    recs = record.spans()
    assert [r.name for r in recs] == ["bss.range.bound", "bss.range.exact"]
    assert all(r.parent is None and r.device_ms is None for r in recs)


def test_ring_drops_and_counts(server, data, monkeypatch):
    ring = record.Ring(8)
    monkeypatch.setattr(record, "RING", ring)
    _profiled(lambda: _call(server, data, "knn", "dense", "fp32"))
    assert len(ring) == 8 and ring.dropped > 0
    recs = ring.read()
    assert len(recs) == 8 and recs[-1].name == CALL  # the newest kept
    ring.clear()
    assert len(ring) == 0 and ring.dropped == 0


def test_to_host_counts_only_while_recording():
    t = torch.arange(6).reshape(2, 3)
    assert np.array_equal(record.to_host(t), t.numpy())
    with record.span("outside"):  # no profiler: a null context
        record.to_host(t)
    assert record.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with record.span("outer"):
            with record.span("inner", device=t.device, step=1):
                record.to_host(t)
            record.to_host(t)
        record.to_host(t)  # no span open: no call to count it on
    inner, outer = record.spans()
    assert (outer.name, outer.parent, outer.reads) == ("outer", None, 2)
    assert (inner.name, inner.parent, inner.reads, inner.args) == ("inner", "outer", None,
                                                                   {"step": 1})
    assert inner.device_ms is None  # a device= span on no card
    assert inner.call == outer.call and outer.call.startswith("t")
    assert outer.self_s <= (outer.t1 - outer.t0) - (inner.t1 - inner.t0) + 1e-9


@pytest.mark.parametrize("where", ["caller", "profile_dir"])
def test_front_dispatch_span_is_the_root(server, data, tmp_path, where):
    """The front's dispatch span, named after the dispatch, is the root of
    the engine's spans while a profiler records: a caller's, whose spans
    stay in the ring, or the front's own ``profile_dir=`` one, which
    writes them to its trace file and clears the ring when it closes."""
    _, q, t = data
    own = where == "profile_dir"
    with contextlib.ExitStack() as stack:
        if not own:
            stack.enter_context(profile(activities=[ProfilerActivity.CPU]))
        front = stack.enter_context(ServingFront(
            server.index, buckets=(8,), max_delay_s=0.01,
            profile_dir=str(tmp_path) if own else None))
        front.submit(q[0], "knn", k=K).result(timeout=120)
        front.submit(q[1], "range", t=t).result(timeout=120)
    recs = record.spans()
    if own:
        assert recs == []
        names = [{e["name"] for e in json.loads(f.read_text())["traceEvents"]}
                 for f in sorted(tmp_path.glob("dispatch-*.json"))]
        assert len(names) == 2
        for got, kind in zip(names, ("knn", "range")):
            (root,) = [n for n in got if n.startswith(f"serve/engine kind={kind} ")]
            assert "t_dispatch=" in root
            assert NAMES[kind] - {CALL} <= got
        return
    roots = [r for r in recs if r.parent is None]
    assert [r.name.split(" ")[:2] for r in roots] == [["serve/engine", "kind=knn"],
                                                      ["serve/engine", "kind=range"]]
    assert all("t_dispatch=" in r.name for r in roots)
    for root, kind in zip(roots, ("knn", "range")):
        mine = [r for r in recs if r.call == root.call]
        assert {r.name for r in mine} - {root.name} == NAMES[kind] - {CALL}
        assert next(r for r in mine if r.name == f"bss.{kind}.bound").parent == root.name
        assert root.reads > 0
