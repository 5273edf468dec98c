"""The reader of the range exact phase's device ms (``exact_ms``) on
synthetic span records, and the cell ``euc10-l2-range`` run through the
harness on the CPU at a reduced size: its data, its traffic's
calibration, the l2 reference, the TF32 control and the planted faults."""

from __future__ import annotations

import sys

import numpy as np
import pytest

from portbench.tests.common import read, run, tiny_root, write
from portbench.tests.test_bench_cells import _altered_answer, _half_batch, _patched

CELL = "euc10-l2-range"


def _reader():
    from portbench import harness

    return harness._load(harness.PKG / "metrics" / "exact_ms.py", "test_exact_ms")


def _record(calls):
    from portbench.harness import RunRecord

    return RunRecord(config={}, traffic={"kind": "range"}, calls=calls, window_s=1.0,
                     setup_s=1.0, trace=None, card={}, metric="l2", n_rows=1, dim=1)


def _sent(t0, t1):
    from portbench.harness import Sent

    return Sent(t_send=t0, t_done=t1, n=1, ok=True, stats={}, out_items=0)


def _span(name, call, t0, parent="retrieval.search", device_ms=None):
    from repro_torch.obs.record import SpanRecord

    return SpanRecord(name, call, parent, t0, t0 + 0.001, 0.001, device_ms=device_ms)


@pytest.fixture
def spans(monkeypatch):
    """Three calls in the window (a, b, c) and one before it (z): a and b
    carry device ms on their bound and fused exact spans, c none (a CPU
    call); each call's epilogue has an exact span without device ms.  The
    bound's device ms are not the exact phase's."""
    from repro_torch.obs import record

    recs = [_span("retrieval.search", "z", 0.5, parent=None),
            _span("bss.range.bound", "z", 0.5, device_ms=100.0),
            _span("bss.range.exact", "z", 0.5, device_ms=100.0)]
    for call, t0, bound, exact in (("a", 1.0, 0.05, 2.0), ("b", 2.0, 0.07, 3.0),
                                   ("c", 3.0, None, None)):
        recs += [_span("retrieval.search", call, t0, parent=None),
                 _span("bss.range.bound", call, t0, device_ms=bound),
                 _span("bss.range.exact", call, t0, device_ms=exact),
                 _span("bss.range.exact", call, t0),
                 _span("bss.range.copy", call, t0, device_ms=50.0)]
    monkeypatch.setattr(record, "spans", lambda: recs)
    return [_sent(1.0, 1.5), _sent(2.0, 2.5), _sent(3.0, 3.5)]


def test_reader_averages_the_calls_with_device_ms(spans):
    assert _reader().read(_record(spans)) == pytest.approx(2.5)


def test_a_call_with_two_timed_spans_sums_them(spans, monkeypatch):
    from repro_torch.obs import record

    recs = record.spans() + [_span("bss.range.exact", "a", 1.1, device_ms=1.0)]
    monkeypatch.setattr(record, "spans", lambda: recs)
    assert _reader().read(_record(spans)) == pytest.approx((3.0 + 3.0) / 2)


def test_reader_reads_nothing_without_device_ms(spans):
    # only the CPU call in the window
    assert _reader().read(_record(spans[2:])) is None


def test_reader_reads_nothing_outside_the_window_or_without_spans(spans, monkeypatch):
    from repro_torch.obs import record

    assert _reader().read(_record([_sent(10.0, 11.0)])) is None
    assert _reader().read(_record([])) is None
    monkeypatch.delattr(record, "spans")
    monkeypatch.delattr(sys.modules["repro_torch.obs"], "record")
    monkeypatch.setitem(sys.modules, "repro_torch.obs.record", None)
    assert _reader().read(_record(spans)) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The benchmark at a CPU size, the cell's space cut to 20,000 rows and
    its thresholds to paper_common's reduced regime (5e-5 x 1, 2, 4)."""
    root = tiny_root(tmp_path_factory.mktemp("bench"))
    pb = root / "portbench"
    cfg = read(pb / "configs" / "euc10-1m.json")
    cfg.update(n_points=20_000, n_queries=300)
    write(pb / "configs" / "euc10-1m.json", cfg)
    traffic = read(pb / "traffic" / "range-s3e6-b512.json")
    traffic.update(selectivities=[5e-5, 1e-4, 2e-4],
                   calibration=dict(traffic["calibration"], n_data_sample=20_000))
    write(pb / "traffic" / "range-s3e6-b512.json", traffic)
    return root


def test_data_is_float32_at_the_configured_sizes(root):
    from portbench import harness

    cell = harness.load_cell(CELL, root)
    data = cell.module("datasets", cell.config["data"]).make(cell.config, 2**40 + 3, "cpu")
    assert data.corpus.shape == (20_000, 10) and data.pool.shape == (300, 10)
    assert data.corpus.dtype == data.pool.dtype == np.float32
    assert 0 <= data.corpus.min() and data.corpus.max() <= 1
    assert not np.array_equal(data.corpus[:300], data.pool)  # a second seed


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_sound_run_is_correct(root, trace):
    out = run(root, CELL, trace=trace)
    res = out["result"]
    assert res["correct"], out["compared"]
    assert set(out["compared"]) == {"bad_answers", "hit_margin"}
    if not trace:
        assert set(res["metrics"]) == {"qps", "p95_ms", "setup_s"}
        return
    got = set(res["metrics"])
    assert {"batch_ms", "dists_per_query", "search_ms", "engine_host_ms", "host_reads"} <= got
    assert "exact_ms" not in got  # no card ran the work
    assert res["metrics"]["host_reads"]["value"] >= 1  # "torch" adaptive reads `alive` too


def test_tf32_control_is_not_correct(root):
    # the control differs from the reference only at rows near a threshold:
    # a longer window, so that a loaded host still covers the pool at each
    out = run(root, CELL, control="tf32", seconds=3.0)
    assert not out["result"]["correct"], out["compared"]
    assert out["compared"]["hit_margin"]["value"] > out["compared"]["hit_margin"]["limit"]


@pytest.mark.parametrize("fault", [_half_batch, _altered_answer], ids=["half_batch", "altered"])
def test_fault_is_not_correct(root, fault, monkeypatch):
    _patched(monkeypatch, fault)
    out = run(root, CELL)
    assert not out["result"]["correct"], out["compared"]
    assert out["compared"]["bad_answers"]["value"] == 0  # well formed: the margin judges
    assert out["compared"]["hit_margin"]["value"] > out["compared"]["hit_margin"]["limit"]
