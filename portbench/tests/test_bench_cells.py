"""Runs of the benchmark's cells at a CPU size: a sound run is correct, and
the control and each fault a search cell can have make ``correct`` false.
Also: a cell, a configuration, a traffic mix and a per-layer metric added
as files and entries alone."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.tests.common import REPO, read, run, tiny_root, write

WORKLOADS = [w["name"] for w in read(REPO / "BENCHMARK.json")["workloads"]]
COMPARED = {"knn": {"bad_answers", "dist_err", "rank_gap"}, "range": {"bad_answers", "hit_margin"}}


def _kind(root, workload) -> str:
    from portbench import harness

    return harness.load_cell(workload, root).traffic["kind"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(root, workload):
    out = run(root, workload)
    res = out["result"]
    assert res["correct"], out["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 48
    assert set(res["metrics"]) == {"qps", "p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(out["compared"]) == COMPARED[_kind(root, workload)]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run_reads_the_per_layer_metrics(root, workload):
    res = run(root, workload, trace=True)["result"]
    assert res["correct"]
    # no device in a CPU run: the device's metrics read nothing and are left out
    if _kind(root, workload) == "knn":
        assert set(res["metrics"]) == {"batch_ms", "dists_per_query", "knn_rounds"}
        assert res["metrics"]["knn_rounds"]["value"] >= 1
    else:
        assert set(res["metrics"]) == {"batch_ms", "dists_per_query"}
    assert res["device"]["busy_s"] == 0 and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(root, workload):
    from portbench import harness

    control = harness.load_cell(workload, root).config["control"]
    out = run(root, workload, control=control)
    assert not out["result"]["correct"], out["compared"]


def _patched(monkeypatch, alter):
    """``RetrievalServer.search`` with ``alter(queries, kind, kw, search)``
    in its place."""
    from repro_torch.serve.retrieval import RetrievalServer

    orig = RetrievalServer.search

    def search(self, queries, kind="range", **kw):
        return alter(queries, kind, kw, lambda q: orig(self, q, kind, **kw))

    monkeypatch.setattr(RetrievalServer, "search", search)


def _half_batch(queries, kind, kw, search):
    # the second half of the batch left out: its rows repeat the first's
    h = len(queries) // 2
    r = search(queries[:h])
    rest = len(queries) - h
    if kind == "knn":
        r.indices = np.concatenate([r.indices, r.indices[:rest]])
        r.distances = np.concatenate([r.distances, r.distances[:rest]])
    else:
        r.hits = r.hits + r.hits[:rest]
    return r


def _altered_answer(queries, kind, kw, search):
    # one answer altered where it is produced: a query's nearest id, or ten
    # rows put into a query's hits
    r = search(queries)
    if kind == "knn":
        r.indices = r.indices.copy()
        r.indices[0, 0] = (r.indices[0, 0] + 1) % 1000
    else:
        r.hits = [sorted(set(r.hits[0]) | set(range(10))), *r.hits[1:]]
    return r


@pytest.mark.parametrize("fault", [_half_batch, _altered_answer], ids=["half_batch", "altered"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_is_not_correct(root, workload, fault, monkeypatch):
    _patched(monkeypatch, fault)
    out = run(root, workload)
    assert not out["result"]["correct"], out["compared"]


def test_failed_call_is_counted(root, monkeypatch):
    made = []

    def fail(queries, kind, kw, search):
        made.append(1)
        if len(made) > 3 and len(made) % 2 == 0:  # every other call after the warm-up
            raise RuntimeError("planted")
        return search(queries)

    _patched(monkeypatch, fail)
    res = run(root, WORKLOADS[0], seconds=1.0)["result"]
    assert not res["correct"] and 0 < res["failed"] < res["attempted"]


@pytest.mark.parametrize("key,value", [("kind", "forest"), ("precision", "bf16")])
def test_an_unserved_index_kind_or_precision_is_refused(root, key, value):
    from portbench import harness

    cell = harness.load_cell(WORKLOADS[0], root)
    if key == "kind":
        cell.config["index"] = dict(cell.config["index"], kind=value)
    else:
        cell.config[key] = value
    with pytest.raises(ValueError, match=value):
        harness.run_cell(cell, 1, 0.5, False, device="cpu")


CALLS_READER = '''"""Calls made in the traced window."""


def read(run):
    return float(len(run.calls)) if run.calls else None
'''


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_cell_added_as_data_only(tmp_path, trace):
    """A new configuration (colors under l2), traffic mix (range at two
    selectivities), cell, limits and per-layer metric: files and entries
    only, and the harness runs the cell."""
    root = tiny_root(tmp_path)
    pb = root / "portbench"
    cfg = read(pb / "configs" / "sisap-colors.json")
    cfg.update(name="tiny-colors-l2", metric="l2", control="tf32", n_points=2000)
    write(pb / "configs" / "tiny-colors-l2.json", cfg)
    write(pb / "traffic" / "range-b32.json",
          {"kind": "range", "batch": 32, "selectivities": [1e-3, 1e-2],
           "calibration": {"seed": 0, "n_query_sample": 50, "n_data_sample": 1000}})
    write(pb / "limits" / "tiny-l2-range.json", {"limits": {"bad_answers": 0, "hit_margin": 1e-6}})
    (pb / "metrics" / "calls_made.py").write_text(CALLS_READER)
    bench = read(root / "BENCHMARK.json")
    bench["configs"].append({"name": "tiny-colors-l2", "source": "a test",
                             "file": "portbench/configs/tiny-colors-l2.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny-l2-range", "config": "tiny-colors-l2",
                               "traffic": "range-b32", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls_made", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "serve", "moves": "qps",
                               "workloads": ["tiny-l2-range"]})
    write(root / "BENCHMARK.json", bench)

    out = run(root, "tiny-l2-range", trace=trace)
    res = out["result"]
    assert res["correct"], out["compared"]
    assert set(out["compared"]) == {"bad_answers", "hit_margin"}
    if trace:
        assert res["metrics"]["calls_made"]["value"] >= 1
        assert "knn_rounds" not in res["metrics"]
    else:
        assert set(res["metrics"]) == {"qps", "p95_ms", "setup_s"}
    # the range path's control is caught too
    assert not run(root, "tiny-l2-range", control="bf16")["result"]["correct"]
