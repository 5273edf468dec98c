"""The readers of the program's own spans (``search_ms``, ``engine_host_ms``,
``host_reads``, ``topk_ms``: ``repro_torch.obs.record``'s ring) on runs at
a CPU size: each host reader reads a value in a traced run of each of its
cells, and the device reader (``topk_ms``) nothing, as no card runs the
work; all read nothing for the control, which runs no program, or where
the program has no spans to read."""

from __future__ import annotations

import sys

import pytest

from portbench.tests.common import REPO, read, run, tiny_root

READERS = ("search_ms", "engine_host_ms", "host_reads", "topk_ms")
DEVICE = {"topk_ms"}  # device ms: read on a card only
CELLS = {m["name"]: m["workloads"] for m in read(REPO / "BENCHMARK.json")["per_layer"]
         if m["name"] in READERS}
CASES = [(m, w) for m in READERS for w in CELLS[m]]
IDS = [f"{m}-{w}" for m, w in CASES]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def runs(root):
    """Traced runs, one per (workload, control), made once."""
    from portbench import harness

    done: dict = {}

    def get(workload, control=False):
        if (workload, control) not in done:
            ctl = harness.load_cell(workload, root).config["control"] if control else None
            done[workload, control] = run(root, workload, trace=True, control=ctl)["result"]
        return done[workload, control]

    return get


@pytest.mark.parametrize("metric,workload", CASES, ids=IDS)
def test_reader_reads_a_traced_run(runs, metric, workload):
    res = runs(workload)
    assert res["correct"]
    if metric in DEVICE:
        assert metric not in res["metrics"]
    else:
        assert res["metrics"][metric]["value"] > 0


@pytest.mark.parametrize("metric,workload", CASES, ids=IDS)
def test_reader_reads_nothing_for_the_control(runs, metric, workload):
    res = runs(workload, control=True)
    assert not res["correct"]
    assert metric not in res["metrics"]


@pytest.mark.parametrize("workload", sorted({w for ws in CELLS.values() for w in ws}))
def test_readers_read_nothing_without_the_programs_spans(root, workload, monkeypatch):
    """A program without ``repro_torch.obs.record`` (the parent of the
    spans): the readers find nothing and raise nothing."""
    import repro_torch.obs

    monkeypatch.delattr(repro_torch.obs, "record")
    monkeypatch.setitem(sys.modules, "repro_torch.obs.record", None)
    res = run(root, workload, trace=True)["result"]
    assert res["correct"]
    assert not set(READERS) & set(res["metrics"])
    assert "dists_per_query" in res["metrics"]
