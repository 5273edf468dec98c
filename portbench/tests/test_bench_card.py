"""The command on the card: each cell for a few seconds, traced and not,
prints a correct result line with every key it must have.  Marked ``cuda``;
skips where there is no card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench.tests.common import REPO, read

WORKLOADS = [w["name"] for w in read(REPO / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_command_on_the_card(card, workload, trace):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                          "--seed", str(2**31 + 99), "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=REPO, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "compared"
    assert res["correct"] and res["failed"] == 0, res["compared"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    bench = read(REPO / "BENCHMARK.json")
    group = bench["per_layer"] if trace else bench["end_to_end"]
    want = {m["name"] for m in group if workload in m.get("workloads", [workload])}
    assert set(res["metrics"]) == want
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert 0 < res["metrics"]["dist_roofline"]["value"] <= 100
