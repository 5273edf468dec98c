"""The benchmark's parts on the CPU: traffic and thresholds repeat for a
seed, the frozen copies hold their checksums, the reference agrees with a
brute force, the trace's reading, what the harness and the reference
import, the command's refusals, and ``BENCHMARK.json`` against the files
it names."""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import compare, trace, traffic
from portbench.frozen_metricsets import calibrate_threshold, colors_surrogate, split_queries
from portbench.reference import cosine, jsd, l2
from portbench.tests.common import REPO, read

BANNED = {"jax", "jaxlib", "flax", "repro"}


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def test_traffic_repeats_for_a_seed():
    spec = {"kind": "knn", "k": 10, "batch": 96}
    seed = 2**31 + 3
    a = [traffic.calls(spec, 1000, seed) for _ in range(2)]
    first = [next(a[0]).rows for _ in range(25)]
    assert all(np.array_equal(r, next(a[1]).rows) for r in first)
    # every seed sends the same rows: each stretch of 1,000 is a permutation
    flat = np.concatenate(first)[:2000]
    assert sorted(flat[:1000]) == list(range(1000)) == sorted(flat[1000:])
    other = next(traffic.calls(spec, 1000, seed + 1)).rows
    assert not np.array_equal(other, first[0])
    warm = next(traffic.calls(spec, 1000, seed, traffic.WARMUP)).rows
    assert not np.array_equal(warm, first[0])


def test_range_thresholds_repeat_and_cycle():
    rows = colors_surrogate(1500, 16, seed=0).astype(np.float32)
    spec = {"kind": "range", "batch": 8, "selectivities": [1e-3, 1e-2],
            "calibration": {"seed": 0, "n_query_sample": 40, "n_data_sample": 500}}

    def pw(a, b):
        return jsd.pairwise(torch.as_tensor(a), torch.as_tensor(b)).numpy()

    ts = traffic.thresholds(spec, rows, pw)
    assert ts == traffic.thresholds(spec, rows, pw) and ts[0] < ts[1]
    gen = traffic.calls(spec, 100, 5, ts=ts)
    assert [next(gen).t for _ in range(4)] == [ts[0], ts[1], ts[0], ts[1]]


def test_frozen_copies_hold_their_checksums():
    colors = colors_surrogate(3000, 16, seed=0)
    assert _sha(colors) == "cee7d6b0f39a5ca2"
    corpus, queries = split_queries(colors, 0.1, seed=1)
    assert (_sha(corpus), _sha(queries)) == ("60729603bb020713", "19383a3e63395895")

    def pw(a, b):
        return jsd.pairwise(torch.as_tensor(a), torch.as_tensor(b)).numpy()

    t = calibrate_threshold(pw, colors, 1e-3, seed=0, n_query_sample=50, n_data_sample=500)
    assert math.isclose(t, 0.07706795012197284, rel_tol=1e-12)


def _brute(metric: str, q: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Each metric from its definition, one pair at a time, in float64."""
    out = np.empty((len(q), len(x)))
    for i, a in enumerate(q):
        for j, b in enumerate(x):
            if metric == "l2":
                out[i, j] = math.sqrt(sum((u - v) ** 2 for u, v in zip(a, b)))
            elif metric == "cosine":
                cos = np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b))
                out[i, j] = math.sqrt(max(2 - 2 * cos, 0.0))
            else:
                xl = lambda v: v * math.log(v) if v > 1e-12 else 0.0
                s = sum(0.5 * xl(u) + 0.5 * xl(v) - xl((u + v) / 2) for u, v in zip(a, b))
                out[i, j] = math.sqrt(max(s, 0.0) / math.log(2))
    return out


@pytest.mark.parametrize("metric", ["l2", "cosine", "jsd"])
def test_reference_agrees_with_a_brute_force(metric):
    ref = {"l2": l2, "cosine": cosine, "jsd": jsd}[metric]
    rows = colors_surrogate(60, 12, seed=3)
    rows[0, :6] = 0.0  # empty bins: the guard of x log x
    rows[0] /= rows[0].sum()
    q, x = rows[:7], rows[7:]
    want = _brute(metric, q, x)
    qt, xt = ref.prepare(torch.as_tensor(q)), ref.prepare(torch.as_tensor(x))
    np.testing.assert_allclose(ref.pairwise(qt, xt).numpy(), want, rtol=1e-10, atol=1e-12)
    ids = np.argsort(want, axis=1)[:, :5]
    np.testing.assert_allclose(ref.paired(qt, xt[torch.as_tensor(ids)]).numpy(),
                               np.take_along_axis(want, ids, 1), rtol=1e-10, atol=1e-12)
    # the brute force's own answers read 0 in every number compared
    answers = [(np.arange(7), ids, np.take_along_axis(want, ids, 1).astype(np.float32))]
    nums = compare.knn_numbers(ref, xt, qt, answers, 5)
    # (pairwise and paired round differently in float64: a few 1e-16)
    assert nums["bad_answers"] == 0 and nums["rank_gap"] <= 1e-12 and nums["dist_err"] < 1e-7


def test_malformed_answers_are_counted():
    x = torch.rand(50, 4, dtype=torch.float64)
    q = torch.rand(3, 4, dtype=torch.float64)
    d = l2.pairwise(q, x).numpy()
    ids = np.argsort(d, axis=1)[:, :3]
    dists = np.take_along_axis(d, ids, 1)
    bad_ids = ids.copy()
    bad_ids[0, 1] = bad_ids[0, 0]          # repeated id
    bad_ids[1, 0] = -1                     # missing
    answers = [(np.arange(3), bad_ids, dists), (np.arange(3), ids[:, :2], dists[:, :2])]
    nums = compare.knn_numbers(l2, x, q, answers, 3)
    assert nums["bad_answers"] == 2 + 3


def test_range_numbers():
    x = torch.rand(200, 4, dtype=torch.float64)
    q = torch.rand(4, 4, dtype=torch.float64)
    d = l2.pairwise(q, x).numpy()
    t = float(np.quantile(d, 0.1))
    hits = [np.nonzero(r <= t)[0].tolist() for r in d]
    ok = compare.range_numbers(l2, x, q, [(np.arange(4), np.full(4, t), hits)])
    assert ok == {"bad_answers": 0, "hit_margin": 0.0}
    dropped = [h[1:] for h in hits]
    far = compare.range_numbers(l2, x, q, [(np.arange(4), np.full(4, t), dropped)])
    assert far["hit_margin"] == max(t - d[i, h[0]] for i, h in enumerate(hits) if h)


def test_trace_summary():
    dev = [(10, 20, "void k1<float>(int)"), (25, 30, "k2"), (28, 40, "k2"), (60, 70, "k1<float>")]
    host = [(0, 100, "serve.search"), (20, 26, "aten::nonzero"),
            (40, 55, "flat_index.knn_round"), (42, 50, "aten::copy_"), (80, 130, "aten::x")]
    s = trace.summarise(dev, host)
    assert s["busy_s"] == pytest.approx(35e-6) and s["window_s"] == pytest.approx(100e-6)
    assert s["device_ops"] == [["k1<float>", pytest.approx(20e-6)], ["k2", pytest.approx(17e-6)]]
    assert dict(s["idle_gaps"]) == pytest.approx({"serve.search": 10e-6, "aten::nonzero": 5e-6,
                                                  "aten::copy_": 20e-6, "aten::x": 30e-6})


def _modules_after(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}{REPO / 'src'}")
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    code = ("import portbench.compare, portbench.traffic, portbench.frozen_metricsets, "
            "portbench.work, portbench.card\n"
            "import portbench.reference.jsd, portbench.reference.l2, portbench.reference.cosine\n"
            "import portbench.datasets.sisap_colors")
    found = _modules_after(code)
    assert not found & (BANNED | {"repro_torch"}), found


def test_a_run_imports_no_jax():
    """A whole run at a CPU size, then every module the process holds,
    compared by whole top-level names: the port's name begins with the JAX
    package's, and is allowed."""
    code = ("from portbench.tests.common import tiny_root, run\n"
            "import tempfile, pathlib\n"
            "root = tiny_root(pathlib.Path(tempfile.mkdtemp()))\n"
            "assert run(root, 'colors-jsd-knn', trace=True)['result']['correct']")
    found = _modules_after(code)
    assert "repro_torch" in found and not found & BANNED, found


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command runs")


def _command(cwd, *extra):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "colors-jsd-knn",
                           "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
                          capture_output=True, text=True, cwd=cwd, timeout=300)


def test_command_refuses_without_a_card(no_card):
    out = _command(REPO)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_command_refuses_in_a_bare_checkout(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_names_only_files_that_exist():
    bench = read(REPO / "BENCHMARK.json")
    pb = REPO / "portbench"
    assert bench["command"][1] == "portbench/run.py" and bench["paths"] == ["portbench"]
    for cfg in bench["configs"]:
        assert (REPO / cfg["file"]).is_file() and cfg["file"].startswith("portbench/")
        body = read(REPO / cfg["file"])
        assert (pb / "datasets" / f"{body['data']}.py").is_file()
        assert (pb / "reference" / f"{body['metric']}.py").is_file()
    names = [w["name"] for w in bench["workloads"]]
    for wl in bench["workloads"]:
        assert (pb / "traffic" / f"{wl['traffic']}.json").is_file()
        assert (pb / "limits" / f"{wl['name']}.json").is_file()
        assert wl["chips"] == 1
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and (pb / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", names)) <= set(names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert all(m["moves"] in e2e for m in bench["per_layer"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])
