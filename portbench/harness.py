"""One run of one cell: set-up, the measured window, the comparison and
the metrics.  ``run.py`` is the command; this module is what it drives.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``; its configuration's file (``configs/``); the
configuration's data generator (``datasets/<data>.py``) and plain
reference (``reference/<metric>.py``); its traffic (``traffic/<traffic>.json``,
read by ``traffic.py``); its limits (``limits/<cell>.json``); and each
metric's reader (``metrics/<metric>.py``).  Adding a cell, a configuration
or a metric adds files and entries and edits none.

The window: one closed-loop client sends the traffic's calls back to back
through ``RetrievalServer.search`` until ``seconds`` have passed since the
first send; every call that started is counted.  Set-up is the process's
start to the first send.  After the window the server is freed and every
answer the calls returned is compared with the reference
(``compare.py``).  ``control=`` puts the reference, computed in a lower
precision, in the server's place: the benchmark's own runs never do; the
control's readings come from ``controls.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from portbench import card as card_mod
from portbench import compare, traffic as traffic_mod
from portbench.trace import CALL_SPAN, layer_spans, read as read_trace

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
REF_BUDGET = 1 << 30  # bytes of reference intermediates at once
WARMUP_CALLS = 3      # calls of the traffic's shapes before the window
INDEX_KINDS = ("bss",)
PRECISIONS = ("fp32",)


@dataclasses.dataclass
class Sent:
    """One call of the window."""
    t_send: float
    t_done: float
    n: int                    # queries
    ok: bool                  # returned without raising
    stats: dict | None        # the engine's stats dict
    out_items: int            # kNN: n x k; range: hits

    @property
    def seconds(self) -> float:
        return self.t_done - self.t_send


@dataclasses.dataclass
class RunRecord:
    """What a metric's reader reads."""
    config: dict
    traffic: dict
    calls: list
    window_s: float
    setup_s: float
    trace: dict | None
    card: dict
    metric: str
    n_rows: int
    dim: int


def _load(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(f"portbench_{label}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with everything it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path

    def module(self, kind: str, name: str):
        return _load(self.root / "portbench" / kind / f"{name}.py",
                     f"{kind}_{name}".replace(".", "_").replace("-", "_"))


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    read = lambda *parts: json.loads(root.joinpath(*parts).read_text())
    return Cell(
        name=name, chips=wl["chips"], config=read(cfg_entry["file"]),
        traffic=read("portbench", "traffic", f"{wl['traffic']}.json"),
        limits=read("portbench", "limits", f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root,
    )


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


class Server:
    """The system under test: ``RetrievalServer`` over a BSS index built
    from the configuration, on ``device``, searched in float32.  A
    configuration that states another index kind or precision is refused,
    not run under the wrong label."""

    def __init__(self, config: dict, corpus: np.ndarray, device):
        from repro_torch.serve.retrieval import RetrievalServer

        idx = config["index"]
        if idx["kind"] not in INDEX_KINDS or config["precision"] not in PRECISIONS:
            raise ValueError(f"the harness serves index kinds {INDEX_KINDS} in {PRECISIONS}; "
                             f"{config['name']!r} states {idx['kind']!r} in "
                             f"{config['precision']!r}")
        self.server = RetrievalServer(
            corpus, metric=config["metric"], n_pivots=idx["n_pivots"], n_pairs=idx["n_pairs"],
            block=idx["block"], seed=idx["seed"], device=device,
        )
        _ = self.server.index.device  # the device mirror, made once

    def search(self, queries: np.ndarray, spec: dict, t: float | None):
        if spec["kind"] == "knn":
            r = self.server.search(queries, "knn", k=spec["k"])
            return r.indices, r.distances, None, r.stats
        r = self.server.search(queries, "range", t=t)
        return None, None, r.hits, r.stats


class Control:
    """The reference in the server's place: brute force over the corpus
    with the reference's ``control`` distances (a lower precision)."""

    def __init__(self, ref, corpus: np.ndarray, device, precision: str):
        self.ref, self.precision = ref, precision
        self.corpus = torch.as_tensor(corpus, device=device)

    def search(self, queries: np.ndarray, spec: dict, t: float | None):
        n, d = self.corpus.shape
        q = torch.as_tensor(queries, device=self.corpus.device)
        step = max(1, REF_BUDGET // (n * self.ref.pair_bytes(d)))
        ids, dists, hits = [], [], []
        for lo in range(0, q.shape[0], step):
            dist = self.ref.control(q[lo:lo + step], self.corpus, self.precision).float()
            if spec["kind"] == "knn":
                v, i = torch.topk(dist, spec["k"], dim=1, largest=False, sorted=True)
                ids.append(i.cpu().numpy())
                dists.append(v.cpu().numpy())
            else:
                hits.extend(np.nonzero(r)[0].tolist() for r in (dist <= t).cpu().numpy())
        stats = {"dists_per_query": float(n)}
        if spec["kind"] == "knn":
            return np.concatenate(ids), np.concatenate(dists), None, stats
        return None, None, hits, stats


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             control: str | None = None, t_start: float | None = None) -> dict:
    """One run.  Returns ``result`` (the line's keys), ``compared`` and
    ``extra`` (numbers for earlier lines)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cfg, spec = cell.config, cell.traffic
    card = card_mod.describe(device)
    if card:
        log("card " + json.dumps(card))
    if device.type == "cuda":
        # the configuration states float32: no TF32 anywhere
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

    phases = {}
    t0 = time.perf_counter()
    data = cell.module("datasets", cfg["data"]).make(cfg, seed, device)
    ref = cell.module("reference", cfg["metric"])
    _sync(device)
    phases["data_s"] = time.perf_counter() - t0
    ts = None
    if spec["kind"] == "range":
        t0 = time.perf_counter()

        def pairwise(a, b):
            a = ref.prepare(torch.as_tensor(a, device=device))
            return ref.pairwise(a, ref.prepare(torch.as_tensor(b, device=device))).cpu().numpy()

        ts = traffic_mod.thresholds(spec, data.corpus, pairwise)
        phases["thresholds_s"] = time.perf_counter() - t0
        log(f"thresholds {ts}")
    t0 = time.perf_counter()
    engine = (Server(cfg, data.corpus, device) if control is None
              else Control(ref, data.corpus, device, control))
    _sync(device)
    phases["index_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    warm = traffic_mod.calls(spec, len(data.pool), seed, traffic_mod.WARMUP, ts)
    for _ in range(WARMUP_CALLS):
        c = next(warm)
        engine.search(data.pool[c.rows], spec, c.t)
    _sync(device)
    phases["warmup_s"] = time.perf_counter() - t0
    if device.type == "cuda":
        # the peak of what serving holds: set-up's transients are not counted
        phases["setup_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    calls, answers, failed = [], [], 0
    gen = traffic_mod.calls(spec, len(data.pool), seed, traffic_mod.WINDOW, ts)
    with _traced(trace, device) as prof:
        first = time.perf_counter()
        setup_s = first - t_start
        end = first + seconds
        while True:
            c = next(gen)
            queries = data.pool[c.rows]
            t_send = time.perf_counter()
            if calls and t_send >= end:
                break
            try:
                with _span(trace):
                    ids, dists, hits, stats = engine.search(queries, spec, c.t)
                ok = True
            except Exception:  # a failed call is counted, and the run is not correct
                log(traceback.format_exc())
                ids = dists = hits = stats = None
                ok = False
                failed += len(c.rows)
            t_done = time.perf_counter()
            out = (ids.size if ids is not None else sum(map(len, hits)) if hits else 0)
            calls.append(Sent(t_send, t_done, len(c.rows), ok, stats, out))
            answers.append((c.rows, ids, dists) if spec["kind"] == "knn"
                           else (c.rows, np.full(len(c.rows), c.t), hits))
    window_s = calls[-1].t_done - calls[0].t_send
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    traced = read_trace(prof) if prof is not None else None

    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    corpus = ref.prepare(torch.as_tensor(data.corpus, dtype=torch.float64, device=device))
    pool = ref.prepare(torch.as_tensor(data.pool, dtype=torch.float64, device=device))
    if spec["kind"] == "knn":
        numbers = compare.knn_numbers(ref, corpus, pool, answers, spec["k"], REF_BUDGET)
    else:
        numbers = compare.range_numbers(ref, corpus, pool, answers, REF_BUDGET)
    del corpus, pool
    passed, compared = compare.judge(numbers, cell.limits["limits"])
    phases["compare_s"] = time.perf_counter() - t0

    record = RunRecord(
        config=cfg, traffic=spec, calls=calls, window_s=window_s,
        setup_s=setup_s, trace=traced, card=card, metric=cfg["metric"],
        n_rows=int(data.corpus.shape[0]), dim=int(data.corpus.shape[1]),
    )
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": card.get("kind", str(device)),
        "count": cell.chips,
        "memory_peak_bytes": memory_peak,
    }
    result = {"correct": passed and failed == 0, "attempted": sum(c.n for c in calls),
              "failed": failed, "metrics": metrics, "device": dev_info}
    if traced:
        dev_info["busy_s"] = traced["busy_s"]
        dev_info["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    extra = dict(phases, calls=len(calls), window_s=window_s, setup_s=setup_s,
                 spans_s=traced.get("spans_s") if traced else None)
    return {"result": result, "compared": compared, "extra": extra}


class _traced:
    """``torch.profiler`` over the window (and the engine's layer spans)
    when tracing; nothing otherwise.  Yields the profiler or None."""

    def __init__(self, on: bool, device):
        self.on, self.device = on, torch.device(device)
        self.stack = None

    def __enter__(self):
        if not self.on:
            return None
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.stack = contextlib.ExitStack()
        prof = self.stack.enter_context(profile(activities=acts))
        self.stack.enter_context(layer_spans())
        return prof

    def __exit__(self, *exc):
        if self.stack is not None:
            self.stack.close()
        return False


def _span(on: bool):
    return torch.profiler.record_function(CALL_SPAN) if on else contextlib.nullcontext()
