#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: the quickest proof that the port builds and serves on the card.

    python3 chip_smoke.py        # from the root of a checkout

Phases (any failure is reported and the script exits non-zero):

1. Require a CUDA device of compute capability 9.0; print the card's name
   and power limit (nvidia-smi) and set float32 matmuls to IEEE (no TF32).
2. Build every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per
   source, all at once) and print the build seconds and ptxas' report.
3. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, and time kernel, plain version, ``torch.cdist``
   (the library yardstick; the port never calls it) and the least time the
   card could take (``bound_ms``).
4. The main path: the SISAP colors configuration at paper size (101,414 x
   112 corpus, 11,268 queries), index built for the card, all queries
   through ``bss_query_batched(backend="cuda")`` in 512-query batches at
   the three calibrated thresholds, with every launch count zeroed just
   before and read just after.  Checked against the plain ``"torch"``
   backend on the same card and the numpy oracle on 64 queries: a hit that
   differs must lie within 1e-5 * max(1, t) of t in float64, an ``alive``
   cell that differs must have its bound within 1e-5 of t.  One batch is
   repeated for cosine.  Then four batches of each backend at the
   narrowest and widest threshold run under ``torch.profiler`` and
   ``cProfile``: device time per kernel, host time per operator and Python
   function, and the device's idle share.
5. One JSON line with every kernel's numbers, then the result line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM (NVIDIA data sheet): fp32 outside the tensor cores, HBM3 rate
FP32_PEAK = 67e12
HBM_RATE = 3.35e12

BATCH = 512
ORACLE_QUERIES = 64
RTOL = ATOL = 1e-5  # as tests/test_kernels.py holds the reference kernels


def log(*args) -> None:
    print(*args, flush=True)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_RATE, n_ops / FP32_PEAK
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of one call, over ``iters`` calls after warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(torch, got, want) -> tuple[float, bool, bool]:
    """(max abs error over finite entries, same +inf pattern, within
    rtol/atol)."""
    same_inf = bool(torch.equal(torch.isinf(got), torch.isinf(want)))
    fin = torch.isfinite(want)
    diff = (got[fin] - want[fin]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    close = bool((diff <= ATOL + RTOL * want[fin].abs()).all())
    return err, same_inf, close


# the main path's shapes: a 512-query batch, 16 pivots, 112 dimensions,
# 101,504 padded corpus rows in 793 blocks of 128, 24 planes, query tile 128
MAIN_SHAPES = dict(q=512, p=16, k=112, n=101_504, m=24, b=793, bq=128, blk=128)


def check_kernels(torch, np, failures: list, dev, shapes=MAIN_SHAPES) -> dict:
    """Phase 3: every kernel against its plain version at main-path shapes."""
    from repro_torch.kernels import pairwise_dist as pdist
    from repro_torch.kernels import planar_exclusion as planar
    from repro_torch.kernels import ref

    rng = np.random.default_rng(0)
    out = {}
    q, p, k, n, m, b, bq, blk = (shapes[s] for s in ("q", "p", "k", "n", "m", "b", "bq", "blk"))

    def normal(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev)

    # query -> pivot distances (Q x P)
    x, piv = normal(q, k), normal(p, k)
    got = pdist.pairwise_l2_kernel_call(x, piv)
    want = ref.pairwise_l2_ref(x, piv)
    err, same_inf, close = compare(torch, got, want)
    nb, no = bound_ms(4 * (q * k + p * k + q * p), 2 * q * p * k + 2 * (q + p) * k + 4 * q * p)
    out["pairwise_l2"] = dict(
        name="pairwise_l2", route="cuda", source="src/repro_torch/csrc/pairwise_dist.cu",
        replaces="src/repro/kernels/pairwise_dist.py:140", max_abs_err=err,
        ms=time_ms(torch, lambda: pdist.pairwise_l2_kernel_call(x, piv), 200),
        plain_ms=time_ms(torch, lambda: ref.pairwise_l2_ref(x, piv), 200),
        bound_ms=nb, bound_by=no,
        library_ms=time_ms(torch, lambda: torch.cdist(x, piv), 200),
    )
    if not (same_inf and close):
        failures.append(f"pairwise_l2 disagrees with its plain version (max abs err {err})")

    # planar bound (Q x B), one degenerate plane and one padded block
    d1 = torch.as_tensor(np.abs(rng.normal(size=(q, m))).astype(np.float32) + 1.0, device=dev)
    d2 = (d1 + normal(q, m) * 0.2).abs()
    deltas = torch.as_tensor(np.abs(rng.normal(size=m)).astype(np.float32) + 0.5, device=dev)
    deltas[3] = 0.0
    lo = rng.normal(size=(b, m, 2))
    hi = lo + np.abs(rng.normal(size=(b, m, 2)))
    boxes_np = np.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]], -1).astype(np.float32)
    boxes_np[-1] = np.array([3.0e38, 3.1e38, 3.0e38, 3.1e38], np.float32)
    boxes = torch.as_tensor(boxes_np, device=dev)
    got = planar.planar_lower_bound_kernel_call(d1, d2, deltas, boxes)
    want = ref.planar_lower_bound_ref(d1, d2, deltas, boxes)
    err, same_inf, _ = compare(torch, got, want)
    nb, no = bound_ms(4 * (2 * q * m + m + 4 * b * m + q * b), 12 * q * b * m + 10 * q * m + q * b)
    out["planar_lower_bound"] = dict(
        name="planar_lower_bound", route="cuda",
        source="src/repro_torch/csrc/planar_exclusion.cu",
        replaces="src/repro/kernels/planar_exclusion.py:105", max_abs_err=err,
        ms=time_ms(torch, lambda: planar.planar_lower_bound_kernel_call(d1, d2, deltas, boxes), 200),
        plain_ms=time_ms(torch, lambda: ref.planar_lower_bound_ref(d1, d2, deltas, boxes), 50),
        bound_ms=nb, bound_by=no, library_ms=None,
    )
    padded_inf = bool(torch.isinf(got[:, -1]).all())
    if not (same_inf and err == 0.0 and padded_inf):
        failures.append(
            f"planar_lower_bound is not bit-equal to its plain version "
            f"(max abs err {err}, same inf {same_inf}, padded block inf {padded_inf})"
        )

    # masked exact phase (Q x n_pad), ~30% live tiles, one all-dead tile row
    y = normal(n, k)
    mask_np = rng.random((-(-q // bq), -(-n // blk))) < 0.3
    mask_np[1] = False
    mask = torch.as_tensor(mask_np, device=dev)
    got = pdist.masked_pairwise_l2_kernel_call(x, y, mask, bm=bq, bn=blk)
    want = ref.masked_pairwise_l2_ref(x, y, mask, bq, blk)
    err, same_inf, close = compare(torch, got, want)
    live = int(mask_np.sum()) * bq * blk
    rows = int(mask_np.any(axis=1).sum()) * bq
    cols = int(mask_np.any(axis=0).sum()) * blk
    nb, no = bound_ms(4 * (rows * k + cols * k + q * n + mask_np.size), 2 * live * k)
    out["masked_pairwise_l2"] = dict(
        name="masked_pairwise_l2", route="cuda", source="src/repro_torch/csrc/pairwise_dist.cu",
        replaces="src/repro/kernels/pairwise_dist.py:168", max_abs_err=err,
        ms=time_ms(torch, lambda: pdist.masked_pairwise_l2_kernel_call(x, y, mask, bm=bq, bn=blk)),
        plain_ms=time_ms(torch, lambda: ref.masked_pairwise_l2_ref(x, y, mask, bq, blk)),
        bound_ms=nb, bound_by=no,
        library_ms=time_ms(torch, lambda: torch.cdist(x, y)),
    )
    if not (same_inf and close):
        failures.append(
            f"masked_pairwise_l2 disagrees with its plain version "
            f"(max abs err {err}, same inf pattern {same_inf})"
        )
    for rec in out.values():
        log(f"kernel {rec['name']}: max_abs_err {rec['max_abs_err']} ms {rec['ms']:.5f} "
            f"plain_ms {rec['plain_ms']:.5f} library_ms {rec['library_ms']} "
            f"bound_ms {rec['bound_ms']:.5f} ({rec['bound_by']})")
    return out


def boundary_hit_diffs(np, pairwise_np, corpus, queries, a, b, t) -> tuple[int, list]:
    """Hits in one list and not the other, and those of them farther than
    1e-5 * max(1, t) from t in float64 (which are faults)."""
    n_diff, bad = 0, []
    for qi, (ha, hb) in enumerate(zip(a, b)):
        if ha == hb:
            continue
        diff = sorted(set(ha) ^ set(hb))
        if not diff and ha != hb:
            bad.append((qi, "order"))
            continue
        n_diff += len(diff)
        d = pairwise_np("l2", queries[qi], corpus[diff])[0]
        far = np.abs(d - t) > 1e-5 * max(1.0, t)
        bad += [(qi, i) for i, f in zip(diff, far) if f]
    return n_diff, bad


def run_queries(flat_index, EngineOpts, index, queries, t, backend):
    """All queries in batches of ``BATCH``: hit lists, per-query distance
    counts, per-query excluded blocks and each batch's live (query tile x
    block) cells, the tiles its exact phase computed."""
    hits, dists, excluded, tiles = [], [], [], []
    for s in range(0, len(queries), BATCH):
        h, st = flat_index.bss_query_batched(
            index, queries[s:s + BATCH], t, opts=EngineOpts(backend=backend)
        )
        hits += h
        dists.append(st["per_query_dists"])
        excluded.append(st["excluded"]["hilbert"])
        tiles.append(st["tiles_computed"])
    return hits, dists, excluded, tiles


def profile_batches(torch, flat_index, EngineOpts, index, queries, t, backend,
                    n_batches: int = 4) -> dict:
    """Where the time of ``n_batches`` main-path batches goes: host wall
    time without and with ``torch.profiler``; device time per kernel (the
    device's own events, so an operator and its kernel are not counted
    twice); host time per PyTorch operator and CUDA runtime call; and,
    from a ``cProfile`` pass, host time per Python function."""
    import cProfile
    import pstats
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = [queries[s:s + BATCH] for s in range(0, n_batches * BATCH, BATCH)]

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for qb in batches:
            flat_index.bss_query_batched(index, qb, t, opts=EngineOpts(backend=backend))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def short(name):
        name = re.sub(r"^void |\(anonymous namespace\)::|at::native::", "", name)
        name = name.split("(")[0]
        return name if len(name) <= 60 else name.split("<")[0][:60]

    def top(d, n=10):
        return {k: round(v / n_batches, 5) for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]}

    wall_ms = min(run() for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = run()
    device, host = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            device[short(e.key)] = device.get(short(e.key), 0.0) + e.self_device_time_total / 1e3
        elif e.self_cpu_time_total > 0:
            host[e.key] = e.self_cpu_time_total / 1e3
    busy_ms = sum(device.values())

    prof_py = cProfile.Profile()
    prof_py.enable()
    run()
    prof_py.disable()
    python = {  # built-ins carry the file name "~"
        fn if file == "~" else f"{Path(file).name}:{fn}": tottime * 1e3
        for (file, _, fn), (_, _, tottime, _, _) in pstats.Stats(prof_py).stats.items()
    }

    return dict(
        batches=n_batches, t=t, batch_ms=wall_ms / n_batches,
        traced_batch_ms=traced_ms / n_batches,
        device_busy_ms_per_batch=busy_ms / n_batches if device else "not measured",
        device_idle_share=1.0 - busy_ms / traced_ms if device else "not measured",
        device_ms_per_batch_by_kernel=top(device),
        host_ms_per_batch_by_operator=top(host),
        host_ms_per_batch_by_python_function=top(python, 12),
    )


def main_path(torch, np, failures: list, record: dict, dev, cfg=None,
              backend: str = "cuda") -> dict:
    """Phase 4: SISAP colors at paper size through the cuda backend."""
    from repro_torch.configs.supermetric import SISAP_COLORS, build_index, load_corpus
    from repro_torch.core import flat_index
    from repro_torch.core.backends import EngineOpts
    from repro_torch.core.npdist import pairwise_np
    from repro_torch.data.metricsets import calibrate_threshold
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.tiles import TILE_BQ

    cfg = cfg or SISAP_COLORS
    t0 = time.perf_counter()
    corpus, queries = load_corpus(cfg)
    corpus32, queries32 = corpus.astype(np.float32), queries.astype(np.float32)
    log(f"corpus {corpus.shape} queries {queries.shape} in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    index = build_index(cfg, corpus, device=dev)
    _ = index.device
    torch.cuda.synchronize()
    log(f"build_bss: n_pad {index.data.shape[0]} blocks {index.n_blocks} "
        f"planes {index.pairs.shape[0]} in {time.perf_counter() - t0:.2f} s")
    ts = [calibrate_threshold("l2", corpus, s) for s in cfg.selectivities]
    log(f"thresholds (selectivity -> t): {dict(zip(cfg.selectivities, ts))}")
    nb = index.n_blocks
    nq = len(queries)

    # warm-up (first launches load the libraries), not counted
    flat_index.bss_query_batched(index, queries[:BATCH], ts[0], opts=EngineOpts(backend=backend))
    torch.cuda.synchronize()

    reset_launch_counts()
    cuda_runs = []
    for t in ts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = run_queries(flat_index, EngineOpts, index, queries, t, backend)
        torch.cuda.synchronize()
        cuda_runs.append((run, time.perf_counter() - t0))
    counts = launch_counts()
    log(f"main path launch counts: {counts}")

    # bounds of both backends, to judge alive cells that differ
    mirror = index.device
    qe = torch.as_tensor(queries32, device=index.torch_device)
    lb = {}
    for name in (backend, "torch"):
        lb[name] = torch.cat([
            flat_index._fused_lower_bounds(
                "l2", qe[s:s + BATCH], mirror.pivots, mirror.pairs, mirror.deltas,
                mirror.boxes, backend=name,
            ) for s in range(0, nq, BATCH)
        ]).cpu().numpy()

    total_hits = 0
    n_batches = -(-nq // BATCH)
    qtiles = sum(-(-min(BATCH, nq - s) // TILE_BQ) for s in range(0, nq, BATCH))
    n_pad, dim = index.data.shape
    for t, sel, ((hits, dists, excl, tiles), secs) in zip(ts, cfg.selectivities, cuda_runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_hits, _, _, _ = run_queries(flat_index, EngineOpts, index, queries, t, "torch")
        torch.cuda.synchronize()
        plain_secs = time.perf_counter() - t0
        alive_c, alive_p = lb[backend] <= np.float32(t), lb["torch"] <= np.float32(t)
        alive_diff = alive_c != alive_p
        bad_alive = int((np.abs(lb["torch"][alive_diff] - t) > 1e-5).sum())
        n_hit_diff, bad_hits = boundary_hit_diffs(
            np, pairwise_np, corpus32, queries32, hits, p_hits, t)
        o_hits, _ = flat_index.bss_query(index, queries[:ORACLE_QUERIES], t)
        n_or_diff, bad_or = boundary_hit_diffs(
            np, pairwise_np, corpus32, queries32, hits[:ORACLE_QUERIES], o_hits, t)
        dists = np.concatenate(dists)
        excl = np.concatenate(excl)
        n_hits = sum(len(h) for h in hits)
        # the exact phase's least time per batch at this run's live tiles:
        # queries, corpus and the (Q, n_pad) output once, 2 K flops per live
        # distance (``bound_ms``)
        exact_bound, exact_by = bound_ms(
            4 * (nq * dim + n_batches * n_pad * dim + nq * n_pad) / n_batches,
            2 * sum(tiles) * TILE_BQ * index.block * dim / n_batches,
        )
        row = dict(
            selectivity=sel, t=t, queries=nq, seconds=secs, queries_per_s=nq / secs,
            plain_torch_queries_per_s=nq / plain_secs, hits=n_hits,
            dists_per_query=float(dists.mean()),
            block_exclusion_rate=float(excl.sum() / (nq * nb)),
            tile_exclusion_rate=1.0 - sum(tiles) / (qtiles * nb),
            exact_phase_bound_ms_per_batch=exact_bound, exact_phase_bound_by=exact_by,
            alive_boundary_diffs=int(alive_diff.sum()),
            hit_boundary_diffs_vs_torch=n_hit_diff,
            hit_boundary_diffs_vs_oracle=n_or_diff,
        )
        record.setdefault("l2", []).append(row)
        log("main path l2 " + json.dumps(row))
        if bad_alive or bad_hits or bad_or:
            failures.append(
                f"t={t}: {bad_alive} alive cells and {len(bad_hits) + len(bad_or)} "
                f"hits differ away from the threshold: {(bad_hits + bad_or)[:10]}"
            )
        if not np.isfinite(dists).all():
            failures.append(f"t={t}: non-finite distance counts")
        total_hits += n_hits

    if total_hits == 0:
        failures.append("the main path found no hits at any threshold")

    try:  # a failed profile fails the run but keeps the checks above
        for t in (ts[0], ts[-1]):
            for name in (backend, "torch"):
                prof = profile_batches(torch, flat_index, EngineOpts, index, queries, t, name)
                log(f"profile {name} " + json.dumps(prof))
    except Exception:
        failures.append(f"phase profile raised:\n{traceback.format_exc()}")

    # cosine: one batch on its own index, at the widest selectivity
    t0 = time.perf_counter()
    cindex = flat_index.build_bss("cosine", corpus, cfg.n_pivots, cfg.n_pairs, cfg.block,
                                  device=dev)
    tc = calibrate_threshold("cosine", corpus, max(cfg.selectivities))
    qb = queries32[:BATCH]
    c_hits, c_st = flat_index.bss_query_batched(cindex, qb, tc, opts=EngineOpts(backend=backend))
    p_hits, _ = flat_index.bss_query_batched(cindex, qb, tc, opts=EngineOpts(backend="torch"))
    o_hits, _ = flat_index.bss_query(cindex, qb[:ORACLE_QUERIES], tc)
    unit = qb / np.maximum(np.linalg.norm(qb, axis=1, keepdims=True), 1e-12)
    cunit = corpus32 / np.maximum(np.linalg.norm(corpus32, axis=1, keepdims=True), 1e-12)
    n_cd, bad_c = boundary_hit_diffs(np, pairwise_np, cunit, unit, c_hits, p_hits, tc)
    n_co, bad_co = boundary_hit_diffs(np, pairwise_np, cunit, unit, c_hits[:ORACLE_QUERIES],
                                      o_hits, tc)
    row = dict(t=tc, queries=len(qb), hits=sum(len(h) for h in c_hits),
               dists_per_query=c_st["dists_per_query"],
               block_exclusion_rate=c_st["block_exclusion_rate"],
               hit_boundary_diffs_vs_torch=n_cd, hit_boundary_diffs_vs_oracle=n_co,
               seconds_incl_build=time.perf_counter() - t0)
    record["cosine"] = row
    log("cosine batch " + json.dumps(row))
    if bad_c or bad_co or row["hits"] == 0:
        failures.append(f"cosine: hits differ away from the threshold: {(bad_c + bad_co)[:10]}")
    return counts


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch is missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        print(f"chip_smoke: needs compute capability (9, 0), got {cap}", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        print(f"chip_smoke: nvidia-smi failed: {smi.stderr.strip()}", file=sys.stderr)
        return 2
    log(smi.stdout.strip().splitlines()[0])
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is still enabled")

    from repro_torch.kernels import _build

    failures: list[str] = []
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {len(_build.SOURCES)} sources in {secs:.2f} s "
        f"(phase {time.perf_counter() - t0:.2f} s)")
    for name in _build.SOURCES:
        for line in _build.compiler_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    kernels, record = {}, {}
    dev = torch.device("cuda")
    for phase, fn in (("kernels", lambda: kernels.update(check_kernels(torch, np, failures, dev))),
                      ("main path", lambda: record.update(
                          counts=main_path(torch, np, failures, record, dev)))):
        try:
            fn()
        except Exception:  # report every phase, then fail
            failures.append(f"phase {phase} raised:\n{traceback.format_exc()}")
    counts = record.get("counts", {})
    for name, rec in kernels.items():
        rec["launches"] = int(counts.get(name, 0))
        if rec["launches"] <= 0:
            failures.append(f"kernel {name} was not launched on the main path")
    log(json.dumps({"kernels": [kernels[k] for k in sorted(kernels)]}))
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
