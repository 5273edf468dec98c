#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: the quickest proof that the port builds and serves on the card.

    python3 chip_smoke.py                # from the root of a checkout
    python3 chip_smoke.py --tiles-only   # only the tiles: the planar kernel,
                                         # JSD / Triangular small-distance
                                         # errors, and each metric's bound
                                         # phase and masked tile timed alone
    python3 chip_smoke.py --plain-l2     # only the plain "torch" l2 range
                                         # search over all queries

Phases (any failure is reported and the script exits non-zero; each
phase prints its seconds):

1. Require a CUDA device of compute capability 9.0; print the card's name
   and power limit (nvidia-smi), the SFU rate (16 results per SM per clock
   at the card's clocks.max.sm) and the instruction rates (128 issued and
   64 min / max per SM per clock), and set float32 matmuls to IEEE (no
   TF32).
2. Build every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per
   source, all at once) and print the build seconds and ptxas' report.
3. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, and time kernel, plain version, the library
   yardstick where one PyTorch call computes the same function
   (``torch.cdist`` for l2; the port never calls it; none for JSD and
   Triangular) and the least time the card could take (``bound_ms``: the
   larger of bytes over the HBM rate and operations over their rate; for
   JSD and Triangular one SFU result per live (i, j, k); for the planar
   bound its instructions per (query, block, plane) term at the issue rate
   of 128 per SM per clock).  The short kernels (the query -> pivot tiles,
   both forms of the planar bound) and their ``torch.cdist`` yardstick are
   timed on the device, as CUDA graphs of 100 launches; the rest between
   CUDA events around the Python call.  The masked JSD
   and Triangular tiles are checked after their range paths, at the
   live-tile share those paths gave them.  The JSD and Triangular tiles
   and their plain fp32 versions are held to float64 at small distances
   (near duplicates, K = 3, 16, 112): the kernel within the derived error
   budget, the rest printed.
4. The range paths: the SISAP colors configuration at paper size (101,414
   x 112 corpus, 11,268 queries), one index per metric built for the card,
   all queries through ``bss_query_batched(backend="cuda")`` in 512-query
   batches at the three thresholds calibrated per metric, under l2, JSD
   and Triangular, with every launch count zeroed just before each
   metric's run and read just after.  Checked against the plain
   ``"torch"`` backend on the same card (all queries under l2, the first
   2,048 under JSD and Triangular) and the numpy oracle on 16 queries: a hit that differs must lie within 1e-5 * max(1, t) of t in
   float64, an ``alive`` cell that differs must have its bound within 1e-5
   of t.  For JSD and Triangular, the largest |d_cuda - d_float64| over
   the first batch's cells within ``band_eps`` of each threshold is printed
   beside the derived error budget (csrc/prob_dist.cu) and the bf16
   margin's arithmetic term: a cell over budget fails the run, and so does
   twice the budget over the arithmetic term.  One l2 batch is repeated
   for cosine.  Four batches of each
   backend (one of the plain JSD and Triangular) run under
   ``torch.profiler`` and ``cProfile`` (l2 at the narrowest and widest
   threshold, JSD and Triangular at the widest):
   device time and trace events per kernel (sort kernels counted apart),
   host time per operator and Python function, and the device's idle
   share.  Each metric's masked tile of the first batch at the widest
   threshold is then timed alone with CUDA events on the inputs and mask
   the engine gave it (fp32 here, bf16 in phase 6), beside the bound of
   that mask, the SM clock and power nvidia-smi reads meanwhile, and a
   sha256 of its output (bit-equality with another commit).
5. kNN (k = 10): all queries in 512-query batches through
   ``bss_knn_batched`` under l2, JSD and Triangular on ``"cuda"``, plus one
   cosine batch; launch counts zeroed and read per metric.  The plain
   ``"torch"`` backend runs the first four batches (2,048 queries).  Ids must agree
   between backends and with a float64 brute force on 16 queries, except
   where the two candidates' float64 distances lie within 1e-5 of each
   other (or of the kth); a query whose distance count differs between
   backends must have kth distances within 1e-5.  For JSD and Triangular
   the returned distances of 16 queries are held to float64 within the
   error budget, which is also printed at the smallest kth.  The round
   top-k of the first batch is timed alone per round, beside the stable
   sort it replaced.  One JSD batch on ``"cuda"`` is profiled.
6. bf16 range: ``precision="bf16"`` over all queries on ``"cuda"`` under l2,
   JSD and Triangular at selectivities 1e-5 and 1e-3, through each
   metric's range-path index; launch counts zeroed and read per metric.
   Hits, ``alive``, ``per_query_dists``, ``excluded["hilbert"]`` and
   ``tiles_computed`` must equal the fp32 ``"cuda"`` pass of phase 4
   exactly, and ``"torch"`` bf16 must equal ``"torch"`` fp32 exactly on
   two batches.  Prints ``band_eps``, the re-checked share of the computed
   tiles, the re-checked points per query, queries/s and one profile per
   metric.  The bf16 mirror must hold ``bf16_round_np(index.data)`` bit
   for bit.
7. The six bf16-corpus kernels against their plain versions fed the same
   bf16 ``y``, at the main path's shapes, the masked ones at their bf16
   range path's live-tile share.
8. bf16 kNN (k = 10) under l2 and JSD over all queries on ``"cuda"``: ids,
   distances, rounds and ``per_query_dists`` must equal phase 5's fp32
   ``"cuda"`` run exactly.
9. The living corpus under l2 and JSD at paper size on ``"cuda"``: build on
   the first 90% of the corpus rows, ``append`` the other 10%, ``delete``
   1% of the ids (seeded); at each generation range (selectivity 1e-3)
   and kNN on two batches in fp32 and bf16, bf16 equal to fp32 exactly and
   fp32 range held to the numpy oracle on 16 queries; then
   ``compact(refresh_pivots=True)`` must equal a fresh ``build_bss`` over
   the live rows field for field, and so must its hits.  Prints each
   mutation's seconds and ``table_dists``.
10. Serving: ``RetrievalServer`` on the card (l2, built on 99% of the
   corpus with the configuration's settings) and its ``async_front``
   (ladder 8, 32, 128, 512; ``max_delay_s`` 0.002; ``cache_size`` 4,096):
   two waves of one request per query from 8 client threads (range at the
   three thresholds, every 4th request kNN, every 16th bf16, 1% sent
   again), the last 1% of the rows appended and 100 ids deleted between
   them, the second wave under ``torch.profiler`` after a warm-up step;
   then a JSD server's 2,048 range requests.  Launch counts zeroed before
   and read after each server's waves.  Every result is held against
   direct ``"cuda"`` calls on the generation it names (``check_served``).
   Prints requests/s, p50 / p99 of latency, queue wait and engine time,
   batches by bucket, padding waste, cache hits and the device's idle
   share.  A difference, a failed future, a path kernel not launched, a
   recompile, or a problem in the exposition or the trace fails the run.
11. The forest (``repro_torch.forest``), l2: the paper's ``hpt_fft_log``
   tree of the corpus (``build_index(engine="tree")``, encoded for the
   card; build and encode seconds, levels, nodes, leaves), all queries in
   512-query batches at the three l2 thresholds under Hilbert on
   ``"cuda"``, the first 2,048 on ``"torch"`` too and 16 against the
   numpy host walk: a hit that differs must lie within 1e-5 * max(1, t)
   of t in float64, and a query whose ``per_query_dists`` differ must
   have, on its float64 host walk, a predicate within 1e-5 of its
   threshold (``tree_margin``; both kinds are counted).  The middle
   threshold again under Hyperbolic.  Prints queries/s,
   ``dists_per_query`` beside BSS's at the same thresholds, exclusion
   attribution and frontier occupancy per query; four batches of each
   backend profiled.
12. Forest bf16: ``precision="bf16"`` at selectivities 1e-5 and 1e-3 over
   all queries: hits, ``per_query_dists``, ``excluded`` and the frontier
   equal to phase 11's fp32 runs bit for bit; the re-checked share.
13. Forest monotone: the ``lrt`` / ``far`` tree
   (``build_index(engine="lrt")``), all queries at the widest l2
   threshold, held as in phase 11 (``monotone_margin``).
14. Forest JSD: ``hpt_fft_log`` under JSD, 2,048 queries at the widest
   JSD threshold, held as in phase 11, and the leaf table's cells near t
   within the error budget (``prob_error_near_t``).
15. Serving forest: ``RetrievalServer(index="forest", metric="l2")`` and
   its front: one wave of 2,048 range requests at the three thresholds
   (every 16th bf16) from 8 client threads, every result equal to a
   direct ``forest_range_search`` on the batch the front formed, every
   field; a kNN request must raise ``FOREST_KNN_ERROR``.  Launch counts
   are zeroed before and read after each forest phase.
16. Sharded BSS (``repro_torch.parallel``), every result against the
   single-device ``"cuda"`` runs of phases 4-5 bit for bit, S shards on
   ``local_mesh(S)`` (all on ``cuda:0`` on a one-card machine): range
   under l2, JSD and Triangular at S = 2, 4, 8 over all queries at the
   three thresholds (hits, the bounds through the shards and so
   ``alive``, ``per_query_dists``, ``excluded``, ``tiles_computed``; every
   batch's ``shard_dists`` summing to its exact-phase work; queries/s
   beside the single device's, ``shard_imbalance``); bf16 range at 1e-3
   on 4 shards equal to the 4-shard fp32 run; kNN (l2, JSD at S = 2, 4, 8;
   bf16 l2 at S = 4) equal in ids, distances, rounds and counts; the
   living corpus on 4 shards (an append into the padding in place, with no
   library loaded again and nothing reshaped, a 1% append that re-lays
   the shards out, a delete, a compact) against a single-device index put
   through the same mutations; one wave of 2,048 requests through the
   front of ``RetrievalServer(mesh=local_mesh(4))``, each against a direct
   sharded call on its batch; four profiled batches of S = 1 and S = 4
   (l2, JSD at 1e-3); one shard per card where the host has two or more
   (said to be skipped otherwise; a skip is no pass).
17. One JSON line with every kernel's numbers (``launches`` from the range
   path of its metric and precision, ``serving_launches`` from the serving
   phase, ``forest_launches`` from the forest phases, which must have
   launched the masked l2, bf16 l2 and JSD tiles, ``sharded_launches``
   from the sharded phases, nonzero for every kernel a shard launches;
   the unmasked bf16 forms and the d1/d2 form of the planar bound are on
   no engine path and carry ``"on_main_path": false``), then the result
   line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
import subprocess
import sys
import time
import traceback
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM (NVIDIA data sheet): fp32 outside the tensor cores, HBM3 rate
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
# The work of a JSD / Triangular tile is one transcendental (lg2, rcp) per
# live (i, j, k), on the special function units: 16 results per SM per clock
# on compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput).  main() sets CARD["sfu_rate"] from the SM count
# and nvidia-smi's clocks.max.sm: 132 x 16 x 1,980 MHz = 4.18e12/s.
SFU_PER_SM_CLOCK = 16
# Instruction rates per SM per clock on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput): four schedulers
# issue one warp instruction a clock each, 128 lanes, the fp32 add and
# multiply rate; min / max runs at 64.  The planar kernel
# (csrc/planar_exclusion.cu) issues 9.5 instructions per (query, block,
# plane) term, 2.5 of them DPX integer max.  main() sets CARD["issue_rate"]
# and CARD["minmax_rate"] (lane instructions per second) from the SM count
# and clocks.max.sm.
ISSUE_PER_SM_CLOCK, MINMAX_PER_SM_CLOCK = 128, 64
PLANAR_ISSUED, PLANAR_MINMAX = 9.5, 2.5
CARD: dict = {}

BATCH = 512
# Depth of the comparisons cut to make room for the sharded phases (16)
# and keep the run under 600 s on the slowest host seen (PERF.md §4): the
# float64 oracles take 16 queries (64 before); the plain "torch" range
# comparison of JSD and Triangular and every plain kNN comparison their
# first 4 batches
ORACLE_QUERIES = 16
PLAIN_QUERIES = 4 * BATCH
KNN_K = 10  # as benchmarks/bss_engine.py runs kNN
RTOL = ATOL = 1e-5  # as tests/test_kernels.py holds the reference kernels
# the reference's sweep of the unmasked JSD / Triangular tiles
# (tests/test_kernels.py:91-124); the masked family is held at 1e-5
PROB_RTOL, PROB_ATOL = 1e-4, 1e-5
BAND = 1e-5  # fp32 summation order may move a distance this close to t


def log(*args) -> None:
    print(*args, flush=True)


def bound_ms(n_bytes: float, n_ops: float, rate: float = FP32_PEAK) -> tuple[float, str]:
    """The least time: bytes over the HBM rate or operations over ``rate``
    (fp32 peak, or the SFU rate for the JSD / Triangular tiles)."""
    t_bytes, t_ops = n_bytes / HBM_RATE, n_ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def planar_bound_ms(q: int, m: int, b: int, in_bytes: int) -> tuple[float, str]:
    """The planar bound's least time: its inputs and the (Q, B) output once
    over the HBM rate, or its Q x B x M terms at the instruction rates
    (every instruction takes an issue slot; the integer max also at its
    own rate)."""
    terms = q * b * m
    t_ops = max(PLANAR_ISSUED * terms / CARD["issue_rate"],
                PLANAR_MINMAX * terms / CARD["minmax_rate"])
    t_bytes = (in_bytes + 4 * q * b) / HBM_RATE
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters: int = 20) -> float:
    """Mean time of one call, over ``iters`` calls after warm-up, between
    CUDA events: the device's time for long kernels, the host's launch rate
    for short ones (``device_ms`` then)."""
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


def device_ms(torch, fn, n: int = 100, replays: int = 10) -> float:
    """Device time of one call of a short kernel: ``n`` calls captured in
    one CUDA graph, the graph replayed ``replays`` times between CUDA
    events.  The host's launch rate (argument checks, ctypes, allocation)
    is out of the time; what is left per call is the kernel and the
    device's gap between two graph nodes.  ``fn`` must be capturable: no
    synchronisation, no host reads."""
    for _ in range(3):  # outside the capture: load the library, set attributes
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (n * replays)
    del graph
    return ms


def kernel_event_ms(torch, fn, name: str, n: int = 50) -> tuple[float, int]:
    """(mean device duration of the trace's events whose name contains
    ``name``, their count) over ``n`` calls of ``fn`` under torch.profiler:
    the kernel alone, without the gap between launches.  The count should
    be ``n``; the trace may drop events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and name in e.key:
            total += e.self_device_time_total / 1e3
            count += e.count
    return (total / count if count else float("nan")), count


def compare(torch, got, want, rtol=RTOL, atol=ATOL) -> tuple[float, bool, bool]:
    """(max abs error over finite entries, same +inf pattern, within
    rtol/atol)."""
    same_inf = bool(torch.equal(torch.isinf(got), torch.isinf(want)))
    fin = torch.isfinite(want)
    diff = (got[fin] - want[fin]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    close = bool((diff <= atol + rtol * want[fin].abs()).all())
    return err, same_inf, close


def simplex(np, rng, n, k):
    """(n, k) float32 probability rows like colour histograms: sparse gamma
    draws with a third of the bins exactly zero and some at 1e-13 and 1e-9,
    so the xlogx guard at 1e-12 and the x + y floor are exercised."""
    x = rng.gamma(0.3, size=(n, k))
    x[rng.random((n, k)) < 0.33] = 0.0
    tiny = rng.random((n, k))
    x[tiny < 0.05] = 1e-13
    x[(tiny >= 0.05) & (tiny < 0.1)] = 1e-9
    x[:, 0] += 1e-3  # no all-zero row
    return (x / x.sum(axis=1, keepdims=True)).astype(np.float32)


# the main path's shapes: a 512-query batch, 16 pivots, 112 dimensions,
# 101,504 padded corpus rows in 793 blocks of 128, 24 planes, query tile 128
MAIN_SHAPES = dict(q=512, p=16, k=112, n=101_504, m=24, b=793, bq=128, blk=128)

# the port's kernels, by the names a trace gives them
PORT_KERNELS = ("l2_tile_kernel", "prob_tile_kernel", "planar_lb_kernel")

# metric -> unmasked C entry point of its tile
PROB = {"jsd": "pairwise_jsd", "triangular": "pairwise_tri"}
SOURCE = {"pairwise_l2": "src/repro_torch/csrc/pairwise_dist.cu",
          "pairwise_jsd": "src/repro_torch/csrc/prob_dist.cu",
          "pairwise_tri": "src/repro_torch/csrc/prob_dist.cu"}
# the pallas_call each tile replaces: pairwise_dist.py's unmasked and
# masked calls, around _l2_tile_kernel, _jsd_tile_kernel (jsd_dist.py:50)
# or _tri_tile_kernel (tri_dist.py:41)
REPLACES = ("src/repro/kernels/pairwise_dist.py:140", "src/repro/kernels/pairwise_dist.py:168")


def _row(failures, name, entry, masked, err, ok, **numbers) -> dict:
    if not ok:
        failures.append(f"{name} disagrees with its plain version (max abs err {err})")
    return dict(name=name, route="cuda", source=SOURCE[entry],
                replaces=REPLACES[int(masked)], max_abs_err=err, **numbers)


def planar_inputs(torch, np, dev, shapes=MAIN_SHAPES):
    """(dqp, pairs, d1, d2, deltas, boxes) at the bound phase's shapes: a
    (Q, P) query -> pivot matrix, M int64 pairs of distinct pivots, d1 and
    d2 gathered by them, one degenerate plane and the last block padded with
    the 3e38 sentinel boxes."""
    rng = np.random.default_rng(4)
    q, p, m, b = (shapes[s] for s in ("q", "p", "m", "b"))
    dqp_np = (np.abs(rng.normal(size=(q, p))) + 1.0).astype(np.float32)
    first = rng.integers(0, p, size=m)
    pairs_np = np.stack([first, (first + rng.integers(1, p, size=m)) % p], 1)
    deltas = np.abs(rng.normal(size=m)).astype(np.float32) + 0.5
    deltas[3] = 0.0
    lo = rng.normal(size=(b, m, 2))
    hi = lo + np.abs(rng.normal(size=(b, m, 2)))
    boxes = np.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]], -1).astype(np.float32)
    boxes[-1] = np.array([3.0e38, 3.1e38, 3.0e38, 3.1e38], np.float32)
    d1, d2 = (np.ascontiguousarray(dqp_np[:, pairs_np[:, i]]) for i in (0, 1))
    return tuple(torch.as_tensor(a, device=dev)
                 for a in (dqp_np, pairs_np.astype(np.int64), d1, d2, deltas, boxes))


def planar_alone(torch, np, dev, shapes=MAIN_SHAPES) -> dict:
    """``--tiles-only``: the planar kernel at the main path's shapes through
    its d1/d2 form (which every commit of the port has), timed on the device
    (CUDA graph, and the trace's kernel events), beside its bound and a
    sha256 of its output; and again with twice the planes, so the slope is
    the cost of 24 more planes and the intercept at M = 0 the fixed cost of
    a launch (staging, projection, output)."""
    from repro_torch.kernels import planar_exclusion as planar

    q, m, b = (shapes[s] for s in ("q", "m", "b"))
    out = {}
    for planes in (m, 2 * m):
        _, _, d1, d2, deltas, boxes = planar_inputs(torch, np, dev, dict(shapes, m=planes))

        def fn():
            return planar.planar_lower_bound_kernel_call(d1, d2, deltas, boxes)

        event_ms, events = kernel_event_ms(torch, fn, "planar_lb_kernel")
        if planes == m:
            nb, by = planar_bound_ms(q, m, b, 4 * (2 * q * m + m + 4 * b * m))
            out.update(shape_q_b_m=[q, b, m], graph_ms=device_ms(torch, fn, 200),
                       kernel_event_ms=event_ms, kernel_events=events, bound_ms=nb,
                       bound_by=by, share_of_bound=nb / event_ms,
                       output_sha256=hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest())
        else:
            out[f"kernel_event_ms_m={planes}"] = event_ms
    out["ms_per_m_planes"] = out[f"kernel_event_ms_m={2 * m}"] - out["kernel_event_ms"]
    out["fixed_ms"] = out["kernel_event_ms"] - out["ms_per_m_planes"]
    log("planar alone " + json.dumps(out))
    return out


def bound_phase_alone(torch, index, queries, metric: str) -> dict:
    """``--tiles-only``: the bound phase of one main-path batch (the first
    512 queries) as the engine launches it (``_fused_lower_bounds`` on
    ``"cuda"``): the port's launches, every kernel in its trace, its device
    ms (CUDA graph) and a sha256 of the bound ``lb``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import flat_index
    from repro_torch.kernels import launch_counts, reset_launch_counts

    dev = index.device
    qd = torch.as_tensor(flat_index._engine_queries(metric, queries[:BATCH]),
                         device=index.torch_device)
    eng = flat_index._engine_metric(metric)

    def fn():
        return flat_index._fused_lower_bounds(eng, qd, dev.pivots, dev.pairs, dev.deltas,
                                              dev.boxes, backend="cuda")

    fn()
    torch.cuda.synchronize()
    reset_launch_counts()
    lb = fn()
    launches = {k: v for k, v in launch_counts().items() if v}
    # a warm-up step traced and thrown away, then 5 calls: each kernel of
    # the phase should show 5 events (a trace can drop some)
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        for _ in range(2):
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            prof.step()
    kernels: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not e.key.startswith("ProfilerStep"):
            kernels[kernel_name(e.key)] = kernels.get(kernel_name(e.key), 0) + e.count
    out = dict(shape=list(lb.shape), launches=launches, trace_kernels_in_5_calls=kernels,
               device_ms=device_ms(torch, fn),
               lb_sha256=hashlib.sha256(lb.cpu().numpy().tobytes()).hexdigest())
    log(f"bound phase alone {metric}: " + json.dumps(out))
    return out


def check_kernels(torch, np, failures: list, dev, shapes=MAIN_SHAPES) -> dict:
    """Phase 3: every unmasked kernel and the masked l2 tile against its
    plain version at main-path shapes."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import pairwise_dist as pdist
    from repro_torch.kernels import planar_exclusion as planar

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
    out["pairwise_l2"] = _row(
        failures, "pairwise_l2", "pairwise_l2", False, err, same_inf and close,
        ms=device_ms(torch, lambda: pdist.pairwise_l2_kernel_call(x, piv)),
        plain_ms=time_ms(torch, lambda: ref.pairwise_l2_ref(x, piv), 200),
        bound_ms=nb, bound_by=no,
        library_ms=device_ms(torch, lambda: torch.cdist(x, piv)),
    )

    # planar bound (Q x B), both forms on the same inputs
    dqp, pairs, d1, d2, deltas, boxes = planar_inputs(torch, np, dev, shapes)
    for name, fn, in_bytes in (
            ("planar_lower_bound", lambda: planar.planar_lower_bound_kernel_call(
                d1, d2, deltas, boxes), 4 * 2 * q * m),
            ("planar_lower_bound_pairs", lambda: planar.planar_lower_bound_pairs_kernel_call(
                dqp, pairs, deltas, boxes), 4 * q * p + 8 * 2 * m)):
        got = fn()
        want = ref.planar_lower_bound_ref(d1, d2, deltas, boxes)
        err, same_inf, _ = compare(torch, got, want)
        nb, no = planar_bound_ms(q, m, b, in_bytes + 4 * (m + 4 * b * m))
        out[name] = dict(
            name=name, route="cuda", source="src/repro_torch/csrc/planar_exclusion.cu",
            replaces="src/repro/kernels/planar_exclusion.py:105", max_abs_err=err,
            ms=device_ms(torch, fn),
            plain_ms=time_ms(torch, lambda: ref.planar_lower_bound_ref(d1, d2, deltas, boxes), 50),
            bound_ms=nb, bound_by=no, library_ms=None,
            output_sha256=hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest(),
        )
        bit_equal = same_inf and bool(torch.equal(got, want))
        padded_inf = bool(torch.isinf(got[:, -1]).all())
        if not (bit_equal and padded_inf):
            failures.append(
                f"{name} is not bit-equal to its plain version (max abs err {err}, "
                f"same inf {same_inf}, padded block inf {padded_inf})"
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
    out["masked_pairwise_l2"] = _row(
        failures, "masked_pairwise_l2", "pairwise_l2", True, err, same_inf and close,
        ms=time_ms(torch, lambda: pdist.masked_pairwise_l2_kernel_call(x, y, mask, bm=bq, bn=blk)),
        plain_ms=time_ms(torch, lambda: ref.masked_pairwise_l2_ref(x, y, mask, bq, blk)),
        bound_ms=nb, bound_by=no,
        library_ms=time_ms(torch, lambda: torch.cdist(x, y)),
    )

    # JSD / Triangular query -> pivot tiles (Q x P) on simplex rows
    xs, pivs = (torch.as_tensor(simplex(np, rng, r, k), device=dev) for r in (q, p))
    for metric, entry in PROB.items():
        plain = ref.pairwise_jsd_ref if metric == "jsd" else ref.pairwise_tri_ref
        got = pdist.pairwise_kernel_call(metric, xs, pivs)
        err, same_inf, close = compare(torch, got, plain(xs, pivs), PROB_RTOL, PROB_ATOL)
        nb, no = bound_ms(4 * (q * k + p * k + q * p), q * p * k, CARD["sfu_rate"])
        out[entry] = _row(
            failures, entry, entry, False, err, same_inf and close,
            ms=device_ms(torch, lambda: pdist.pairwise_kernel_call(metric, xs, pivs)),
            plain_ms=time_ms(torch, lambda: plain(xs, pivs), 50),
            bound_ms=nb, bound_by=no, library_ms=None,
        )

    # the standalone JSD entry point (jsd_dist.py:91) at the exact phase's
    # shapes: the same kernel as the query -> pivot tile, unmasked
    ys = torch.as_tensor(simplex(np, rng, n, k), device=dev)
    got = ops.pairwise_jsd(xs, ys)
    err, same_inf, close = compare(torch, got, ref.pairwise_jsd_ref(xs, ys), PROB_RTOL, PROB_ATOL)
    nb, no = bound_ms(4 * (q * k + n * k + q * n), q * n * k, CARD["sfu_rate"])
    out["ops.pairwise_jsd"] = dict(
        _row(failures, "ops.pairwise_jsd", "pairwise_jsd", False, err, same_inf and close,
             ms=time_ms(torch, lambda: ops.pairwise_jsd(xs, ys), 10),
             plain_ms=time_ms(torch, lambda: ref.pairwise_jsd_ref(xs, ys), 5),
             bound_ms=nb, bound_by=no, library_ms=None),
        replaces="src/repro/kernels/jsd_dist.py:91")
    for rec in out.values():
        log_kernel(rec)
    return out


def check_masked_prob(torch, np, failures: list, dev, live_share: dict,
                      shapes=MAIN_SHAPES) -> dict:
    """Phase 3, second half: the masked JSD / Triangular tiles at the
    exact phase's shapes and at the live-tile share their range path ran
    with (one all-dead tile row)."""
    from repro_torch.kernels import pairwise_dist as pdist
    from repro_torch.kernels import ref

    rng = np.random.default_rng(1)
    q, k, n, bq, blk = (shapes[s] for s in ("q", "k", "n", "bq", "blk"))
    x = torch.as_tensor(simplex(np, rng, q, k), device=dev)
    y = torch.as_tensor(simplex(np, rng, n, k), device=dev)
    out = {}
    for metric, entry in PROB.items():
        mask_np = rng.random((-(-q // bq), -(-n // blk))) < live_share[metric]
        mask_np[1] = False
        log(f"masked {metric}: live tile share {float(mask_np.mean()):.5f} (the range "
            f"path's {live_share[metric]:.5f}, one of {mask_np.shape[0]} tile rows dead)")
        mask = torch.as_tensor(mask_np, device=dev)
        dense = ref.pairwise_jsd_ref if metric == "jsd" else ref.pairwise_tri_ref

        def plain():
            return ref.masked_pairwise_metric_ref(dense(x, y), mask, bq, blk)

        got = pdist.masked_pairwise_kernel_call(metric, x, y, mask, bm=bq, bn=blk)
        err, same_inf, close = compare(torch, got, plain())
        live = int(mask_np.sum()) * bq * blk
        rows = int(mask_np.any(axis=1).sum()) * bq
        cols = int(mask_np.any(axis=0).sum()) * blk
        nb, no = bound_ms(4 * (rows * k + cols * k + q * n + mask_np.size), live * k,
                          CARD["sfu_rate"])
        out["masked_" + entry] = _row(
            failures, "masked_" + entry, entry, True, err, same_inf and close,
            ms=time_ms(torch, lambda: pdist.masked_pairwise_kernel_call(
                metric, x, y, mask, bm=bq, bn=blk), 10),
            plain_ms=time_ms(torch, plain, 5),
            bound_ms=nb, bound_by=no, library_ms=None,
        )
        log_kernel(out["masked_" + entry])
    return out


def log_kernel(rec: dict) -> None:
    log(f"kernel {rec['name']}: max_abs_err {rec['max_abs_err']} ms {rec['ms']:.5f} "
        f"plain_ms {rec['plain_ms']:.5f} library_ms {rec['library_ms']} "
        f"bound_ms {rec['bound_ms']:.5f} ({rec['bound_by']})")


def boundary_hit_diffs(np, pairwise_np, metric, corpus, queries, a, b, t) -> tuple[int, list]:
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
        d = pairwise_np(metric, queries[qi], corpus[diff])[0]
        far = np.abs(d - t) > BAND * max(1.0, t)
        bad += [(qi, i) for i, f in zip(diff, far) if f]
    return n_diff, bad


def run_queries(flat_index, EngineOpts, index, queries, t, backend, precision="fp32"):
    """All queries in batches of ``BATCH``: hit lists and each batch's
    stats."""
    hits, stats = [], []
    for s in range(0, len(queries), BATCH):
        h, st = flat_index.bss_query_batched(
            index, queries[s:s + BATCH], t,
            opts=EngineOpts(backend=backend, precision=precision),
        )
        hits += h
        stats.append(st)
    return hits, stats


def per_query(stats: list, key: str):
    """One per-query stats array over all batches (``excluded`` is read
    for the Hilbert mechanism)."""
    import numpy as np

    return np.concatenate([st["excluded"]["hilbert"] if key == "excluded" else st[key]
                           for st in stats])


def kernel_name(name: str) -> str:
    """A trace's kernel name without its return type, namespaces and
    arguments."""
    name = re.sub(r"^void |\(anonymous namespace\)::|at::native::", "", name)
    name = name.split("(")[0]
    return name if len(name) <= 60 else name.split("<")[0][:60]


def trace_device(prof) -> tuple[dict, dict]:
    """Device ms and event count per kernel in a ``torch.profiler`` trace:
    the device's own events, so an operator and its kernel are not counted
    twice; the profiler's step span is left out."""
    from torch.autograd import DeviceType

    device, launches = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith("ProfilerStep"):
            continue
        name = kernel_name(e.key)
        device[name] = device.get(name, 0.0) + e.self_device_time_total / 1e3
        launches[name] = launches.get(name, 0) + e.count
    return device, launches


def profile_batches(torch, batch_fn, queries, n_batches: int = 4, **tags) -> dict:
    """Where the time of ``n_batches`` main-path batches goes
    (``batch_fn(queries)`` runs one): host wall time without and with
    ``torch.profiler``; device time per kernel (the device's own events, so
    an operator and its kernel are not counted twice); host time per
    PyTorch operator and CUDA runtime call; and, from a ``cProfile`` pass,
    host time per Python function."""
    import cProfile
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import launch_counts

    batches = [queries[s:s + BATCH] for s in range(0, n_batches * BATCH, BATCH)]

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for qb in batches:
            batch_fn(qb)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def top(d, n=10):
        return {k: round(v / n_batches, 5) for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]}

    wall_ms = min(run() for _ in range(3))
    # one warm-up step traced and thrown away, so that the tracer is set up
    # before the step that counts
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        run()
        prof.step()
        before = sum(launch_counts().values())
        traced_ms = run()
        port_launches = sum(launch_counts().values()) - before
        prof.step()
    device, launches = trace_device(prof)
    host = {e.key: e.self_cpu_time_total / 1e3 for e in prof.key_averages()
            if e.device_type != DeviceType.CUDA and e.self_cpu_time_total > 0
            and not e.key.startswith("ProfilerStep")}
    port_events = sum(n for k, n in launches.items() if k.startswith(PORT_KERNELS))
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
        **tags, batches=n_batches, batch_ms=wall_ms / n_batches,
        traced_batch_ms=traced_ms / n_batches,
        device_busy_ms_per_batch=busy_ms / n_batches if device else "not measured",
        device_idle_share=1.0 - busy_ms / traced_ms if device else "not measured",
        device_ms_per_batch_by_kernel=top(device),
        # events the trace holds for those kernels, over all the batches:
        # a kernel launched once a batch should show ``n_batches``
        device_events_by_kernel={k: launches[k] for k in top(device)},
        # the port's kernels launched in the traced step (the wrappers'
        # counts) against the trace's events for them: a shortfall is
        # events the trace dropped, and the device times above are short
        port_kernel_launches=port_launches, port_kernel_events=port_events,
        # kernels of a sort (the kNN round top-k used one before its keys)
        sort_kernel_events=sum(n for k, n in launches.items() if "sort" in k.lower()),
        host_ms_per_batch_by_operator=top(host),
        host_ms_per_batch_by_python_function=top(python, 12),
    )


def expect_launches(failures: list, phase: str, counts: dict, want: dict) -> None:
    """Every named count equals its expectation; every other count is 0."""
    for name, got in counts.items():
        if got != want.get(name, 0):
            failures.append(f"{phase}: {name} launched {got} times, expected "
                            f"{want.get(name, 0)} ({counts})")


def load(np, cfg):
    from repro_torch.configs.supermetric import load_corpus

    t0 = time.perf_counter()
    corpus, queries = load_corpus(cfg)
    log(f"corpus {corpus.shape} queries {queries.shape} in {time.perf_counter() - t0:.2f} s")
    return corpus, queries


def range_path(torch, np, failures: list, record: dict, dev, corpus, queries, metric: str,
               cfg, backend: str = "cuda") -> dict:
    """Phase 4 for one metric: SISAP colors at paper size through the cuda
    backend.  Returns the metric's launch counts and its mean live-tile
    share at the widest threshold."""
    from repro_torch.configs.supermetric import build_index
    from repro_torch.core import flat_index
    from repro_torch.core.backends import EngineOpts
    from repro_torch.core.npdist import pairwise_np
    from repro_torch.data.metricsets import calibrate_threshold
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.tiles import TILE_BQ

    corpus32, queries32 = corpus.astype(np.float32), queries.astype(np.float32)
    t0 = time.perf_counter()
    index = build_index(dataclasses.replace(cfg, metric=metric), corpus, device=dev)
    _ = index.device
    torch.cuda.synchronize()
    log(f"build_bss {metric}: n_pad {index.data.shape[0]} blocks {index.n_blocks} "
        f"planes {index.pairs.shape[0]} in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    ts = [calibrate_threshold(metric, corpus, s) for s in cfg.selectivities]
    log(f"{metric} thresholds (selectivity -> t): {dict(zip(cfg.selectivities, ts))} "
        f"in {time.perf_counter() - t0:.2f} s")
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
    log(f"{metric} range path launch counts: {counts}")
    n_batches = -(-nq // BATCH)
    entry = PROB.get(metric, "pairwise_l2")
    per_form = len(ts) * n_batches
    expect_launches(failures, f"{metric} range path", counts,
                    {entry: per_form, "masked_" + entry: per_form,
                     "planar_lower_bound_pairs": per_form})

    # bounds of both backends, to judge alive cells that differ
    mirror = index.device
    qe = torch.as_tensor(queries32, device=index.torch_device)
    lb = {}
    for name in (backend, "torch"):
        lb[name] = torch.cat([
            flat_index._fused_lower_bounds(
                metric, qe[s:s + BATCH], mirror.pivots, mirror.pairs, mirror.deltas,
                mirror.boxes, backend=name,
            ) for s in range(0, nq, BATCH)
        ]).cpu().numpy()

    total_hits = 0
    qtiles = sum(-(-min(BATCH, nq - s) // TILE_BQ) for s in range(0, nq, BATCH))
    n_pad, dim = index.data.shape
    # l2: 2 fp32 operations per (i, j, k); JSD / Triangular: one SFU result
    ops_per, rate = (1, CARD["sfu_rate"]) if metric in PROB else (2, FP32_PEAK)
    live_share = 0.0
    n_plain = min(nq, PLAIN_QUERIES) if metric in PROB else nq
    for t, sel, ((hits, stats), secs) in zip(ts, cfg.selectivities, cuda_runs):
        dists, excl = per_query(stats, "per_query_dists"), per_query(stats, "excluded")
        tiles = [st["tiles_computed"] for st in stats]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_hits, _ = run_queries(flat_index, EngineOpts, index, queries[:n_plain], t, "torch")
        torch.cuda.synchronize()
        plain_secs = time.perf_counter() - t0
        alive_c, alive_p = lb[backend] <= np.float32(t), lb["torch"] <= np.float32(t)
        alive_diff = alive_c != alive_p
        bad_alive = int((np.abs(lb["torch"][alive_diff] - t) > BAND).sum())
        n_hit_diff, bad_hits = boundary_hit_diffs(
            np, pairwise_np, metric, corpus32, queries32, hits[:n_plain], p_hits, t)
        t0 = time.perf_counter()
        o_hits, _ = flat_index.bss_query(index, queries[:ORACLE_QUERIES], t)
        oracle_secs = time.perf_counter() - t0
        n_or_diff, bad_or = boundary_hit_diffs(
            np, pairwise_np, metric, corpus32, queries32, hits[:ORACLE_QUERIES], o_hits, t)
        n_hits = sum(len(h) for h in hits)
        live_share = sum(tiles) / (qtiles * nb)
        # the exact phase's least time per batch at this run's live tiles:
        # queries, corpus and the (Q, n_pad) output once, the tile's
        # operations per live (i, j, k) at their rate (``bound_ms``)
        exact_bound, exact_by = bound_ms(
            4 * (nq * dim + n_batches * n_pad * dim + nq * n_pad) / n_batches,
            ops_per * sum(tiles) * TILE_BQ * index.block * dim / n_batches, rate,
        )
        row = dict(
            selectivity=sel, t=t, queries=nq, seconds=secs, queries_per_s=nq / secs,
            plain_torch_queries=n_plain, plain_torch_queries_per_s=n_plain / plain_secs,
            hits=n_hits,
            dists_per_query=float(dists.mean()),
            block_exclusion_rate=float(excl.sum() / (nq * nb)),
            tile_exclusion_rate=1.0 - live_share,
            exact_phase_bound_ms_per_batch=exact_bound, exact_phase_bound_by=exact_by,
            alive_boundary_diffs=int(alive_diff.sum()),
            hit_boundary_diffs_vs_torch=n_hit_diff,
            hit_boundary_diffs_vs_oracle=n_or_diff, oracle_seconds=oracle_secs,
        )
        record.setdefault(metric, []).append(row)
        log(f"main path {metric} " + json.dumps(row))
        if bad_alive or bad_hits or bad_or:
            failures.append(
                f"{metric} t={t}: {bad_alive} alive cells and {len(bad_hits) + len(bad_or)} "
                f"hits differ away from the threshold: {(bad_hits + bad_or)[:10]}"
            )
        if not np.isfinite(dists).all():
            failures.append(f"{metric} t={t}: non-finite distance counts")
        total_hits += n_hits

    if total_hits == 0:
        failures.append(f"the {metric} range path found no hits at any threshold")
    if metric in PROB:
        prob_error_near_t(torch, np, failures, record, index, queries32, metric, ts)
    record.setdefault("exact phase alone", {})[metric] = exact_phase_alone(
        torch, index, queries, ts[-1], metric)

    try:  # a failed profile fails the run but keeps the checks above
        for t in ((ts[0], ts[-1]) if metric == "l2" else (ts[-1],)):
            for name in (backend, "torch"):
                # the plain JSD / Triangular pass: one batch (PERF.md §4)
                prof = profile_batches(
                    torch, lambda qb: flat_index.bss_query_batched(
                        index, qb, t, opts=EngineOpts(backend=name)), queries,
                    1 if name == "torch" and metric in PROB else 4, t=t)
                log(f"profile {metric} range {name} " + json.dumps(prof))
    except Exception:
        failures.append(f"phase profile {metric} raised:\n{traceback.format_exc()}")

    if metric == "l2":
        cosine_batch(np, failures, record, dev, corpus, queries32, cfg, backend)
    return dict(counts=counts, live_share=live_share, index=index, ts=ts,
                fp32={t: run for t, (run, _) in zip(ts, cuda_runs)},
                fp32_secs={t: secs for t, (_, secs) in zip(ts, cuda_runs)},
                lb=lb[backend])


def exact_phase_alone(torch, index, queries, t, metric: str, precision: str = "fp32") -> dict:
    """The masked tile of one full main-path batch (the first 512 queries at
    ``t``), timed alone with CUDA events on that batch's own queries, corpus
    and tile mask as the engine passed them, beside the bound of that
    mask's live (i, j, k) (l2: 2 fp32 operations at the fp32 peak; JSD,
    Triangular: one SFU result), the SM clock and power that nvidia-smi
    reads while it runs, and a sha256 of the output's bytes (to hold its
    bits against another commit's).  The launches here come after the
    path's counts were read."""
    from repro_torch.core import flat_index
    from repro_torch.core.backends import EngineOpts

    calls = []
    real = flat_index.masked_pairwise_kernel_call

    def capture(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    flat_index.masked_pairwise_kernel_call = capture
    try:
        flat_index.bss_query_batched(index, queries[:BATCH], t,
                                     opts=EngineOpts(backend="cuda", precision=precision))
    finally:
        flat_index.masked_pairwise_kernel_call = real
    torch.cuda.synchronize()
    out = {}
    # l2: 2 fp32 operations per live (i, j, k); JSD / Triangular: one SFU result
    ops_per, rate = (1, CARD["sfu_rate"]) if metric in PROB else (2, FP32_PEAK)
    for i, (args, kw) in enumerate(calls):  # bf16: the bf16 scan, then the fp32 re-check
        _, x, y, mask = args
        form = "bf16 y" if y.dtype == torch.bfloat16 else "fp32 y"
        live = int(mask.sum()) * kw["bm"] * kw["bn"] * x.shape[1]
        q_rows = int(mask.any(dim=1).sum()) * kw["bm"]
        cols = int(mask.any(dim=0).sum()) * kw["bn"]
        nb, by = bound_ms(4 * (q_rows * x.shape[1] + x.shape[0] * y.shape[0] + mask.numel())
                          + y.element_size() * cols * x.shape[1], ops_per * live, rate)
        # the output's bits, to hold against another commit's run
        digest = hashlib.sha256(real(*args, **kw).cpu().numpy().tobytes()).hexdigest()
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        try:
            ms = time_ms(torch, lambda: real(*args, **kw), 1000)
        finally:
            smi.terminate()
            samples = smi.communicate(timeout=30)[0]
        # (power, clock) of the busier half of the samples: nvidia-smi's
        # first ones come before the loop
        read = sorted((float(p), float(c)) for c, p in
                      (line.split(",") for line in samples.splitlines() if line.count(",") == 1))
        busy = read[len(read) // 2:] or [(float("nan"), float("nan"))]
        out[f"{form} #{i}"] = dict(
            ms=ms, bound_ms=nb, bound_by=by, share_of_bound=nb / ms,
            live_tile_share=float(mask.float().mean()), live_ijk=live,
            sm_mhz_busy_min_max=[min(c for _, c in busy), max(c for _, c in busy)],
            power_w_busy_max=busy[-1][0], clock_samples=len(read), output_sha256=digest)
        log(f"exact phase alone {metric} {precision} {form}: " + json.dumps(out[f"{form} #{i}"]))
    return out


def l2_tile_breakdown(torch, np, dev, shapes=MAIN_SHAPES) -> dict:
    """What the masked l2 tile's time is made of: random rows at the exact
    phase's shape with every cell live, timed with CUDA events at K = 112
    and K = 224, each with and without the sqrt (``squared``).  The slope
    is the cost of 16 more k (one staged chunk) against its bound; the
    intercept at K = 0 is the fixed cost of the tiles (their first loads,
    the epilogue, the output); the squared form shows the sqrt's part."""
    from repro_torch.kernels import pairwise_dist as pdist

    rng = np.random.default_rng(3)
    q, n, bq, blk = (shapes[s] for s in ("q", "n", "bq", "blk"))
    out = {}
    for k in (112, 224):
        x = torch.as_tensor(rng.normal(size=(q, k)).astype(np.float32), device=dev)
        y = torch.as_tensor(rng.normal(size=(n, k)).astype(np.float32), device=dev)
        mask = torch.ones((-(-q // bq), -(-n // blk)), dtype=torch.bool, device=dev)
        for squared in (False, True):
            out[f"ms K={k}" + (" squared" if squared else "")] = time_ms(
                torch, lambda: pdist.masked_pairwise_l2_kernel_call(
                    x, y, mask, bm=bq, bn=blk, squared=squared), 200)
    per_chunk = (out["ms K=224"] - out["ms K=112"]) / 7
    out.update(ms_per_16_k=per_chunk, bound_ms_per_16_k=2 * q * n * 16 / FP32_PEAK * 1e3,
               fixed_ms=out["ms K=112"] - 7 * per_chunk,
               sqrt_ms_at_112=out["ms K=112"] - out["ms K=112 squared"])
    log("l2 tile breakdown " + json.dumps(out))
    return out


def prob_error_near_t(torch, np, failures: list, record: dict, index, queries32, metric: str,
                      ts, label: str | None = None) -> None:
    """The largest |d_cuda - d_float64| over the first batch's cells within
    ``band_eps`` of each threshold, beside the derived error budget and the
    bf16 margin's fp32 arithmetic term (``precision.prob_error_verdict``):
    a cell over its budget, or twice the budget at t over the term, fails
    the run."""
    from repro_torch.core.precision import _rowwise, prob_error_verdict  # float64, guarded
    from repro_torch.kernels import pairwise_dist as pdist

    mirror = index.device
    band = index.bf16_margin()
    k = index.data.shape[1]
    qb = torch.as_tensor(queries32[:BATCH], device=index.torch_device)
    # the unmasked tile gives every cell the bits the masked exact phase
    # gives its live cells: one summation order whatever the launch
    d = pdist.pairwise_kernel_call(metric, qb, mirror.data)
    d.masked_fill_(~mirror.valid[None, :], torch.inf)
    rows = []
    for t in ts:
        near = torch.nonzero((d - t).abs() <= band, as_tuple=True)
        got = d[near].double().cpu().numpy()
        qi, pj = (v.cpu().numpy() for v in near)
        d64 = np.concatenate([np.zeros(0)] + [
            _rowwise(metric, queries32[qi[s:s + 65536]], index.data[pj[s:s + 65536]])
            for s in range(0, len(qi), 65536)])
        row = dict(t=t, band_eps=band, **prob_error_verdict(metric, k, got, d64, t))
        rows.append(row)
        log(f"error budget {label or metric + ' range'} " + json.dumps(row))
        if not row["ok"]:
            failures.append(f"{label or metric} t={t}: error budget {row}")
    record.setdefault("error budget", {})[label or metric] = rows


def prob_small_distances(torch, np, failures: list, dev) -> dict:
    """The JSD / Triangular tiles and their plain fp32 versions (both on the
    card) against float64 on the card tests' inputs (K = 3, 16, 112; 70 x 129
    simplex rows) and on near duplicates (each x row perturbed by 1e-3
    relative): per metric and K, for d below and from 0.05, the largest
    error of each form, the cells over the fixed tolerance 1e-5 + 1e-4 d, the
    largest |kernel - plain|, and the cells over the derived budget (which
    fail the run)."""
    from repro_torch.core.npdist import pairwise_np
    from repro_torch.core.precision import prob_error_budget
    from repro_torch.kernels import pairwise_dist as pdist
    from repro_torch.kernels import ref

    out = {}
    for metric in PROB:
        plain_fn = ref.pairwise_jsd_ref if metric == "jsd" else ref.pairwise_tri_ref
        for k in (3, 16, 112):
            rng = np.random.default_rng(7 * k + 129)
            x = simplex(np, rng, 70, k)
            near = np.abs(x * (1 + 1e-3 * rng.normal(size=x.shape))).astype(np.float32)
            y = np.concatenate([simplex(np, rng, 129, k),
                                (near / near.sum(axis=1, keepdims=True)).astype(np.float32)])
            xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
            got = pdist.pairwise_kernel_call(metric, xt, yt).double().cpu().numpy()
            plain = plain_fn(xt, yt).double().cpu().numpy()
            want = pairwise_np(metric, x, y)
            row = {}
            for part, sel in (("below_0.05", want < 0.05), ("from_0.05", want >= 0.05)):
                d = want[sel]
                errs = {f: np.abs(v[sel] - d) for f, v in (("kernel", got), ("plain", plain))}
                row[part] = dict(
                    cells=int(sel.sum()),
                    **{f"{f}_max_abs_err": float(e.max()) if e.size else 0.0
                       for f, e in errs.items()},
                    **{f"{f}_over_fixed_tol": int((e > 1e-5 + 1e-4 * d).sum())
                       for f, e in errs.items()},
                    kernel_vs_plain=float(np.abs(got[sel] - plain[sel]).max()) if d.size else 0.0)
            approx, fp32 = prob_error_budget(metric, k, np.minimum(got, want))
            row["kernel_over_budget"] = int((np.abs(got - want) > approx + fp32).sum())
            row["plain_over_fp32_budget"] = int((np.abs(plain - want) > fp32).sum())
            out[f"{metric} K={k}"] = row
            log(f"small distances {metric} K={k} " + json.dumps(row))
            if row["kernel_over_budget"]:
                failures.append(f"small distances {metric} K={k}: {row}")
    return out


def cosine_batch(np, failures, record, dev, corpus, queries32, cfg, backend) -> None:
    """One cosine range batch on its own index, at the widest selectivity."""
    from repro_torch.core import flat_index
    from repro_torch.core.backends import EngineOpts
    from repro_torch.core.npdist import pairwise_np
    from repro_torch.data.metricsets import calibrate_threshold

    t0 = time.perf_counter()
    corpus32 = corpus.astype(np.float32)
    cindex = flat_index.build_bss("cosine", corpus, cfg.n_pivots, cfg.n_pairs, cfg.block,
                                  device=dev)
    tc = calibrate_threshold("cosine", corpus, max(cfg.selectivities))
    qb = queries32[:BATCH]
    c_hits, c_st = flat_index.bss_query_batched(cindex, qb, tc, opts=EngineOpts(backend=backend))
    p_hits, _ = flat_index.bss_query_batched(cindex, qb, tc, opts=EngineOpts(backend="torch"))
    o_hits, _ = flat_index.bss_query(cindex, qb[:ORACLE_QUERIES], tc)
    unit = qb / np.maximum(np.linalg.norm(qb, axis=1, keepdims=True), 1e-12)
    cunit = corpus32 / np.maximum(np.linalg.norm(corpus32, axis=1, keepdims=True), 1e-12)
    n_cd, bad_c = boundary_hit_diffs(np, pairwise_np, "l2", cunit, unit, c_hits, p_hits, tc)
    n_co, bad_co = boundary_hit_diffs(np, pairwise_np, "l2", cunit, unit,
                                      c_hits[:ORACLE_QUERIES], o_hits, tc)
    row = dict(t=tc, queries=len(qb), hits=sum(len(h) for h in c_hits),
               dists_per_query=c_st["dists_per_query"],
               block_exclusion_rate=c_st["block_exclusion_rate"],
               hit_boundary_diffs_vs_torch=n_cd, hit_boundary_diffs_vs_oracle=n_co,
               seconds_incl_build=time.perf_counter() - t0)
    record["cosine"] = row
    log("cosine batch " + json.dumps(row))
    if bad_c or bad_co or row["hits"] == 0:
        failures.append(f"cosine: hits differ away from the threshold: {(bad_c + bad_co)[:10]}")


def knn_id_diffs(np, pairwise_np, metric, corpus, queries, ids_a, ids_b) -> tuple[int, list]:
    """Queries whose id lists differ, and the faults among them: a position
    where the two lists hold different ids is allowed only when the ids'
    float64 distances lie within 1e-5 of each other, or both within 1e-5
    of the query's kth distance."""
    n_diff, bad = 0, []
    for qi in np.nonzero((ids_a != ids_b).any(axis=1))[0]:
        n_diff += 1
        a, b = ids_a[qi], ids_b[qi]
        if (a < 0).any() or (b < 0).any():
            bad.append((int(qi), "padding"))
            continue
        da = pairwise_np(metric, queries[qi], corpus[a])[0]
        db = pairwise_np(metric, queries[qi], corpus[b])[0]
        kth = max(da.max(), db.max())
        tol = BAND * max(1.0, kth)
        for pos in np.nonzero(a != b)[0]:
            near = abs(da[pos] - db[pos]) <= tol
            at_kth = abs(da[pos] - kth) <= tol and abs(db[pos] - kth) <= tol
            if not (near or at_kth):
                bad.append((int(qi), int(pos), float(da[pos]), float(db[pos])))
    return n_diff, bad


def brute_force_knn(np, pairwise_np, metric, corpus, queries, k, chunk=8192):
    """(Q, k) ids of the float64 brute force, by ascending distance (lowest
    id first on ties), over corpus chunks: 64 x 101,414 x 112 float64 is
    5.8 GB per intermediate whole."""
    d = np.concatenate([pairwise_np(metric, queries, corpus[s:s + chunk])
                        for s in range(0, len(corpus), chunk)], axis=1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def knn_path(torch, np, failures: list, record: dict, dev, corpus, queries, metric: str,
             cfg, backend: str = "cuda", n_queries: int | None = None,
             plain_batches: int | None = None) -> dict:
    """Phase 5 for one metric: kNN (k = 10) over the queries in 512-query
    batches on the cuda backend, held to the torch backend (on its first
    ``plain_batches`` batches, or all) and a float64 brute force.  Returns
    the metric's launch counts, index and the cuda run's results."""
    from repro_torch.configs.supermetric import build_index
    from repro_torch.core import flat_index
    from repro_torch.core.backends import EngineOpts
    from repro_torch.core.npdist import pairwise_np
    from repro_torch.core.precision import prob_error_verdict
    from repro_torch.kernels import launch_counts, reset_launch_counts

    queries = queries[:n_queries] if n_queries else queries
    corpus32, queries32 = corpus.astype(np.float32), queries.astype(np.float32)
    t0 = time.perf_counter()
    index = build_index(dataclasses.replace(cfg, metric=metric), corpus, device=dev)
    _ = index.device
    log(f"build_bss {metric} for kNN in {time.perf_counter() - t0:.2f} s")
    nq = len(queries)

    def run(name, n=nq):
        ids, dists, rounds, per_query = [], [], [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(0, n, BATCH):
            i, d, st = flat_index.bss_knn_batched(
                index, queries[s:s + BATCH], KNN_K, opts=EngineOpts(backend=name))
            ids.append(i)
            dists.append(d)
            rounds.append(st["rounds"])
            per_query.append(st["per_query_dists"])
        torch.cuda.synchronize()
        return (np.concatenate(ids), np.concatenate(dists), rounds, np.concatenate(per_query),
                time.perf_counter() - t0)

    flat_index.bss_knn_batched(index, queries[:BATCH], KNN_K, opts=EngineOpts(backend=backend))
    reset_launch_counts()
    ids, dists, rounds, per_query, secs = run(backend)
    counts = launch_counts()
    entry = PROB.get(metric, "pairwise_l2")
    expect_launches(failures, f"{metric} kNN", counts,
                    {entry: len(rounds), "planar_lower_bound_pairs": len(rounds),
                     "masked_" + entry: sum(rounds)})
    n_plain = min(nq, plain_batches * BATCH) if plain_batches else nq
    p_ids, p_dists, p_rounds, p_per_query, p_secs = run("torch", n_plain)

    space = metric
    if metric == "cosine":  # the engine's space: the unit sphere under l2
        space = "l2"
        corpus32 = corpus32 / np.maximum(np.linalg.norm(corpus32, axis=1, keepdims=True), 1e-12)
        queries32 = queries32 / np.maximum(np.linalg.norm(queries32, axis=1, keepdims=True), 1e-12)
    n_diff, bad = knn_id_diffs(np, pairwise_np, space, corpus32, queries32, ids[:n_plain],
                               p_ids)
    count_diff = np.nonzero(per_query[:n_plain] != p_per_query)[0]
    kth, p_kth = dists[:n_plain, -1], p_dists[:, -1]
    bad_counts = [int(i) for i in count_diff
                  if abs(kth[i] - p_kth[i]) > BAND * max(1.0, float(p_kth[i]))]
    t0 = time.perf_counter()
    truth = brute_force_knn(np, pairwise_np, space, corpus32, queries32[:ORACLE_QUERIES], KNN_K)
    n_or_diff, bad_or = knn_id_diffs(np, pairwise_np, space, corpus32, queries32,
                                     ids[:ORACLE_QUERIES], truth)
    row = dict(
        k=KNN_K, queries=nq, batches=len(rounds), seconds=secs, queries_per_s=nq / secs,
        plain_torch_queries=n_plain, plain_torch_queries_per_s=n_plain / p_secs,
        rounds_per_batch=rounds, plain_torch_rounds_per_batch=p_rounds,
        dists_per_query=float(per_query.mean()),
        plain_torch_dists_per_query=float(p_per_query.mean()),
        count_diff_queries=len(count_diff), id_diff_queries_vs_torch=n_diff,
        id_diff_queries_vs_oracle=n_or_diff, oracle_seconds=time.perf_counter() - t0,
        finite=bool(np.isfinite(dists).all()),
    )
    if metric in PROB:  # the returned distances, near the kth, against float64
        d64 = np.stack([pairwise_np(metric, queries32[i], corpus32[ids[i]])[0]
                        for i in range(min(ORACLE_QUERIES, nq))])
        row["error_budget"] = prob_error_verdict(
            metric, corpus32.shape[1], dists[:len(d64)], d64, float(dists[:, -1].min()))
        if not row["error_budget"]["ok"]:
            failures.append(f"kNN {metric}: error budget {row['error_budget']}")
    record.setdefault("knn", {})[metric] = row
    log(f"knn {metric} " + json.dumps(row))
    if bad or bad_or or bad_counts or not row["finite"]:
        failures.append(f"kNN {metric}: ids differ away from ties {(bad + bad_or)[:10]}, "
                        f"counts differ with kth apart {bad_counts[:10]}, finite {row['finite']}")
    row["top_k_per_round"] = top_k_per_round(torch, flat_index, index, queries)
    log(f"knn {metric} top-k per round " + json.dumps(row["top_k_per_round"]))
    if metric == "jsd":
        try:
            # the plain backend's rate is the row's plain_torch_queries_per_s
            # (its profile took ~13 s on a slow host; PERF.md §4)
            for name in (backend,):
                prof = profile_batches(
                    torch, lambda qb: flat_index.bss_knn_batched(
                        index, qb, KNN_K, opts=EngineOpts(backend=name)), queries, 1, k=KNN_K)
                log(f"profile jsd knn {name} " + json.dumps(prof))
        except Exception:
            failures.append(f"phase profile jsd knn raised:\n{traceback.format_exc()}")
    return dict(counts=counts, index=index, ids=ids, dists=dists, rounds=rounds,
                per_query=per_query, secs=secs)


def top_k_per_round(torch, flat_index, index, queries) -> dict:
    """The round top-k of the first kNN batch (``_top_k_smallest`` on each
    round's (512, n_pad) distance block), timed alone per round with CUDA
    events, beside the full stable sort it replaces on the same block."""
    from repro_torch.core.backends import EngineOpts

    blocks = []
    real = flat_index._top_k_smallest

    def capture(dist, k):
        blocks.append((dist, k))
        return real(dist, k)

    flat_index._top_k_smallest = capture
    try:
        flat_index.bss_knn_batched(index, queries[:BATCH], KNN_K, opts=EngineOpts(backend="cuda"))
    finally:
        flat_index._top_k_smallest = real
    return dict(
        shape=list(blocks[0][0].shape),
        top_k_ms=[time_ms(torch, lambda: real(d, k), 20) for d, k in blocks],
        stable_sort_ms=[time_ms(torch, lambda: torch.sort(d, dim=1, stable=True), 5)
                        for d, _ in blocks])


BF16_SELECTIVITIES = (1e-5, 1e-3)
# the unmasked bf16 forms: no engine path reads them (query -> pivot
# distances read the fp32 pivots), so their launches on the main path are 0
OFF_PATH = ("pairwise_l2_bf16", "pairwise_jsd_bf16", "pairwise_tri_bf16",
            # the engine runs the planar kernel through its pairs form
            "planar_lower_bound")


def bf16_range_path(torch, np, failures: list, record: dict, queries, metric: str,
                    cfg, path: dict, backend: str = "cuda") -> dict:
    """Phase 6 for one metric: ``precision="bf16"`` over all queries on the
    metric's range-path index, held to that path's fp32 cuda pass exactly.
    Returns the launch counts and the live-tile share at 1e-3."""
    from repro_torch.core import flat_index
    from repro_torch.core.backends import EngineOpts
    from repro_torch.core.precision import bf16_round_np
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.tiles import TILE_BQ

    index = path["index"]
    nq, nb = len(queries), index.n_blocks
    n_batches = -(-nq // BATCH)
    t0 = time.perf_counter()
    mirror = index.device_bf16
    eps = index.bf16_margin()
    torch.cuda.synchronize()
    log(f"bf16 mirror {metric}: {tuple(mirror.shape)} {mirror.dtype}, band_eps {eps!r} "
        f"in {time.perf_counter() - t0:.2f} s")
    if not torch.equal(mirror.float().cpu(), torch.from_numpy(bf16_round_np(index.data))):
        failures.append(f"bf16 {metric}: device_bf16 is not bf16_round_np(index.data)")
    chosen = [(s, t) for s, t in zip(cfg.selectivities, path["ts"]) if s in BF16_SELECTIVITIES]
    bf16 = EngineOpts(backend=backend, precision="bf16")
    flat_index.bss_query_batched(index, queries[:BATCH], chosen[0][1], opts=bf16)  # warm-up
    torch.cuda.synchronize()

    reset_launch_counts()
    runs = []
    for _, t in chosen:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = run_queries(flat_index, EngineOpts, index, queries, t, backend, "bf16")
        torch.cuda.synchronize()
        runs.append((run, time.perf_counter() - t0))
    counts = launch_counts()
    log(f"{metric} bf16 range path launch counts: {counts}")
    entry = PROB.get(metric, "pairwise_l2")
    per_form = len(chosen) * n_batches
    expect_launches(failures, f"{metric} bf16 range path", counts,
                    {entry: per_form, "planar_lower_bound_pairs": per_form,
                     "masked_" + entry + "_bf16": per_form, "masked_" + entry: per_form})

    qtiles = sum(-(-min(BATCH, nq - s) // TILE_BQ) for s in range(0, nq, BATCH))
    q_dev = torch.as_tensor(queries.astype(np.float32), device=index.torch_device)
    eps_dev = torch.tensor(eps, dtype=torch.float32, device=index.torch_device)
    live_share = 0.0
    for (sel, t), ((hits, stats), secs) in zip(chosen, runs):
        f_hits, f_stats = path["fp32"][t]
        same = dict(
            hits=hits == f_hits,
            per_query_dists=bool(np.array_equal(per_query(stats, "per_query_dists"),
                                                per_query(f_stats, "per_query_dists"))),
            excluded=bool(np.array_equal(per_query(stats, "excluded"),
                                         per_query(f_stats, "excluded"))),
            tiles_computed=[st["tiles_computed"] for st in stats]
            == [st["tiles_computed"] for st in f_stats],
        )
        # alive of every bf16 pass against the fp32 pass's bounds (lb <= t)
        alive_equal = True
        for s in range(0, nq, BATCH):
            qb = q_dev[s:s + BATCH]
            _, alive, _, _, _ = flat_index._query_batched_bf16(
                metric, qb, torch.full((len(qb),), t, dtype=torch.float32, device=qb.device),
                index.device, mirror, eps_dev, block=index.block, bq=TILE_BQ, backend=backend)
            alive_equal &= bool(np.array_equal(alive.cpu().numpy(),
                                               path["lb"][s:s + BATCH] <= np.float32(t)))
        same["alive"] = alive_equal
        # the plain backend on two batches: bf16 equal to fp32 exactly
        q2 = queries[:2 * BATCH]
        p16 = run_queries(flat_index, EngineOpts, index, q2, t, "torch", "bf16")
        p32 = run_queries(flat_index, EngineOpts, index, q2, t, "torch")
        same["torch_two_batches"] = p16[0] == p32[0] and all(
            np.array_equal(per_query(p16[1], k), per_query(p32[1], k))
            for k in ("per_query_dists", "excluded"))
        tiles = sum(st["tiles_computed"] for st in stats)
        recheck = sum(st["recheck_tiles"] for st in stats)
        live_share = tiles / (qtiles * nb)
        row = dict(
            selectivity=sel, t=t, queries=nq, seconds=secs, queries_per_s=nq / secs,
            fp32_queries_per_s=nq / path["fp32_secs"][t],
            hits=sum(len(h) for h in hits), band_eps=stats[0]["band_eps"],
            tiles_computed=tiles, recheck_tiles=recheck,
            recheck_share_of_computed_tiles=recheck / tiles if tiles else 0.0,
            recheck_points_per_query=float(per_query(stats, "per_query_recheck").mean()),
            live_tile_share=live_share,
            masked_bf16_launches=counts["masked_" + entry + "_bf16"],
            masked_fp32_launches=counts["masked_" + entry],
            equal_to_fp32=same,
        )
        record.setdefault("bf16 range", {}).setdefault(metric, []).append(row)
        log(f"bf16 range {metric} " + json.dumps(row))
        if not all(same.values()):
            failures.append(f"bf16 range {metric} t={t}: differs from fp32: {same}")

    try:  # a failed profile fails the run but keeps the checks above
        t = chosen[-1][1]
        prof = profile_batches(torch, lambda qb: flat_index.bss_query_batched(
            index, qb, t, opts=bf16), queries, t=t, precision="bf16")
        log(f"profile {metric} range bf16 {backend} " + json.dumps(prof))
    except Exception:
        failures.append(f"phase profile {metric} bf16 raised:\n{traceback.format_exc()}")
    record.setdefault("exact phase alone", {})[metric + " bf16"] = exact_phase_alone(
        torch, index, queries, chosen[-1][1], metric, "bf16")
    return dict(counts=counts, live_share=live_share)


def check_bf16_kernels(torch, np, failures: list, dev, live_share: dict,
                       shapes=MAIN_SHAPES) -> dict:
    """Phase 7: the six bf16-corpus entry points against their plain
    versions on the same bf16 ``y``, at the main path's shapes; the masked
    ones at the live-tile share of their bf16 range path (one dead tile
    row).  Bytes count ``y`` at 2 bytes; operations as the fp32 forms."""
    from repro_torch.kernels import launch_counts, ref
    from repro_torch.kernels import pairwise_dist as pdist

    rng = np.random.default_rng(2)
    q, p, k, n, bq, blk = (shapes[s] for s in ("q", "p", "k", "n", "bq", "blk"))
    before = launch_counts()
    out = {}
    plain_of = {"l2": ref.pairwise_l2_ref, "jsd": ref.pairwise_jsd_ref,
                "triangular": ref.pairwise_tri_ref}
    # operations per (i, j, k) and their rate
    ops_of = {"l2": (2, FP32_PEAK), "jsd": (1, CARD["sfu_rate"]),
              "triangular": (1, CARD["sfu_rate"])}
    for metric, plain in plain_of.items():
        entry = PROB.get(metric, "pairwise_l2")
        ops_per, rate = ops_of[metric]

        def make(r, metric=metric):
            if metric == "l2":
                return torch.as_tensor(rng.normal(size=(r, k)).astype(np.float32), device=dev)
            return torch.as_tensor(simplex(np, rng, r, k), device=dev)

        x = make(q)
        # unmasked: the query -> pivot shapes (Q x P)
        piv16 = make(p).bfloat16()
        got = pdist.pairwise_kernel_call(metric, x, piv16)
        tol = (RTOL, ATOL) if metric == "l2" else (PROB_RTOL, PROB_ATOL)
        err, same_inf, close = compare(torch, got, plain(x, piv16), *tol)
        extra_ops = 2 * (q + p) * k + 4 * q * p if metric == "l2" else 0
        nb_, no_ = bound_ms(4 * (q * k + q * p) + 2 * p * k,
                            ops_per * q * p * k + extra_ops, rate)
        out[entry + "_bf16"] = _row(
            failures, entry + "_bf16", entry, False, err, same_inf and close,
            ms=device_ms(torch, lambda: pdist.pairwise_kernel_call(metric, x, piv16)),
            plain_ms=time_ms(torch, lambda: plain(x, piv16), 50),
            bound_ms=nb_, bound_by=no_,
            library_ms=(device_ms(torch, lambda: torch.cdist(x, piv16.float()))
                        if metric == "l2" else None),
        )
        # masked: the exact phase's shapes at the path's live-tile share
        y16 = make(n).bfloat16()
        mask_np = rng.random((-(-q // bq), -(-n // blk))) < live_share[metric]
        mask_np[1] = False
        mask = torch.as_tensor(mask_np, device=dev)
        log(f"masked {metric} bf16: live tile share {float(mask_np.mean()):.5f} (the bf16 range "
            f"path's {live_share[metric]:.5f}, one of {mask_np.shape[0]} tile rows dead)")

        def plain_masked():
            return ref.masked_pairwise_metric_ref(plain(x, y16), mask, bq, blk)

        got = pdist.masked_pairwise_kernel_call(metric, x, y16, mask, bm=bq, bn=blk)
        err, same_inf, close = compare(torch, got, plain_masked())
        live = int(mask_np.sum()) * bq * blk
        rows = int(mask_np.any(axis=1).sum()) * bq
        cols = int(mask_np.any(axis=0).sum()) * blk
        nb_, no_ = bound_ms(4 * (rows * k + q * n + mask_np.size) + 2 * cols * k,
                            ops_per * live * k, rate)
        heavy = metric != "l2"
        out["masked_" + entry + "_bf16"] = _row(
            failures, "masked_" + entry + "_bf16", entry, True, err, same_inf and close,
            ms=time_ms(torch, lambda: pdist.masked_pairwise_kernel_call(
                metric, x, y16, mask, bm=bq, bn=blk), 10 if heavy else 20),
            plain_ms=time_ms(torch, plain_masked, 5 if heavy else 20),
            bound_ms=nb_, bound_by=no_,
            library_ms=None if heavy else time_ms(torch, lambda: torch.cdist(x, y16.float())),
        )
    after = launch_counts()
    for name, rec in out.items():
        rec["check_launches"] = after[name] - before[name]
        if rec["check_launches"] <= 0:
            failures.append(f"bf16 kernel {name} was not launched by its check")
        log_kernel(rec)
    return out


def bf16_knn_path(torch, np, failures: list, record: dict, queries, metric: str,
                  fp32: dict, backend: str = "cuda") -> dict:
    """Phase 8 for one metric: bf16 kNN over all queries on the index of
    phase 5, held to phase 5's fp32 cuda run exactly."""
    from repro_torch.core import flat_index
    from repro_torch.core.backends import EngineOpts
    from repro_torch.kernels import launch_counts, reset_launch_counts

    index = fp32["index"]
    nq = len(queries)
    opts = EngineOpts(backend=backend, precision="bf16")
    flat_index.bss_knn_batched(index, queries[:BATCH], KNN_K, opts=opts)  # warm-up
    reset_launch_counts()
    ids, dists, rounds, per_q, stats = [], [], [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, nq, BATCH):
        i, d, st = flat_index.bss_knn_batched(index, queries[s:s + BATCH], KNN_K, opts=opts)
        ids.append(i)
        dists.append(d)
        rounds.append(st["rounds"])
        per_q.append(st["per_query_dists"])
        stats.append(st)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    entry = PROB.get(metric, "pairwise_l2")
    expect_launches(failures, f"{metric} bf16 kNN", counts,
                    {entry: len(rounds), "planar_lower_bound_pairs": len(rounds),
                     "masked_" + entry + "_bf16": sum(rounds), "masked_" + entry: sum(rounds)})
    ids, dists, per_q = np.concatenate(ids), np.concatenate(dists), np.concatenate(per_q)
    same = dict(ids=bool(np.array_equal(ids, fp32["ids"])),
                dists=bool(np.array_equal(dists, fp32["dists"])),
                rounds=rounds == fp32["rounds"],
                per_query_dists=bool(np.array_equal(per_q, fp32["per_query"])))
    tiles = sum(st["tiles_computed"] for st in stats)
    recheck = sum(st["recheck_tiles"] for st in stats)
    row = dict(
        k=KNN_K, queries=nq, seconds=secs, queries_per_s=nq / secs,
        fp32_queries_per_s=nq / fp32["secs"], rounds_per_batch=rounds,
        band_eps=stats[0]["band_eps"], tiles_computed=tiles, recheck_tiles=recheck,
        recheck_share_of_computed_tiles=recheck / tiles if tiles else 0.0,
        recheck_points_per_query=float(np.concatenate(
            [st["per_query_recheck"] for st in stats]).mean()),
        masked_bf16_launches=counts["masked_" + entry + "_bf16"],
        masked_fp32_launches=counts["masked_" + entry], equal_to_fp32=same,
    )
    record.setdefault("bf16 knn", {})[metric] = row
    log(f"bf16 knn {metric} " + json.dumps(row))
    if not all(same.values()):
        failures.append(f"bf16 kNN {metric} differs from fp32: {same}")
    return counts


def living_corpus(torch, np, failures: list, record: dict, dev, corpus, queries, metric: str,
                  cfg, t: float, seed: int = 0) -> None:
    """Phase 9 for one metric: build on 90% of the rows, append 10%, delete
    1% of the ids, and compact; every generation checked on two batches."""
    from repro_torch.core import flat_index
    from repro_torch.core.backends import EngineOpts
    from repro_torch.core.npdist import pairwise_np
    from repro_torch.core.precision import bf16_round_np
    from repro_torch.index import append, compact, delete

    corpus32 = corpus.astype(np.float32)
    queries32 = queries[:2 * BATCH].astype(np.float32)
    n = len(corpus32)
    n0 = int(0.9 * n)
    fp32, bf16 = EngineOpts(backend="cuda"), EngineOpts(backend="cuda", precision="bf16")
    row = dict(metric=metric, t=t, rows=n, built_on=n0, generations=[])

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def range_hits(index, opts):
        hits, stats = run_queries(flat_index, EngineOpts, index, queries32, t,
                                  opts.backend, opts.precision)
        return hits, per_query(stats, "per_query_dists"), stats

    def check(index, label):
        h32, d32, _ = range_hits(index, fp32)
        h16, d16, s16 = range_hits(index, bf16)
        o_hits, _ = flat_index.bss_query(index, queries32[:ORACLE_QUERIES], t)
        n_or, bad_or = boundary_hit_diffs(np, pairwise_np, metric, corpus32, queries32,
                                          h32[:ORACLE_QUERIES], o_hits, t)
        k32 = [flat_index.bss_knn_batched(index, queries32[s:s + BATCH], KNN_K, opts=fp32)
               for s in (0, BATCH)]
        k16 = [flat_index.bss_knn_batched(index, queries32[s:s + BATCH], KNN_K, opts=bf16)
               for s in (0, BATCH)]
        knn_same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                       and a[2]["rounds"] == b[2]["rounds"]
                       and np.array_equal(a[2]["per_query_dists"], b[2]["per_query_dists"])
                       for a, b in zip(k32, k16))
        live = set(index.perm[index.valid].tolist())
        stale = sum(h not in live for hits in h32 for h in hits)
        gen = dict(label=label, generation=index.generation, n_valid=index.n_valid,
                   n_blocks=index.n_blocks, hits=sum(map(len, h32)),
                   band_eps=s16[0]["band_eps"],
                   bf16_range_equal=h16 == h32 and bool(np.array_equal(d16, d32)),
                   bf16_knn_equal=bool(knn_same), hit_boundary_diffs_vs_oracle=n_or,
                   hits_not_live=stale)
        row["generations"].append(gen)
        log(f"living corpus {metric} " + json.dumps(gen))
        if not (gen["bf16_range_equal"] and knn_same) or bad_or or stale or not gen["hits"]:
            failures.append(f"living corpus {metric} {label}: {gen}, oracle faults {bad_or[:10]}")
        return h32

    idx0, row["build_seconds"] = timed(lambda: flat_index.build_bss(
        metric, corpus32[:n0], cfg.n_pivots, cfg.n_pairs, cfg.block, device=dev))
    check(idx0, "built on 90%")  # makes the fp32 and bf16 mirrors, so append extends both
    (idx1, ms), row["append_seconds"] = timed(lambda: append(idx0, corpus32[n0:]))
    row["append"] = dataclasses.asdict(ms)
    extended = bool(idx1._device is not None and idx1._bf16 is not None and torch.equal(
        idx1._bf16.float().cpu(), torch.from_numpy(bf16_round_np(idx1.data))))
    check(idx1, "appended 10%")
    dead = np.random.default_rng(seed).choice(n, size=n // 100, replace=False)
    old_valid = idx1._device.valid.clone()
    (idx2, ms), row["delete_seconds"] = timed(lambda: delete(idx1, dead.tolist()))
    row["delete"] = dataclasses.asdict(ms)
    untouched = bool(torch.equal(idx1._device.valid, old_valid))
    check(idx2, "deleted 1%")
    (idx3, ms), row["compact_seconds"] = timed(lambda: compact(idx2, refresh_pivots=True))
    row["compact"] = dataclasses.asdict(ms)
    h3 = check(idx3, "compacted")
    live_pos = np.nonzero(idx2.valid)[0]
    ids = np.sort(idx2.perm[live_pos])
    fresh = flat_index.build_bss(metric, corpus32[ids], cfg.n_pivots, cfg.n_pairs, cfg.block,
                                 seed=idx2.seed, device=dev)
    mapped = np.where(fresh.perm >= 0, ids[np.clip(fresh.perm, 0, len(ids) - 1)], -1)
    fields = {f: bool(np.array_equal(getattr(idx3, f), getattr(fresh, f)))
              for f in ("data", "valid", "pivots", "pairs", "deltas", "boxes")}
    fields["perm"] = bool(np.array_equal(idx3.perm, mapped))
    fresh_hits = range_hits(fresh, fp32)[0]
    fields["hits"] = h3 == [[int(ids[h]) for h in hits] for hits in fresh_hits]
    row.update(mirrors_extended=extended, old_valid_untouched=untouched,
               compact_equals_fresh_build=fields)
    record.setdefault("living corpus", {})[metric] = row
    log(f"living corpus {metric} " + json.dumps(
        {k: v for k, v in row.items() if k != "generations"}))
    if not (extended and untouched and all(fields.values())):
        failures.append(f"living corpus {metric}: mirrors extended {extended}, old valid "
                        f"untouched {untouched}, compact vs fresh build {fields}")
    if row["append"]["table_dists"] != (n - n0) * cfg.n_pivots:
        failures.append(f"living corpus {metric}: append table_dists {row['append']}")


SERVE_CLIENTS = 8


def serving_requests(np, n: int, ts: list, seed: int, knn: bool = True) -> list:
    """One request per query, ``(query row, kind, t, precision)``: range at
    the three thresholds in turn, every 4th request kNN (k = KNN_K), every
    16th bf16 (alternately a range and a kNN one); then about 1% of the
    requests again, which ``serve_wave`` sends once the others are
    answered, so that the result cache hits."""
    reqs = []
    for i in range(n):
        kind = "knn" if knn and i % 4 == 1 else "range"
        reqs.append((i, kind, ts[i % 3] if kind == "range" else None,
                     "bf16" if i % 32 in (0, 17) else "fp32"))
    again = np.random.default_rng(seed).choice(n, size=n // 100, replace=False)
    return reqs + [reqs[j] for j in sorted(again)]


def serve_wave(front, queries, reqs, n_first: int | None = None) -> tuple[list, list, float]:
    """Submit ``reqs[:n_first]`` from SERVE_CLIENTS threads, request j from
    thread j mod SERVE_CLIENTS, wait for every future, then the rest the
    same way.  Returns the results (None where a request failed), the
    failures and the host seconds of both rounds.

    The clients take turns at ``submit`` (one lock), so the front's trace
    ids follow its queue order and ``check_served`` can rebuild each batch
    the driver formed."""
    import threading

    futs: list = [None] * len(reqs)
    turn = threading.Lock()

    def client(c, lo, hi):
        for j in range(lo + c, hi, SERVE_CLIENTS):
            qi, kind, t, precision = reqs[j]
            try:
                with turn:
                    futs[j] = (front.submit(queries[qi], "knn", k=KNN_K, precision=precision)
                               if kind == "knn" else
                               front.submit(queries[qi], "range", t=t, precision=precision))
            except Exception as e:  # a refused request counts as a failure
                futs[j] = e

    results, errors = [None] * len(reqs), []
    t0 = time.perf_counter()
    n_first = len(reqs) if n_first is None else n_first
    for lo, hi in ((0, n_first), (n_first, len(reqs))):
        threads = [threading.Thread(target=client, args=(c, lo, hi))
                   for c in range(SERVE_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for j in range(lo, hi):
            try:
                if isinstance(futs[j], Exception):
                    raise futs[j]
                results[j] = futs[j].result(timeout=600)
            except Exception as e:
                errors.append(f"request {j} {reqs[j][1:]}: {e!r}")
    return results, errors, time.perf_counter() - t0


def serving_numbers(np, results, secs: float) -> dict:
    """Requests/s by host clock, and p50 / p99 of the latency (admission to
    demux), the queue wait and the engine time of the request's batch."""
    done = [r for r in results if r is not None]
    run = [r for r in done if not r.cache_hit]

    def pct(xs):
        xs = np.asarray(xs, float)
        return dict(p50=float(np.percentile(xs, 50)) * 1e3,
                    p99=float(np.percentile(xs, 99)) * 1e3) if xs.size else "none"

    return dict(requests=len(results), seconds=secs, requests_per_s=len(results) / secs,
                latency_ms=pct([r.spans["total"] for r in run]),
                queue_wait_ms=pct([r.queue_wait_s for r in run]),
                engine_ms=pct([r.engine_s for r in run]),
                cache_hits=sum(r.cache_hit for r in done))


def check_served(np, snapshots: dict, queries, reqs, results) -> dict:
    """Every result against direct ``"cuda"`` calls (``realisation="dense"``,
    the request's precision) on the index of the generation it names.

    * ``same_batch``: each batch the front dispatched, rebuilt (the rows
      that share generation, kind, precision, batch size, bucket and
      engine time, in trace-id order, which ``serve_wave`` makes the queue
      order; padded as the front pads) and run directly: hits, kNN ids and
      distances, ``per_query_dists`` and, for bf16, ``per_query_recheck``
      must be equal, row for row.
    * ``other_batch``: every row again in batches of BATCH rows of its
      (generation, kind, precision), in request order: hits, kNN ids and
      distances, and range ``per_query_dists`` must be equal.  A kNN
      row's ``per_query_dists`` and a bf16 row's re-check count are only
      counted where they differ (``tile_dependent``): a round's top-k
      reads every cell the query's tile computed, so the rows that share
      the tile can tighten its next radius, and the band counts those
      cells too (the reference's accounting; the results are exact
      either way).

    Returns the counts and the first differences, each with the fields
    that differ."""
    from repro_torch.core import flat_index
    from repro_torch.core.backends import EngineOpts

    def direct(gen, kind, precision, js, pad=0):
        rows = [reqs[j][0] for j in js] + [reqs[js[0]][0]] * pad
        opts = EngineOpts(backend="cuda", realisation="dense", precision=precision)
        if kind == "range":
            t_vec = np.array([reqs[j][2] for j in js] + [-1.0] * pad, np.float32)
            hits, st = flat_index.bss_query_batched(snapshots[gen], queries[rows], t_vec,
                                                    opts=opts)
            return hits, None, None, st
        return (None, *flat_index.bss_knn_batched(snapshots[gen], queries[rows], KNN_K,
                                                  opts=opts))

    tile_dependent: list = []

    def compare(js, out, precision, same_batch, diffs):
        hits, ids, dists, st = out
        for m, j in enumerate(js):
            r, bad = results[j], []
            if r.n_dists != st["per_query_dists"][m]:
                bad.append(("n_dists", r.n_dists, int(st["per_query_dists"][m])))
            if hits is not None and r.hits != hits[m]:
                bad.append(("hits", len(r.hits), len(hits[m])))
            if ids is not None and not np.array_equal(r.indices, ids[m]):
                bad.append(("ids", sorted(set(r.indices.tolist()) ^ set(ids[m].tolist()))))
            if dists is not None and not np.array_equal(r.distances, dists[m]):
                bad.append(("distances", float(np.abs(r.distances - dists[m]).max())))
            if precision == "bf16" and r.n_recheck != st["per_query_recheck"][m]:
                bad.append(("n_recheck", r.n_recheck, int(st["per_query_recheck"][m])))
            if not same_batch:
                # the per-tile accounting of the docstring: recorded apart
                moved = [b for b in bad if b[0] == "n_recheck"
                         or b[0] == "n_dists" and reqs[j][1] == "knn"]
                if moved:
                    tile_dependent.append((j, r.generation, reqs[j][1], precision, moved))
                bad = [b for b in bad if b not in moved]
            if bad:
                diffs.append((j, r.generation, reqs[j][1], precision, bad))
        return len(js)

    groups: dict = {}
    batches: dict = {}
    for j, r in enumerate(results):
        if r is None:
            continue
        key = (r.generation, reqs[j][1], reqs[j][3])
        groups.setdefault(key, []).append(j)
        if not r.cache_hit:
            batches.setdefault((*key, r.batch_size, r.padded_to, r.engine_s), []).append(j)
    same, other = [], []
    n_same = n_other = 0
    for (gen, kind, precision, n, bucket, _), js in batches.items():
        js = sorted(js, key=lambda j: results[j].trace_id)
        if len(js) != n:  # a batch whose rows are not all here cannot be rebuilt
            same.append(("batch", gen, kind, precision, n, len(js)))
            continue
        n_same += compare(js, direct(gen, kind, precision, js, bucket - n), precision, True,
                          same)
    for (gen, kind, precision), js in sorted(groups.items()):
        for s in range(0, len(js), BATCH):
            chunk = js[s:s + BATCH]
            n_other += compare(chunk, direct(gen, kind, precision, chunk), precision, False,
                               other)
    return dict(same_batch=dict(rows=n_same, batches=len(batches), differing=len(same),
                                first=same[:10]),
                other_batch=dict(rows=n_other, differing=len(other), first=other[:10],
                                 tile_dependent=len(tile_dependent),
                                 tile_dependent_first=tile_dependent[:5]),
                groups={f"gen {g} {k} {p}": len(js) for (g, k, p), js in sorted(groups.items())})


def serving(torch, np, failures: list, record: dict, corpus, queries, metric: str, cfg,
            ts: list, n_requests: int | None = None, mutate: bool = True) -> dict:
    """Phase 10 for one metric: ``RetrievalServer`` on the card with the
    configuration's settings and its ``async_front`` (default ladder,
    ``max_delay_s=0.002``, ``cache_size=4096``); waves of one request per
    query from SERVE_CLIENTS threads; every result checked against a
    direct ``"cuda"`` call on the generation it names."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import validate_exposition, validate_trace
    from repro_torch.serve.retrieval import RetrievalServer

    corpus32, queries32 = corpus.astype(np.float32), queries.astype(np.float32)
    n_requests = len(queries32) if n_requests is None else n_requests
    # build on all but the last 1% of the rows (the tail the living corpus
    # phase appends from); the first wave's front appends them back
    n0 = len(corpus32) - len(corpus32) // 100 if mutate else len(corpus32)
    t0 = time.perf_counter()
    server = RetrievalServer(corpus32[:n0], metric=metric, n_pivots=cfg.n_pivots,
                             n_pairs=cfg.n_pairs, block=cfg.block)
    row = dict(metric=metric, built_on=n0, build_seconds=time.perf_counter() - t0,
               thresholds=ts, clients=SERVE_CLIENTS, waves=[])
    errors: list = []
    checks = []
    snapshots = {}
    reset_launch_counts()
    with server.async_front(max_delay_s=0.002, cache_size=4096) as front:
        row["buckets"] = list(front.buckets)
        snapshots[front.index.generation] = front.index
        reqs = serving_requests(np, n_requests, ts, seed=1, knn=mutate)
        res, errs, secs = serve_wave(front, queries32, reqs, n_requests)
        errors += errs
        row["waves"].append(dict(wave=1, **serving_numbers(np, res, secs)))
        waves = [(queries32, reqs, res)]
        if mutate:
            ms = front.append(corpus32[n0:])
            snapshots[front.index.generation] = front.index
            dead = np.random.default_rng(3).choice(n0, size=100, replace=False).tolist()
            md = front.delete(dead)
            snapshots[front.index.generation] = front.index
            row["mutations"] = [dict(op=m.op, rows=m.rows, generation=m.generation,
                                     table_dists=m.table_dists) for m in (ms, md)]
            # the second wave under torch.profiler: a warm-up step (BATCH
            # range requests on the appended rows, traced and thrown away),
            # then the wave
            warm = [(i, "range", ts[1], "fp32") for i in range(min(BATCH, len(corpus32) - n0))]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                         acc_events=True) as prof:
                wres, errs, _ = serve_wave(front, corpus32[n0:], warm)
                errors += errs
                prof.step()
                before = sum(launch_counts().values())
                reqs2 = serving_requests(np, n_requests, ts, seed=2)
                res2, errs, secs2 = serve_wave(front, queries32, reqs2, n_requests)
                port_launches = sum(launch_counts().values()) - before
                prof.step()
            errors += errs
            device, launches = trace_device(prof)
            busy = sum(device.values())
            row["waves"].append(dict(
                wave=2, profiled=True, **serving_numbers(np, res2, secs2),
                device_busy_ms=busy, device_idle_share=1.0 - busy / (secs2 * 1e3),
                device_ms_by_kernel={k: round(v, 5) for k, v in sorted(
                    device.items(), key=lambda kv: -kv[1])[:8]},
                port_kernel_launches=port_launches,
                port_kernel_events=sum(n for k, n in launches.items()
                                       if k.startswith(PORT_KERNELS))))
            waves += [(corpus32[n0:], warm, wres), (queries32, reqs2, res2)]
        counts = launch_counts()
        st = front.stats()
        row.update({k: st[k] for k in ("submitted", "completed", "errors", "shed", "cache_hits",
                                       "batches", "per_bucket_batches", "padding_waste",
                                       "batch_size_mean", "engine_s_per_batch")})
        prom = front.metrics().to_prometheus()
        snap = front.metrics().snapshot()
        out = ROOT / "build" / "serving"
        out.mkdir(parents=True, exist_ok=True)
        trace_path = front.export_trace(out / f"trace_{metric}.json")
    from repro_torch.obs import load_trace

    row["launches"] = {k: v for k, v in counts.items() if v}
    row["recompiles"] = {k: v for k, v in snap["counters"].items()
                         if k.startswith("compile/recompiles")}
    row["exposition_problems"] = validate_exposition(prom)
    row["trace_problems"] = validate_trace(load_trace(trace_path))
    for queries_w, reqs_w, res_w in waves:
        checks.append(check_served(np, snapshots, queries_w, reqs_w, res_w))
    row["checks"] = checks
    row["request_failures"] = errors[:10]
    record.setdefault("serving", {})[metric] = row
    log(f"serving {metric} " + json.dumps(row))
    want = {"l2": ("pairwise_l2", "masked_pairwise_l2", "masked_pairwise_l2_bf16"),
            "jsd": ("pairwise_jsd", "masked_pairwise_jsd", "masked_pairwise_jsd_bf16")}[metric]
    missing = [k for k in (*want, "planar_lower_bound_pairs") if counts.get(k, 0) <= 0]
    bad = (errors or missing or row["recompiles"] and max(row["recompiles"].values()) > 0
           or row["exposition_problems"] or row["trace_problems"]
           or any(c["same_batch"]["differing"] or c["other_batch"]["differing"]
                  for c in checks) or st["errors"])
    if bad:
        failures.append(f"serving {metric}: failed requests {len(errors)} {errors[:3]}, kernels "
                        f"not launched {missing}, recompiles {row['recompiles']}, exposition "
                        f"{row['exposition_problems'][:3]}, trace {row['trace_problems'][:3]}, "
                        f"differences {[(c['same_batch']['first'], c['other_batch']['first']) for c in checks]}, "
                        f"driver errors {st['errors']}")
    return counts


# ---------------------------------------------------------------------------
# the device forest (phases 11-15)
# ---------------------------------------------------------------------------

FOREST_TORCH_QUERIES = 4 * BATCH  # the "torch" comparisons of the forest phases
# the tiles the forest phases must launch (the Triangular forest runs in
# the CPU and card tests only)
FOREST_PATH = ("masked_pairwise_l2", "masked_pairwise_l2_bf16", "masked_pairwise_jsd")


def _rel_gap(np, value, threshold) -> float:
    """The smallest |value - threshold| / max(1, |threshold|) (inf if none)."""
    value = np.asarray(value, np.float64).ravel()
    threshold = np.broadcast_to(np.asarray(threshold, np.float64), value.shape).ravel()
    keep = np.isfinite(value) & np.isfinite(threshold)
    if not keep.any():
        return float("inf")
    return float((np.abs(value[keep] - threshold[keep])
                  / np.maximum(1.0, np.abs(threshold[keep]))).min())


def tree_margin(np, tr, query, t: float, mech: str) -> float:
    """The float64 host walk of one query through a partition tree: the
    smallest relative gap between any predicate it evaluates (a hit, a
    cover radius, a hyperplane or centre criterion) and its threshold.  A
    float32 walk can part from it only where that gap is within BAND."""
    from repro_torch.core import tree as tree_mod
    from repro_torch.core.constants import DEGENERATE_DELTA, MIN_DELTA
    from repro_torch.core.exclusion import HILBERT
    from repro_torch.core.npdist import pairwise_np

    q = np.asarray(query, np.float64)[None, :]  # lint: disable=R3
    best = float("inf")
    stack = [(tr.root, None)]
    while stack:
        node, dc = stack.pop()
        if node is None:
            continue
        if isinstance(node, np.ndarray):
            if len(node):
                best = min(best, _rel_gap(np, pairwise_np(tr.metric, q, tr.data[node])[0], t))
            continue
        k = len(node.ref_idx)
        if k == 0:
            stack.extend((ch, None) for ch in node.children)
            continue
        dq = pairwise_np(tr.metric, q, tr.data[node.ref_idx])[0]
        off = ~np.eye(k, dtype=bool)
        if mech == HILBERT:
            crit = (dq[:, None] ** 2 - dq[None, :] ** 2) / np.maximum(node.ref_dists, MIN_DELTA)
            off &= node.ref_dists >= DEGENERATE_DELTA
        else:
            crit = dq[:, None] - dq[None, :]
        best = min(best, _rel_gap(np, dq, t), _rel_gap(np, dq, node.cover_r + t),
                   _rel_gap(np, crit[off], 2.0 * t))
        if dc is not None and not np.any(np.isnan(node.centre_dists)):
            cd = node.centre_dists
            cc = ((dq ** 2 - dc ** 2) / np.maximum(cd, MIN_DELTA) if mech == HILBERT
                  else dq - dc)
            if mech == HILBERT:
                cc = cc[cd >= DEGENERATE_DELTA]
            best = min(best, _rel_gap(np, cc, 2.0 * t))
        excl = tree_mod._exclusion_masks(
            dq[None, :], node, t, mech, None if dc is None else np.array([dc]))[0]
        stack.extend((ch, dq[j]) for j, ch in enumerate(node.children)
                     if ch is not None and not excl[j])
    return best


def monotone_margin(np, tr, query, t: float, mech: str) -> float:
    """``tree_margin`` for a monotone tree: hits and the margin tests
    ``m < t`` and ``m > -t`` along the float64 host walk."""
    from repro_torch.core import exclusion, projection
    from repro_torch.core.exclusion import HYPERBOLIC
    from repro_torch.core.npdist import pairwise_np

    q = np.asarray(query, np.float64)[None, :]  # lint: disable=R3
    d_root = pairwise_np(tr.metric, q, tr.data[tr.root_p1][None, :])[0, 0]
    best = _rel_gap(np, d_root, t)
    stack = [(tr.root, d_root)]
    while stack:
        node, d1 = stack.pop()
        if node is None:
            continue
        if isinstance(node, np.ndarray):
            if len(node):
                best = min(best, _rel_gap(np, pairwise_np(tr.metric, q, tr.data[node])[0], t))
            continue
        d2 = pairwise_np(tr.metric, q, tr.data[node.p2][None, :])[0, 0]
        if mech == HYPERBOLIC:
            m = exclusion.hyperbolic_margin(d1, d2, xp=np)
        else:
            x, y = projection.project(d1, d2, node.delta, xp=np)
            m = exclusion.planar_margin(x, y, node.theta, node.h, node.nx, node.ny,
                                        node.split, xp=np)
        best = min(best, _rel_gap(np, d2, t), _rel_gap(np, m, t), _rel_gap(np, m, -t))
        if m < t:
            stack.append((node.left, d1))
        if m > -t:
            stack.append((node.right, d2))
    return best


def forest_diffs(np, metric: str, corpus, queries, a, b, t: float, margin) -> dict:
    """Two walks' results on the same queries, ``a`` and ``b`` each (hits,
    per-query counts): hits that differ, those farther than BAND * max(1,
    t) from t in float64 (faults), counts that differ and those of queries
    whose float64 walk has no predicate within BAND of its threshold
    (``margin(query)``: faults)."""
    from repro_torch.core.npdist import pairwise_np

    # the host walks list a query's hits in another order
    (ha, ca), (hb, cb) = ([sorted(h) for h in a[0]], a[1]), ([sorted(h) for h in b[0]], b[1])
    n_hits, bad_hits = boundary_hit_diffs(np, pairwise_np, metric, corpus, queries, ha, hb, t)
    moved = np.nonzero(np.asarray(ca) != np.asarray(cb))[0]
    bad_counts = [int(qi) for qi in moved if margin(queries[qi]) > BAND]
    return dict(hit_diffs=n_hits, hit_faults=bad_hits[:10], count_diffs=int(moved.size),
                count_diffs_at_a_threshold=int(moved.size) - len(bad_counts),
                count_faults=bad_counts[:10])


def _margin(np, tr, t, mech, monotone=False):
    if monotone:
        return lambda q: monotone_margin(np, tr, q, t, mech)
    return lambda q: tree_margin(np, tr, q, t, mech)


def run_forest(search, enc, queries, t, mech, backend, precision="fp32"):
    """All ``queries`` in batches of BATCH through a forest walk: hits, the
    per-query counts and each batch's stats."""
    from repro_torch.core.backends import EngineOpts

    hits, stats = [], []
    for s in range(0, len(queries), BATCH):
        h, st = search(enc, queries[s:s + BATCH], t, mech,
                       opts=EngineOpts(backend=backend, precision=precision))
        hits += h
        stats.append(st)
    return hits, per_query(stats, "per_query_dists"), stats


def _forest_totals(np, stats: list) -> dict:
    """Exclusion attribution per query and frontier occupancy per level,
    over all the batches of a run."""
    nq = sum(len(st["per_query_dists"]) for st in stats)
    excl = {m: float(sum(int(np.sum(st["excluded"][m])) for st in stats)) / nq
            for m in stats[0]["excluded"]}
    front = np.sum([st["frontier_occupancy"] for st in stats], axis=0)
    return dict(excluded_per_query=excl,
                frontier_occupancy_per_query=[round(float(v) / nq, 3) for v in front])


def _check_forest(failures, name, diffs: dict) -> None:
    if diffs["hit_faults"] or diffs["count_faults"]:
        failures.append(f"{name}: differences away from the threshold {diffs}")


def forest_l2(torch, np, failures: list, record: dict, dev, corpus, queries, cfg, ts: list,
              bss_rows: list) -> dict:
    """Phase 11: the ``hpt_fft_log`` forest of SISAP colors at paper size
    (``build_index(engine="tree")``, encoded for the card), all queries at
    the three l2 thresholds under Hilbert on ``"cuda"``, the first
    FOREST_TORCH_QUERIES on ``"torch"`` too, 16 against the numpy host
    walk; the middle threshold under Hyperbolic; four batches profiled.
    Returns the launch counts, the encoding, the tree and the fp32 runs."""
    from repro_torch.configs.supermetric import build_index
    from repro_torch.core import tree as tree_mod
    from repro_torch.core.backends import EngineOpts
    from repro_torch.core.exclusion import HILBERT, HYPERBOLIC
    from repro_torch.core.npdist import pairwise_np
    from repro_torch.forest import encode_tree, forest_range_search
    from repro_torch.kernels import launch_counts, reset_launch_counts

    corpus32, queries32 = corpus.astype(np.float32), queries.astype(np.float32)
    nq = len(queries32)
    t0 = time.perf_counter()
    tr = build_index(cfg, corpus, engine="tree")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc = encode_tree(tr, device=dev)
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _ = enc.device
    torch.cuda.synchronize()
    mirror_s = time.perf_counter() - t0
    widest = max(range(len(enc.levels)), key=lambda i: enc.levels[i].ref_data.shape[0])
    shape = dict(variant=tr.variant, build_seconds=build_s, encode_seconds=encode_s,
                 mirror_seconds=mirror_s, levels=len(enc.levels), nodes=enc.n_nodes,
                 leaves=enc.leaf.n_leaves, leaf_rows=int(enc.leaf.data.shape[0]),
                 widest_level=widest,
                 widest_level_rows=int(enc.levels[widest].ref_data.shape[0]),
                 widest_level_nodes=int(enc.levels[widest].n_refs.shape[0]),
                 widest_level_kmax=int(enc.levels[widest].ref_idx.shape[1]))
    log("forest l2 encoding " + json.dumps(shape))
    forest_range_search(enc, queries32[:BATCH], ts[0])  # warm-up
    torch.cuda.synchronize()

    reset_launch_counts()
    runs = []
    for t in ts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = run_forest(forest_range_search, enc, queries32, t, HILBERT, "cuda")
        torch.cuda.synchronize()
        runs.append((run, time.perf_counter() - t0))
    counts = launch_counts()
    n_batches = -(-nq // BATCH)
    expect_launches(failures, "forest l2", counts,
                    {"masked_pairwise_l2": len(ts) * n_batches * (len(enc.levels) + 1)})
    log(f"forest l2 launch counts: {counts}")

    rows = []
    nt = FOREST_TORCH_QUERIES
    for t, sel, ((hits, cnt, stats), secs), bss in zip(ts, cfg.selectivities, runs, bss_rows):
        margin = _margin(np, tr, t, HILBERT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_hits, p_cnt, _ = run_forest(forest_range_search, enc, queries32[:nt], t, HILBERT,
                                      "torch")
        torch.cuda.synchronize()
        plain_secs = time.perf_counter() - t0
        vs_torch = forest_diffs(np, "l2", corpus32, queries32, (hits[:nt], cnt[:nt]),
                                (p_hits, p_cnt), t, margin)
        t0 = time.perf_counter()
        o_hits, counter = tree_mod.range_search(tr, queries32[:ORACLE_QUERIES], t, HILBERT)
        oracle_secs = time.perf_counter() - t0
        vs_oracle = forest_diffs(np, "l2", corpus32, queries32,
                                 (hits[:ORACLE_QUERIES], cnt[:ORACLE_QUERIES]),
                                 (o_hits, counter.per_query), t, margin)
        row = dict(selectivity=sel, t=t, queries=nq, seconds=secs, queries_per_s=nq / secs,
                   plain_torch_queries_per_s=nt / plain_secs,
                   hits=sum(len(h) for h in hits), dists_per_query=float(cnt.mean()),
                   bss_dists_per_query=bss["dists_per_query"],
                   bss_queries_per_s=bss["queries_per_s"], **_forest_totals(np, stats),
                   vs_torch=vs_torch, vs_oracle=vs_oracle, oracle_seconds=oracle_secs)
        rows.append(row)
        log("forest l2 " + json.dumps(row))
        _check_forest(failures, f"forest l2 t={t} vs torch", vs_torch)
        _check_forest(failures, f"forest l2 t={t} vs oracle", vs_oracle)
    if sum(row["hits"] for row in rows) == 0:
        failures.append("the forest l2 path found no hits at any threshold")

    # one threshold under Hyperbolic: the same exact hits, more distances
    t = ts[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y_hits, y_cnt, y_stats = run_forest(forest_range_search, enc, queries32, t, HYPERBOLIC,
                                        "cuda")
    torch.cuda.synchronize()
    y_secs = time.perf_counter() - t0
    (hil_hits, hil_cnt, _), _ = runs[1]
    o_hits, counter = tree_mod.range_search(tr, queries32[:ORACLE_QUERIES], t, HYPERBOLIC)
    vs_oracle = forest_diffs(np, "l2", corpus32, queries32,
                             (y_hits[:ORACLE_QUERIES], y_cnt[:ORACLE_QUERIES]),
                             (o_hits, counter.per_query), t, _margin(np, tr, t, HYPERBOLIC))
    n_hd, bad_h = boundary_hit_diffs(np, pairwise_np, "l2", corpus32, queries32, y_hits,
                                     hil_hits, t)
    hyp = dict(mechanism=HYPERBOLIC, t=t, queries=nq, seconds=y_secs, queries_per_s=nq / y_secs,
               dists_per_query=float(y_cnt.mean()),
               hilbert_dists_per_query=float(hil_cnt.mean()),
               hit_boundary_diffs_vs_hilbert=n_hd, vs_oracle=vs_oracle,
               **_forest_totals(np, y_stats))
    log("forest l2 hyperbolic " + json.dumps(hyp))
    _check_forest(failures, "forest l2 hyperbolic vs oracle", vs_oracle)
    if bad_h:
        failures.append(f"forest l2 hyperbolic: hits differ from Hilbert's {bad_h[:10]}")

    profiles = {}
    try:  # a failed profile fails the run but keeps the checks above
        for name in ("cuda", "torch"):
            prof = profile_batches(
                torch, lambda qb: forest_range_search(
                    enc, qb, ts[-1], HILBERT, opts=EngineOpts(backend=name)),
                queries32, t=ts[-1], backend=name)
            profiles[name] = prof
            log(f"profile forest l2 {name} " + json.dumps(prof))
            if name == "cuda" and prof["port_kernel_launches"] != 4 * (len(enc.levels) + 1):
                failures.append(f"forest l2 profile: {prof['port_kernel_launches']} launches "
                                f"in 4 batches, expected {4 * (len(enc.levels) + 1)}")
    except Exception:
        failures.append(f"phase profile forest l2 raised:\n{traceback.format_exc()}")
    record["forest l2"] = dict(encoding=shape, rows=rows, hyperbolic=hyp, profiles=profiles)
    return dict(counts=counts, enc=enc, tree=tr, runs={t: r for t, (r, _) in zip(ts, runs)})


def forest_bf16(torch, np, failures: list, record: dict, queries, cfg, l2: dict) -> dict:
    """Phase 12: ``precision="bf16"`` over all queries on ``"cuda"`` at
    selectivities 1e-5 and 1e-3: hits, ``per_query_dists``, ``excluded``
    and the frontier must equal phase 11's fp32 runs bit for bit."""
    from repro_torch.core.exclusion import HILBERT
    from repro_torch.forest import forest_range_search
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.tiles import TILE_BLOCK, TILE_BQ

    enc = l2["enc"]
    queries32 = queries.astype(np.float32)
    nq = len(queries32)
    forest_range_search(enc, queries32[:BATCH], min(l2["runs"]), precision="bf16")  # warm-up
    torch.cuda.synchronize()
    if not torch.equal(enc.leaf_bf16.float().cpu(),
                       torch.as_tensor(enc.leaf.data).to(torch.bfloat16).float()):
        failures.append("forest bf16: the leaf mirror is not the fp32 leaf table's rounding")
    leaf_tiles = -(-nq // BATCH) * (-(-BATCH // TILE_BQ)) * (enc.leaf.data.shape[0] // TILE_BLOCK)
    reset_launch_counts()
    rows = []
    for sel in (1e-5, 1e-3):
        t = sorted(l2["runs"])[cfg.selectivities.index(sel)]
        hits32, cnt32, st32 = l2["runs"][t]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hits, cnt, stats = run_forest(forest_range_search, enc, queries32, t, HILBERT,
                                      "cuda", "bf16")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        same = dict(
            hits=hits == hits32,
            per_query_dists=bool(np.array_equal(cnt, cnt32)),
            excluded=all(np.array_equal(a["excluded"][m], b["excluded"][m])
                         for a, b in zip(stats, st32) for m in b["excluded"]),
            frontier=all(np.array_equal(a["frontier_occupancy"], b["frontier_occupancy"])
                         for a, b in zip(stats, st32)))
        recheck = int(sum(st["recheck_tiles"] for st in stats))
        row = dict(selectivity=sel, t=t, queries=nq, seconds=secs, queries_per_s=nq / secs,
                   band_eps=stats[0]["band_eps"], recheck_tiles=recheck,
                   recheck_share_of_leaf_tiles=recheck / leaf_tiles,
                   recheck_points_per_query=float(
                       per_query(stats, "per_query_recheck").mean()),
                   equal_to_fp32=same)
        rows.append(row)
        log("forest bf16 " + json.dumps(row))
        if not all(same.values()):
            failures.append(f"forest bf16 t={t}: differs from fp32 {same}")
    counts = launch_counts()
    log(f"forest bf16 launch counts: {counts}")
    record["forest bf16"] = rows
    return counts


def forest_monotone(torch, np, failures: list, record: dict, dev, corpus, queries, cfg,
                    t: float) -> dict:
    """Phase 13: the monotone ``lrt``/``far`` tree
    (``build_index(engine="lrt")``) at paper size, all queries at the
    widest l2 threshold on ``"cuda"``, the first FOREST_TORCH_QUERIES on
    ``"torch"``, 16 against ``lrt.range_search_monotone``."""
    from repro_torch.configs.supermetric import build_index
    from repro_torch.core import lrt
    from repro_torch.core.exclusion import HILBERT
    from repro_torch.forest import encode_monotone, monotone_range_search
    from repro_torch.kernels import launch_counts, reset_launch_counts

    corpus32, queries32 = corpus.astype(np.float32), queries.astype(np.float32)
    nq = len(queries32)
    t0 = time.perf_counter()
    tr = build_index(cfg, corpus, engine="lrt")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc = encode_monotone(tr, device=dev)
    _ = enc.device
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    monotone_range_search(enc, queries32[:BATCH], t)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hits, cnt, stats = run_forest(monotone_range_search, enc, queries32, t, HILBERT, "cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    expect_launches(failures, "forest monotone", counts,
                    {"masked_pairwise_l2": -(-nq // BATCH) * (len(enc.levels) + 1)})
    margin = _margin(np, tr, t, HILBERT, monotone=True)
    nt = FOREST_TORCH_QUERIES
    t0 = time.perf_counter()
    p_hits, p_cnt, _ = run_forest(monotone_range_search, enc, queries32[:nt], t, HILBERT,
                                  "torch")
    torch.cuda.synchronize()
    plain_secs = time.perf_counter() - t0
    vs_torch = forest_diffs(np, "l2", corpus32, queries32, (hits[:nt], cnt[:nt]),
                            (p_hits, p_cnt), t, margin)
    o_hits, counter = lrt.range_search_monotone(tr, queries32[:ORACLE_QUERIES], t, HILBERT)
    vs_oracle = forest_diffs(np, "l2", corpus32, queries32,
                             (hits[:ORACLE_QUERIES], cnt[:ORACLE_QUERIES]),
                             (o_hits, counter.per_query), t, margin)
    row = dict(partition=tr.partition, select=tr.select, build_seconds=build_s,
               encode_seconds=encode_s, levels=len(enc.levels), nodes=enc.n_nodes,
               leaves=enc.leaf.n_leaves, leaf_rows=int(enc.leaf.data.shape[0]), t=t,
               queries=nq, seconds=secs, queries_per_s=nq / secs,
               plain_torch_queries_per_s=nt / plain_secs, hits=sum(len(h) for h in hits),
               dists_per_query=float(cnt.mean()), **_forest_totals(np, stats),
               vs_torch=vs_torch, vs_oracle=vs_oracle)
    log("forest monotone " + json.dumps(row))
    _check_forest(failures, "forest monotone vs torch", vs_torch)
    _check_forest(failures, "forest monotone vs oracle", vs_oracle)
    if row["hits"] == 0:
        failures.append("forest monotone: no hits")
    record["forest monotone"] = row
    return counts


class _LeafIndex:
    """The leaf table of an encoded forest in the shape ``prob_error_near_t``
    reads an index: its device rows, valid mask, host data and margin."""

    def __init__(self, enc):
        leaves = enc.device.leaves
        self.device = types.SimpleNamespace(data=leaves.leaf_data, valid=leaves.leaf_valid)
        self.data = enc.leaf.data
        self.torch_device = enc.torch_device
        self.bf16_margin = enc.bf16_eps


def forest_jsd(torch, np, failures: list, record: dict, dev, corpus, queries, cfg,
               t: float) -> dict:
    """Phase 14: ``hpt_fft_log`` under JSD at paper size, the first
    FOREST_TORCH_QUERIES queries at the widest JSD threshold on ``"cuda"``
    and ``"torch"``, 16 against the host walk; the leaf table's cells near
    t held to float64 within the error budget (``prob_error_near_t``)."""
    from repro_torch.configs.supermetric import build_index
    from repro_torch.core import tree as tree_mod
    from repro_torch.core.exclusion import HILBERT
    from repro_torch.forest import encode_tree, forest_range_search
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cfg = dataclasses.replace(cfg, metric="jsd")
    corpus32, queries32 = corpus.astype(np.float32), queries.astype(np.float32)
    nt = FOREST_TORCH_QUERIES
    t0 = time.perf_counter()
    tr = build_index(cfg, corpus, engine="tree")
    build_s = time.perf_counter() - t0
    enc = encode_tree(tr, device=dev)
    forest_range_search(enc, queries32[:BATCH], t)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    hits, cnt, stats = run_forest(forest_range_search, enc, queries32[:nt], t, HILBERT, "cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    expect_launches(failures, "forest jsd", counts,
                    {"masked_pairwise_jsd": -(-nt // BATCH) * (len(enc.levels) + 1)})
    margin = _margin(np, tr, t, HILBERT)
    p_hits, p_cnt, _ = run_forest(forest_range_search, enc, queries32[:nt], t, HILBERT, "torch")
    vs_torch = forest_diffs(np, "jsd", corpus32, queries32, (hits, cnt), (p_hits, p_cnt), t,
                            margin)
    o_hits, counter = tree_mod.range_search(tr, queries32[:ORACLE_QUERIES], t, HILBERT)
    vs_oracle = forest_diffs(np, "jsd", corpus32, queries32,
                             (hits[:ORACLE_QUERIES], cnt[:ORACLE_QUERIES]),
                             (o_hits, counter.per_query), t, margin)
    row = dict(t=t, build_seconds=build_s, levels=len(enc.levels), nodes=enc.n_nodes,
               leaves=enc.leaf.n_leaves, queries=nt, seconds=secs, queries_per_s=nt / secs,
               hits=sum(len(h) for h in hits), dists_per_query=float(cnt.mean()),
               **_forest_totals(np, stats), vs_torch=vs_torch, vs_oracle=vs_oracle)
    log("forest jsd " + json.dumps(row))
    _check_forest(failures, "forest jsd vs torch", vs_torch)
    _check_forest(failures, "forest jsd vs oracle", vs_oracle)
    if row["hits"] == 0:
        failures.append("forest jsd: no hits")
    prob_error_near_t(torch, np, failures, record, _LeafIndex(enc), queries32, "jsd", [t],
                      label="forest jsd")
    record["forest jsd"] = row
    return counts


def serving_forest(torch, np, failures: list, record: dict, corpus, queries, ts: list) -> dict:
    """Phase 15: ``RetrievalServer(index="forest", metric="l2")`` on the card
    and its ``async_front`` (default ladder, ``max_delay_s=0.002``,
    ``cache_size=4096``): one wave of 4 * BATCH range requests at the three
    thresholds (every 16th bf16, 1% sent again) from SERVE_CLIENTS
    threads.  Every result must equal a direct ``forest_range_search`` on
    the batch the front formed, every field; a kNN request must raise
    ``FOREST_KNN_ERROR``."""
    from repro_torch.core.backends import EngineOpts
    from repro_torch.forest import forest_range_search
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.retrieval import FOREST_KNN_ERROR, RetrievalServer

    corpus32, queries32 = corpus.astype(np.float32), queries.astype(np.float32)
    t0 = time.perf_counter()
    server = RetrievalServer(corpus32, metric="l2", index="forest")
    row = dict(build_seconds=time.perf_counter() - t0, thresholds=ts, clients=SERVE_CLIENTS)
    n = 4 * BATCH
    reqs = serving_requests(np, n, ts, seed=4, knn=False)
    reset_launch_counts()
    with server.async_front(max_delay_s=0.002, cache_size=4096) as front:
        try:
            front.submit(queries32[0], "knn", k=KNN_K)
            knn_refused = False
        except NotImplementedError as e:
            knn_refused = str(e) == FOREST_KNN_ERROR
        res, errors, secs = serve_wave(front, queries32, reqs, n)
        st = front.stats()
        rec = front.explain()
    counts = launch_counts()
    row.update(serving_numbers(np, res, secs))
    row.update({k: st[k] for k in ("batches", "per_bucket_batches", "padding_waste",
                                   "batch_size_mean", "engine_s_per_batch", "errors")})
    row["explain_last"] = {k: rec[k] for k in ("excluded", "frontier_occupancy")} if rec else None
    # every batch the front formed, rebuilt and walked directly
    batches: dict = {}
    for j, r in enumerate(res):
        if r is not None and not r.cache_hit:
            batches.setdefault((reqs[j][2], reqs[j][3], r.batch_size, r.padded_to,
                                r.engine_s), []).append(j)
    differing, rows_checked = [], 0
    for (t, precision, nb, bucket, _), js in batches.items():
        js = sorted(js, key=lambda j: res[j].trace_id)
        if len(js) != nb:
            differing.append(("batch", t, precision, nb, len(js)))
            continue
        qs = queries32[[reqs[j][0] for j in js] + [reqs[js[0]][0]] * (bucket - nb)]
        hits, stt = forest_range_search(server.index, qs, t, server.forest_mechanism,
                                        opts=EngineOpts(backend="cuda", precision=precision))
        for m, j in enumerate(js):
            r = res[j]
            bad = [f for f, ok in (
                ("hits", r.hits == hits[m]),
                ("n_dists", r.n_dists == stt["per_query_dists"][m]),
                ("n_recheck", precision == "fp32"
                 or r.n_recheck == stt["per_query_recheck"][m])) if not ok]
            if bad:
                differing.append((j, t, precision, bad))
        rows_checked += len(js)
    row["checks"] = dict(rows=rows_checked, batches=len(batches), differing=len(differing),
                         first=differing[:10])
    row["knn_refused"] = knn_refused
    row["request_failures"] = errors[:10]
    row["launches"] = {k: v for k, v in counts.items() if v}
    log("serving forest " + json.dumps(row))
    record["serving forest"] = row
    missing = [k for k in ("masked_pairwise_l2", "masked_pairwise_l2_bf16")
               if counts.get(k, 0) <= 0]
    if errors or differing or missing or not knn_refused or st["errors"]:
        failures.append(f"serving forest: failed requests {errors[:3]}, differences "
                        f"{differing[:5]}, kernels not launched {missing}, kNN refused "
                        f"{knn_refused}, driver errors {st['errors']}")
    return counts


# ---------------------------------------------------------------------------
# sharded BSS (phase 16): every result against the single-device "cuda" runs
# ---------------------------------------------------------------------------

SHARDS = (2, 4, 8)
# the kernels every shard launches on the sharded path
SHARDED_PATH = ("pairwise_l2", "masked_pairwise_l2", "masked_pairwise_l2_bf16",
                "planar_lower_bound_pairs", "pairwise_jsd", "masked_pairwise_jsd",
                "masked_pairwise_jsd_bf16", "pairwise_tri", "masked_pairwise_tri",
                "masked_pairwise_tri_bf16")


def mesh_view(index, n_shards: int):
    """The same index (its host arrays) with a mesh of ``n_shards`` shards
    on this host's cards (``local_mesh``: round-robin, all on cuda:0 on a
    one-card machine): what ``build_bss(mesh=...)`` gives, without building
    the layout again."""
    from repro_torch.parallel import local_mesh

    return dataclasses.replace(index, mesh=local_mesh(n_shards), _device=None, _bf16=None,
                               _sharded=None)


def add_counts(acc: dict, counts: dict) -> None:
    for k, v in counts.items():
        acc[k] = acc.get(k, 0) + v


def same_bits(np, a, b) -> bool:
    """Float arrays equal bit for bit (-0.0 apart from +0.0)."""
    a, b = np.ascontiguousarray(a, np.float32), np.ascontiguousarray(b, np.float32)
    return a.shape == b.shape and bool(np.array_equal(a.view(np.uint32), b.view(np.uint32)))


def range_fields(np, stats: list) -> dict:
    return dict(per_query_dists=per_query(stats, "per_query_dists"),
                excluded=per_query(stats, "excluded"),
                tiles_computed=np.array([st["tiles_computed"] for st in stats]))


def equal_fields(np, got: dict, want: dict) -> dict:
    return {k: bool(np.array_equal(got[k], want[k])) for k in want}


def sharded_range(torch, np, failures: list, record: dict, queries, metric: str, cfg,
                  single: dict, sharded_counts: dict) -> dict:
    """Sharded range for one metric at S = 2, 4, 8 shards: all queries in
    512-query batches at the three thresholds, each batch held to the
    single-device "cuda" run of phase 4 bit for bit (hits, ``alive``
    through the bounds, ``per_query_dists``, ``excluded``,
    ``tiles_computed``), and each batch's ``shard_dists`` summing to its
    exact-phase work.  Returns the S = 4 runs."""
    from repro_torch.core import flat_index
    from repro_torch.core.backends import EngineOpts
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.tiles import TILE_BQ
    from repro_torch.obs import shard_imbalance
    from repro_torch.parallel.shard_index import _range_pass, sharded_lower_bounds

    index, ts = single["index"], single["ts"]
    nq, nb = len(queries), index.n_blocks
    n_piv = index.pivots.shape[0]
    per_form = len(ts) * -(-nq // BATCH)
    entry = PROB.get(metric, "pairwise_l2")
    q_first = flat_index._engine_queries(metric, queries[:BATCH].astype(np.float32))

    def time_single() -> dict:
        out = {}
        for t in ts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_queries(flat_index, EngineOpts, index, queries, t, "cuda")
            torch.cuda.synchronize()
            out[t] = time.perf_counter() - t0
        return out

    # the single device timed again in this phase, before and after the
    # shards (S = 1, S = 2, 4, 8, S = 1): host speed drifts over a run
    single_secs = [time_single()]
    kept, rows = {}, []
    for n_shards in SHARDS:
        view = mesh_view(index, n_shards)
        sidx = view.sharded()
        flat_index.bss_query_batched(view, queries[:BATCH], ts[0],
                                     opts=EngineOpts(backend="cuda"))  # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        runs = {}
        for t in ts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run = run_queries(flat_index, EngineOpts, view, queries, t, "cuda")
            torch.cuda.synchronize()
            runs[t] = (run, time.perf_counter() - t0)
        counts = launch_counts()
        add_counts(sharded_counts, counts)
        expect_launches(failures, f"sharded {metric} S={n_shards} range", counts,
                        {entry: n_shards * per_form, "masked_" + entry: n_shards * per_form,
                         "planar_lower_bound_pairs": n_shards * per_form})
        # alive: the bounds of every batch through the shards, bit for bit
        lb = np.concatenate([sharded_lower_bounds(sidx, queries[s:s + BATCH], backend="cuda")
                             for s in range(0, nq, BATCH)])
        lb_equal = same_bits(np, lb, single["lb"])
        for t, sel in zip(ts, cfg.selectivities):
            (hits, stats), secs = runs[t]
            w_hits, w_stats = single["fp32"][t]
            # the first batch's alive mask straight from the sharded pass
            alive = _range_pass(sidx, metric, q_first, np.full(len(q_first), t, np.float32),
                                bq=TILE_BQ, backend="cuda")[1][:, :nb]
            equal = dict(hits=hits == w_hits, lower_bounds=lb_equal,
                         alive_first_batch=bool(np.array_equal(
                             alive, single["lb"][:BATCH] <= np.float32(t))),
                         **equal_fields(np, range_fields(np, stats), range_fields(np, w_stats)))
            work = all(int(st["shard_dists"].sum())
                       == int(st["per_query_dists"].sum()) - len(st["per_query_dists"]) * n_piv
                       for st in stats)
            sd = sum(st["shard_dists"] for st in stats)
            row = dict(metric=metric, shards=n_shards, selectivity=sel, t=t, queries=nq,
                       seconds=secs, queries_per_s=nq / secs,
                       phase4_single_queries_per_s=nq / single["fp32_secs"][t],
                       shard_dists=sd.tolist(),
                       shard_blocks=sum(st["shard_blocks"] for st in stats).tolist(),
                       shard_imbalance=shard_imbalance(sd),
                       batch_imbalance_max=max(shard_imbalance(st["shard_dists"]) for st in stats),
                       shard_work_sums=work, equal_to_single=equal)
            rows.append(row)
            if not (work and all(equal.values())):
                failures.append(f"sharded {metric} S={n_shards} t={t}: shard work sums {work}, "
                                f"equal to single-device cuda {equal}")
        if n_shards == 4:
            kept = dict(view=view, runs=runs)
    single_secs.append(time_single())
    for row in rows:
        secs1 = sum(s_[row["t"]] for s_ in single_secs) / len(single_secs)
        row.update(single_queries_per_s=nq / secs1, speed_vs_single=secs1 / row["seconds"],
                   single_seconds_before_after=[s_[row["t"]] for s_ in single_secs])
        record.setdefault("sharded range", []).append(row)
        log("sharded range " + json.dumps(row))
    return kept



def sharded_bf16_range(torch, np, failures: list, record: dict, queries, metric: str,
                       s4: dict, t: float, sharded_counts: dict) -> None:
    """bf16 range at selectivity 1e-3 on 4 shards: every field equal to the
    4-shard fp32 run, the shard vectors included."""
    from repro_torch.core import flat_index
    from repro_torch.core.backends import EngineOpts
    from repro_torch.kernels import launch_counts, reset_launch_counts

    view = s4["view"]
    nq = len(queries)
    n_batches = -(-nq // BATCH)
    flat_index.bss_query_batched(view, queries[:BATCH], t,
                                 opts=EngineOpts(backend="cuda", precision="bf16"))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    hits, stats = run_queries(flat_index, EngineOpts, view, queries, t, "cuda", "bf16")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    add_counts(sharded_counts, counts)
    entry = PROB.get(metric, "pairwise_l2")
    per = 4 * n_batches
    expect_launches(failures, f"sharded {metric} bf16 range", counts,
                    {entry: per, "planar_lower_bound_pairs": per, "masked_" + entry: per,
                     "masked_" + entry + "_bf16": per})
    (w_hits, w_stats), w_secs = s4["runs"][t]
    fields = ("shard_dists", "shard_blocks")
    equal = dict(hits=hits == w_hits,
                 **equal_fields(np, range_fields(np, stats), range_fields(np, w_stats)),
                 **{f: all(np.array_equal(a[f], b[f]) for a, b in zip(stats, w_stats))
                    for f in fields})
    tiles = sum(st["tiles_computed"] for st in stats)
    row = dict(metric=metric, shards=4, t=t, queries_per_s=nq / secs,
               fp32_queries_per_s=nq / w_secs, band_eps=stats[0]["band_eps"],
               recheck_share_of_computed_tiles=(sum(st["recheck_tiles"] for st in stats) / tiles
                                                if tiles else 0.0),
               equal_to_fp32=equal)
    record.setdefault("sharded bf16 range", []).append(row)
    log("sharded bf16 range " + json.dumps(row))
    if not all(equal.values()):
        failures.append(f"sharded bf16 range {metric} differs from fp32: {equal}")


def sharded_knn(torch, np, failures: list, record: dict, queries, metric: str, single: dict,
                sharded_counts: dict, shards=SHARDS, precision: str = "fp32") -> None:
    """kNN (k = 10) over all queries on S shards: ids, distances, rounds and
    ``per_query_dists`` equal to the single-device "cuda" run of phase 5."""
    from repro_torch.core import flat_index
    from repro_torch.core.backends import EngineOpts
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import shard_imbalance

    nq = len(queries)
    opts = EngineOpts(backend="cuda", precision=precision)
    entry = PROB.get(metric, "pairwise_l2")

    def time_single() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(0, nq, BATCH):
            flat_index.bss_knn_batched(single["index"], queries[s:s + BATCH], KNN_K, opts=opts)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # the single device timed again in this phase, before and after the
    # shards: host speed drifts over a run
    single_secs, rows = [time_single()], []
    for n_shards in shards:
        view = mesh_view(single["index"], n_shards)
        flat_index.bss_knn_batched(view, queries[:BATCH], KNN_K, opts=opts)  # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        ids, dists, rounds, per_q, imb = [], [], [], [], []
        t0 = time.perf_counter()
        for s in range(0, nq, BATCH):
            i, d, st = flat_index.bss_knn_batched(view, queries[s:s + BATCH], KNN_K, opts=opts)
            ids.append(i)
            dists.append(d)
            rounds.append(st["rounds"])
            per_q.append(st["per_query_dists"])
            imb.append(st["shard_dists"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        add_counts(sharded_counts, counts)
        want = {entry: n_shards * len(rounds), "planar_lower_bound_pairs": n_shards * len(rounds),
                "masked_" + entry: n_shards * sum(rounds)}
        if precision == "bf16":
            want["masked_" + entry + "_bf16"] = n_shards * sum(rounds)
        expect_launches(failures, f"sharded {metric} {precision} kNN S={n_shards}", counts, want)
        equal = dict(ids=bool(np.array_equal(np.concatenate(ids), single["ids"])),
                     dists=same_bits(np, np.concatenate(dists), single["dists"]),
                     rounds=rounds == single["rounds"],
                     per_query_dists=bool(np.array_equal(np.concatenate(per_q),
                                                         single["per_query"])))
        rows.append(dict(metric=metric, precision=precision, shards=n_shards, k=KNN_K,
                         seconds=secs, queries_per_s=nq / secs,
                         phase5_single_fp32_queries_per_s=nq / single["secs"],
                         rounds_per_batch=rounds, shard_imbalance=shard_imbalance(sum(imb)),
                         equal_to_single=equal))
        if not all(equal.values()):
            failures.append(f"sharded {precision} kNN {metric} S={n_shards} differs from the "
                            f"single-device cuda run: {equal}")
    single_secs.append(time_single())
    secs1 = sum(single_secs) / len(single_secs)
    for row in rows:
        row.update(single_queries_per_s=nq / secs1, speed_vs_single=secs1 / row["seconds"],
                   single_seconds_before_after=single_secs)
        record.setdefault("sharded knn", []).append(row)
        log("sharded knn " + json.dumps(row))


def sharded_living_corpus(torch, np, failures: list, record: dict, dev, corpus, queries, cfg,
                          t: float) -> None:
    """The living corpus on 4 shards (l2): build on 99,000 rows (774
    blocks, padded to 776), append one block (it fits the padding: written
    in place, no library loaded again, no shard tensor reshaped, the old
    generation's tensors unchanged), append 1% (re-laid out), delete 1% of
    the ids, compact.  Each generation is held to a single-device index put
    through the same mutations, bit for bit: range (fp32 and bf16) and kNN
    on two batches."""
    from repro_torch.core import flat_index
    from repro_torch.core.backends import EngineOpts
    from repro_torch.index import append, compact, delete
    from repro_torch.kernels import _build
    from repro_torch.parallel import local_mesh

    corpus32 = corpus.astype(np.float32)
    q = queries[:2 * BATCH].astype(np.float32)
    n0, small, big = 99_000, 128, len(corpus32) // 100
    mesh = local_mesh(4)
    row = dict(shards=4, built_on=n0, generations=[])

    def check(sharded, single, label):
        eq = {}
        for precision in ("fp32", "bf16"):
            opts = EngineOpts(backend="cuda", precision=precision)
            for s in (0, BATCH):
                h, st = flat_index.bss_query_batched(sharded, q[s:s + BATCH], t, opts=opts)
                wh, wst = flat_index.bss_query_batched(single, q[s:s + BATCH], t, opts=opts)
                eq[f"range {precision} {s}"] = (
                    h == wh and st["n_shards"] == 4
                    and bool(np.array_equal(st["per_query_dists"], wst["per_query_dists"])))
                k = flat_index.bss_knn_batched(sharded, q[s:s + BATCH], KNN_K, opts=opts)
                wk = flat_index.bss_knn_batched(single, q[s:s + BATCH], KNN_K, opts=opts)
                eq[f"knn {precision} {s}"] = (
                    bool(np.array_equal(k[0], wk[0])) and same_bits(np, k[1], wk[1])
                    and k[2]["rounds"] == wk[2]["rounds"]
                    and bool(np.array_equal(k[2]["per_query_dists"], wk[2]["per_query_dists"])))
        gen = dict(label=label, generation=sharded.generation, n_blocks=sharded.n_blocks,
                   n_blocks_pad=sharded.sharded().n_blocks_pad, equal=all(eq.values()))
        row["generations"].append(gen)
        log("sharded living corpus " + json.dumps(gen))
        if not gen["equal"]:
            failures.append(f"sharded living corpus {label}: {eq}")

    idx0 = flat_index.build_bss("l2", corpus32[:n0], cfg.n_pivots, cfg.n_pairs, cfg.block,
                                mesh=mesh)
    one0 = flat_index.build_bss("l2", corpus32[:n0], cfg.n_pivots, cfg.n_pairs, cfg.block,
                                device=dev)
    check(idx0, one0, f"built on {n0} rows")
    s0 = idx0.sharded()
    shapes = [tuple(getattr(sh, f).shape) for sh in s0.shards for f in sh._fields]
    old = [[getattr(sh, f).clone() for f in sh._fields] for sh in s0.shards]
    old16 = [d.clone() for d in s0.data16]
    loads = {s: _build.load_count(s) for s in _build.SOURCES}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx1, ms1 = append(idx0, corpus32[n0:n0 + small])
    torch.cuda.synchronize()
    row["in_place_append_seconds"] = time.perf_counter() - t0
    one1, _ = append(one0, corpus32[n0:n0 + small])
    check(idx1, one1, "appended one block in place")
    s1 = idx1.sharded()
    row["in_place"] = dict(
        sharded_in_place=ms1.sharded_in_place,
        shapes_unchanged=[tuple(getattr(sh, f).shape)
                          for sh in s1.shards for f in sh._fields] == shapes,
        libraries_not_reloaded={s: _build.load_count(s) for s in _build.SOURCES} == loads,
        old_generation_untouched=all(
            torch.equal(getattr(sh, f), o) for sh, os_ in zip(s0.shards, old)
            for f, o in zip(sh._fields, os_)) and all(
            torch.equal(a, b) for a, b in zip(s0.data16, old16)),
        shards_rewritten=sum(a is not b for a, b in zip(s0.shards, s1.shards)))
    idx2, ms2 = append(idx1, corpus32[n0 + small:n0 + small + big])
    one2, _ = append(one1, corpus32[n0 + small:n0 + small + big])
    row["relaid_out"] = not ms2.sharded_in_place and idx2._sharded is None
    check(idx2, one2, "appended 1%, re-laid out")
    dead = np.random.default_rng(5).choice(n0, size=n0 // 100, replace=False).tolist()
    valid_before = [sh.valid.clone() for sh in idx2.sharded().shards]
    idx3, _ = delete(idx2, dead)
    one3, _ = delete(one2, dead)
    row["delete_old_valid_untouched"] = all(
        torch.equal(a, sh.valid) for a, sh in zip(valid_before, idx2.sharded().shards))
    check(idx3, one3, "deleted 1%")
    idx4, _ = compact(idx3)
    one4, _ = compact(one3)
    row["compact_keeps_mesh"] = idx4.mesh is mesh
    check(idx4, one4, "compacted")
    record["sharded living corpus"] = row
    log("sharded living corpus " + json.dumps(
        {k: v for k, v in row.items() if k != "generations"}))
    ok = (all(row["in_place"][k] for k in ("sharded_in_place", "shapes_unchanged",
                                           "libraries_not_reloaded", "old_generation_untouched"))
          and row["relaid_out"] and row["delete_old_valid_untouched"] and row["compact_keeps_mesh"])
    if not ok:
        failures.append(f"sharded living corpus: {row}")


def sharded_serving(torch, np, failures: list, record: dict, corpus, queries, cfg, ts: list,
                    n_requests: int = 4 * BATCH) -> None:
    """One wave through the ``ServingFront`` of a ``RetrievalServer(mesh=
    local_mesh(4))`` (l2): every result equal to a direct sharded call on
    the batch the front formed (``check_served``)."""
    from repro_torch.serve.retrieval import RetrievalServer
    from repro_torch.parallel import local_mesh

    corpus32, queries32 = corpus.astype(np.float32), queries.astype(np.float32)
    t0 = time.perf_counter()
    server = RetrievalServer(corpus32, metric="l2", n_pivots=cfg.n_pivots, n_pairs=cfg.n_pairs,
                             block=cfg.block, mesh=local_mesh(4))
    row = dict(metric="l2", shards=4, build_seconds=time.perf_counter() - t0)
    with server.async_front(max_delay_s=0.002, cache_size=4096) as front:
        snapshots = {front.index.generation: front.index}
        reqs = serving_requests(np, n_requests, ts, seed=4)
        res, errors, secs = serve_wave(front, queries32, reqs)
        st = front.stats()
        snap = front.metrics().snapshot()
        rec = front.explain()
    row.update(serving_numbers(np, res, secs))
    row.update({k: st[k] for k in ("completed", "errors", "batches", "per_bucket_batches",
                                   "padding_waste")})
    row["shard_imbalance"] = {k: v for k, v in snap["gauges"].items()
                              if k.startswith("shard/imbalance")}
    row["explain_shard_dists"] = rec.get("shard_dists")
    row["checks"] = check_served(np, snapshots, queries32, reqs, res)
    record["sharded serving"] = row
    log("sharded serving " + json.dumps(row))
    c = row["checks"]
    if (errors or st["errors"] or c["same_batch"]["differing"] or c["other_batch"]["differing"]
            or not row["shard_imbalance"] or len(rec.get("shard_dists", [])) != 4):
        failures.append(f"sharded serving: failed requests {errors[:3]}, differences "
                        f"{c['same_batch']['first'], c['other_batch']['first']}, gauges "
                        f"{row['shard_imbalance']}, explain {rec}")


def sharded_profiles(torch, np, record: dict, queries, paths: dict) -> None:
    """Four batches of S = 1 (the single-device engine) and S = 4 under the
    profiler, l2 and JSD at selectivity 1e-3: ms per batch, the device's
    idle share and the port's launches per batch."""
    from repro_torch.core import flat_index
    from repro_torch.core.backends import EngineOpts

    for metric in ("l2", "jsd"):
        index, t = paths[metric]["index"], paths[metric]["ts"][-1]
        for n_shards, idx in ((1, index), (4, mesh_view(index, 4))):
            prof = profile_batches(torch, lambda qb: flat_index.bss_query_batched(
                idx, qb, t, opts=EngineOpts(backend="cuda")), queries, t=t, shards=n_shards)
            prof["launches_per_batch"] = prof["port_kernel_launches"] / prof["batches"]
            record.setdefault("sharded profile", []).append(
                {k: prof[k] for k in ("t", "shards", "batch_ms", "traced_batch_ms",
                                      "device_busy_ms_per_batch", "device_idle_share",
                                      "launches_per_batch", "port_kernel_events")})
            log(f"profile sharded {metric} S={n_shards} " + json.dumps(prof))


def sharded_distinct_devices(torch, np, failures: list, record: dict, queries, single: dict,
                             t: float) -> None:
    """One shard per card, where the host has two or more: two l2 range
    batches against the single-device run.  Skipped,
    and said so, on a one-card machine: the skip is no pass."""
    from repro_torch.core import flat_index
    from repro_torch.core.backends import EngineOpts
    from repro_torch.parallel import local_mesh

    n = torch.cuda.device_count()
    if n < 2:
        record["sharded distinct devices"] = f"skipped: {n} CUDA device (needs 2)"
        log(f"sharded distinct devices: SKIPPED, not run, not passed: this machine has {n} "
            f"CUDA device")
        return
    view = dataclasses.replace(single["index"], mesh=local_mesh(), _device=None, _bf16=None,
                               _sharded=None)
    (w_hits, w_stats) = single["fp32"][t]
    hits, _ = run_queries(flat_index, EngineOpts, view, queries[:2 * BATCH], t, "cuda")
    ok = hits == w_hits[:2 * BATCH]
    record["sharded distinct devices"] = dict(devices=n, equal=ok)
    log("sharded distinct devices " + json.dumps(record["sharded distinct devices"]))
    if not ok:
        failures.append("sharded distinct devices: hits differ from the single-device run")


def plain_l2(torch, np, dev, cfg) -> dict:
    """The plain ``"torch"`` backend's l2 range search on the card: all
    queries at the three calibrated thresholds, in batches of BATCH."""
    from repro_torch.configs.supermetric import build_index
    from repro_torch.core import flat_index
    from repro_torch.core.backends import EngineOpts
    from repro_torch.data.metricsets import calibrate_threshold

    corpus, queries = load(np, cfg)
    index = build_index(cfg, corpus, device=dev)
    ts = [calibrate_threshold("l2", corpus, s) for s in cfg.selectivities]
    run_queries(flat_index, EngineOpts, index, queries[:BATCH], ts[0], "torch")  # warm-up
    out = {}
    for t in ts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hits, _ = run_queries(flat_index, EngineOpts, index, queries, t, "torch")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[str(t)] = dict(seconds=secs, queries_per_s=len(queries) / secs,
                           ms_per_batch=secs * 1e3 / -(-len(queries) // BATCH),
                           hits=sum(len(h) for h in hits))
        log(f"plain l2 t={t} " + json.dumps(out[str(t)]))
    return out


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
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    sm_mhz = float(clk.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    CARD["sfu_rate"] = SFU_PER_SM_CLOCK * sms * sm_mhz * 1e6
    CARD["issue_rate"] = ISSUE_PER_SM_CLOCK * sms * sm_mhz * 1e6
    CARD["minmax_rate"] = MINMAX_PER_SM_CLOCK * sms * sm_mhz * 1e6
    log(f"instruction issue {CARD['issue_rate']:.6g} / FMNMX {CARD['minmax_rate']:.6g} lane "
        f"instructions/s: {ISSUE_PER_SM_CLOCK} / {MINMAX_PER_SM_CLOCK} per SM per clock")
    log(f"SFU rate {CARD['sfu_rate']:.6g} results/s: {SFU_PER_SM_CLOCK} per SM per clock x "
        f"{sms} SMs x {sm_mhz} MHz (clocks.max.sm)")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is still enabled")

    from repro_torch.configs.supermetric import SISAP_COLORS
    from repro_torch.kernels import _build

    failures: list[str] = []
    start = time.perf_counter()
    secs = _build.build()
    log(f"build: {len(_build.SOURCES)} sources in {secs:.2f} s "
        f"(phase {time.perf_counter() - start:.2f} s)")
    for name in _build.SOURCES:
        for line in _build.compiler_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    kernels, record, paths, bf16_paths, knns, serving_counts = {}, {}, {}, {}, {}, {}
    forest, forest_counts = {}, {}
    sharded_s4, sharded_counts = {}, {}
    dev = torch.device("cuda")
    data = {}
    if "--plain-l2" in sys.argv[1:]:
        # the plain "torch" backend's l2 range search alone (all queries,
        # the three thresholds), e.g. beside another checkout's (copy this
        # script there)
        record["plain l2"] = plain_l2(torch, np, dev, SISAP_COLORS)
        log(json.dumps(record))
        return 0
    if "--tiles-only" in sys.argv[1:]:
        # the tile kernels alone, e.g. beside another checkout's (copy this
        # script and core/precision.py there): the planar kernel at the
        # main path's shapes, the JSD / Triangular small-distance errors,
        # what the masked l2 tile's time is made of, and for each metric's
        # range path (selectivity 1e-3, first batch) its bound phase and its
        # masked tile (fp32 and bf16), timed alone with their outputs' sha256
        from repro_torch.configs.supermetric import build_index
        from repro_torch.data.metricsets import calibrate_threshold

        record["planar alone"] = planar_alone(torch, np, dev)
        record["small distances"] = prob_small_distances(torch, np, failures, dev)
        record["l2 tile breakdown"] = l2_tile_breakdown(torch, np, dev)
        corpus, queries = load(np, SISAP_COLORS)
        for metric in ("l2", *PROB):
            index = build_index(dataclasses.replace(SISAP_COLORS, metric=metric), corpus,
                                device=dev)
            record[f"{metric} bound phase"] = bound_phase_alone(torch, index, queries, metric)
            t = calibrate_threshold(metric, corpus, 1e-3)
            for precision in ("fp32", "bf16"):
                record[f"{metric} {precision}"] = exact_phase_alone(
                    torch, index, queries, t, metric, precision)
        log(json.dumps(record))
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1 if failures else 0

    def range_phase(metric):
        paths[metric] = range_path(torch, np, failures, record, dev, *data["colors"],
                                   metric, SISAP_COLORS)

    def knn_phase():
        for metric in ("l2", "jsd", "triangular"):
            # the plain backend takes 1.7 s a JSD batch: its first 4 batches
            knns[metric] = knn_path(torch, np, failures, record, dev, *data["colors"], metric,
                                    SISAP_COLORS, plain_batches=PLAIN_QUERIES // BATCH)
        knn_path(torch, np, failures, record, dev, *data["colors"], "cosine", SISAP_COLORS,
                 n_queries=BATCH)

    def forest_phase(counts: dict) -> None:
        for k, v in counts.items():
            forest_counts[k] = forest_counts.get(k, 0) + v

    def forest_l2_phase():
        forest["l2"] = forest_l2(torch, np, failures, record, dev, *data["colors"],
                                 SISAP_COLORS, paths["l2"]["ts"], record["l2"])
        forest_phase(forest["l2"]["counts"])

    phases = (
        ("kernels", lambda: kernels.update(check_kernels(torch, np, failures, dev))),
        ("prob small distances", lambda: record.update(
            small_distances=prob_small_distances(torch, np, failures, dev))),
        ("corpus", lambda: data.update(colors=load(np, SISAP_COLORS))),
        ("range l2", lambda: range_phase("l2")),
        ("range jsd", lambda: range_phase("jsd")),
        ("range triangular", lambda: range_phase("triangular")),
        ("masked prob kernels", lambda: kernels.update(check_masked_prob(
            torch, np, failures, dev,
            {m: paths[m]["live_share"] for m in PROB}))),
        ("knn", knn_phase),
        *((f"bf16 range {m}", lambda m=m: bf16_paths.update({m: bf16_range_path(
            torch, np, failures, record, data["colors"][1], m, SISAP_COLORS, paths[m])}))
          for m in ("l2", "jsd", "triangular")),
        ("bf16 kernels", lambda: kernels.update(check_bf16_kernels(
            torch, np, failures, dev, {m: p["live_share"] for m, p in bf16_paths.items()}))),
        *((f"bf16 knn {m}", lambda m=m: bf16_knn_path(
            torch, np, failures, record, data["colors"][1], m, knns[m]))
          for m in ("l2", "jsd")),
        *((f"living corpus {m}", lambda m=m: living_corpus(
            torch, np, failures, record, dev, *data["colors"], m, SISAP_COLORS,
            paths[m]["ts"][SISAP_COLORS.selectivities.index(1e-3)]))
          for m in ("l2", "jsd")),
        ("serving l2", lambda: serving_counts.update(l2=serving(
            torch, np, failures, record, *data["colors"], "l2", SISAP_COLORS,
            paths["l2"]["ts"]))),
        ("serving jsd", lambda: serving_counts.update(jsd=serving(
            torch, np, failures, record, *data["colors"], "jsd", SISAP_COLORS,
            paths["jsd"]["ts"], n_requests=4 * BATCH, mutate=False))),
        ("forest l2", forest_l2_phase),
        ("forest bf16", lambda: forest_phase(forest_bf16(
            torch, np, failures, record, data["colors"][1], SISAP_COLORS, forest["l2"]))),
        ("forest monotone", lambda: forest_phase(forest_monotone(
            torch, np, failures, record, dev, *data["colors"], SISAP_COLORS,
            paths["l2"]["ts"][-1]))),
        ("forest jsd", lambda: forest_phase(forest_jsd(
            torch, np, failures, record, dev, *data["colors"], SISAP_COLORS,
            paths["jsd"]["ts"][-1]))),
        ("serving forest", lambda: forest_phase(serving_forest(
            torch, np, failures, record, *data["colors"], paths["l2"]["ts"]))),
        *((f"sharded range {m}", lambda m=m: sharded_s4.update({m: sharded_range(
            torch, np, failures, record, data["colors"][1], m, SISAP_COLORS, paths[m],
            sharded_counts)})) for m in ("l2", "jsd", "triangular")),
        ("sharded bf16 range", lambda: [sharded_bf16_range(
            torch, np, failures, record, data["colors"][1], m, sharded_s4[m],
            paths[m]["ts"][SISAP_COLORS.selectivities.index(1e-3)], sharded_counts)
            for m in ("l2", "jsd", "triangular")]),
        ("sharded knn", lambda: [sharded_knn(
            torch, np, failures, record, data["colors"][1], m, knns[m], sharded_counts, *args)
            for m, args in (("l2", ()), ("jsd", ()), ("l2", ((4,), "bf16")))]),
        ("sharded living corpus", lambda: sharded_living_corpus(
            torch, np, failures, record, dev, *data["colors"], SISAP_COLORS,
            paths["l2"]["ts"][SISAP_COLORS.selectivities.index(1e-3)])),
        ("sharded serving", lambda: sharded_serving(
            torch, np, failures, record, *data["colors"], SISAP_COLORS, paths["l2"]["ts"])),
        ("sharded profiles", lambda: sharded_profiles(
            torch, np, record, data["colors"][1], paths)),
        ("sharded distinct devices", lambda: sharded_distinct_devices(
            torch, np, failures, record, data["colors"][1], paths["l2"],
            paths["l2"]["ts"][SISAP_COLORS.selectivities.index(1e-3)])),
    )
    for phase, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # report every phase, then fail
            failures.append(f"phase {phase} raised:\n{traceback.format_exc()}")
        log(f"phase {phase}: {time.perf_counter() - t0:.2f} s")

    # launches of each kernel on the range path of its metric and precision
    for name, rec in kernels.items():
        entry = "pairwise_jsd" if name == "ops.pairwise_jsd" else name
        metric = next((m for m, e in PROB.items() if e in entry), "l2")
        on_path = bf16_paths if entry.endswith("_bf16") else paths
        rec["launches"] = int(on_path.get(metric, {}).get("counts", {}).get(entry, 0))
        rec["serving_launches"] = int(serving_counts.get(metric, {}).get(entry, 0))
        rec["forest_launches"] = int(forest_counts.get(entry, 0))
        rec["sharded_launches"] = int(sharded_counts.get(entry, 0))
        if entry in SHARDED_PATH and rec["sharded_launches"] <= 0:
            failures.append(f"kernel {name} was not launched by the sharded phases")
        if entry in FOREST_PATH and rec["forest_launches"] <= 0:
            failures.append(f"kernel {name} was not launched by the forest")
        if entry in OFF_PATH:
            rec["on_main_path"] = False
        elif rec["launches"] <= 0:
            failures.append(f"kernel {name} was not launched on the main path")
    log(f"total: {time.perf_counter() - start:.2f} s")
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
