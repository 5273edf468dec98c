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
   metric's run and read just after.  The thresholds are
   ``calibrate_threshold``'s, read off one distance matrix per metric
   drawn when the corpus loads (phase 19 holds them bit-equal to
   ``calibrate_threshold``'s own).  Checked against
   the plain ``"torch"`` backend on the same card (all queries) and the
   numpy oracle on 64 queries: a hit that differs must lie within 1e-5 *
   max(1, t) of t in
   float64, an ``alive`` cell that differs must have its bound within 1e-5
   of t.  For JSD and Triangular, the largest |d_cuda - d_float64| over
   the first batch's cells within ``band_eps`` of each threshold is printed
   beside the derived error budget (csrc/prob_dist.cu) and the bf16
   margin's arithmetic term: a cell over budget fails the run, and so does
   twice the budget over the arithmetic term.  One l2 batch is repeated
   for cosine.  Four batches of each
   backend run under ``torch.profiler`` and ``cProfile`` (l2 at the
   narrowest and widest threshold, JSD and Triangular at the widest):
   device time and trace events per kernel (sort kernels counted apart),
   host time per operator and Python function, and the device's idle
   share.  Each metric's masked tile of the first batch at the widest
   threshold is then timed alone with CUDA events on the inputs and mask
   the engine gave it (fp32 here, bf16 in phase 6), beside the bound of
   that mask, the SM clock and power nvidia-smi reads meanwhile, and a
   sha256 of its output (bit-equality with another commit).
5. kNN (k = 10): all queries in 512-query batches through
   ``bss_knn_batched`` under l2, JSD and Triangular on ``"cuda"``, plus one
   cosine batch, each on its range path's index; launch counts zeroed and
   read per metric.  The plain ``"torch"`` backend runs all queries under
   l2 and the first four batches (2,048 queries) under JSD and
   Triangular.  Ids must agree
   between backends and with a float64 brute force on 64 queries, except
   where the two candidates' float64 distances lie within 1e-5 of each
   other (or of the kth); a query whose distance count differs between
   backends must have kth distances within 1e-5.  For JSD and Triangular
   the returned distances of 64 queries are held to float64 within the
   error budget, which is also printed at the smallest kth.  The round
   top-k of the first batch is timed alone per round, beside the stable
   sort it replaced.  One JSD batch of each backend is profiled.
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
   fp32 range held to the numpy oracle on 64 queries; then
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
   ``"cuda"``, the first 2,048 on ``"torch"`` too and 64 against the
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
17. Invariants: the port's audit (``repro_torch.analysis.audit``) on the
   card, every launch count zeroed before and read after: the full matrix
   (``run_audit(full=True)``: l2, cosine, JSD, Triangular x ``"cuda"`` and
   ``"torch"`` x realisation x fp32 / bf16 over BSS, sharded BSS on one
   and two shards, the forest and the monotone walk), every pass under
   ``torch.cuda.set_sync_debug_mode("error")`` and the audit's list of
   operators that sync; the rebuild audit through
   the serving front (``audit_rebuilds``); and one 512-query batch at 1e-3
   per metric (l2, JSD, Triangular) on the range path's own index through
   the range pass and one kNN round of each precision (``audit_index``).
   Any problem fails the run.  Before it, ``calibrate_threshold`` starts
   in background threads for every (metric, selectivity) of phase 4.
18. Quickstart: ``examples/torch_quickstart.py --device cuda`` at its own
   size (10,000 x 64, 100 queries) in a subprocess, which must exit 0.
   Beside it, in subprocesses started together (so none runs beside a
   timed call), each exiting 0: the launcher ``python -m
   repro_torch.launch.serve`` at its defaults and with ``--min-score
   0.5``, ``python -m repro_torch.launch.train --arch two-tower-retrieval
   --reduced --steps 20`` and ``examples/torch_retrieval_serving.py
   --steps 20 --corpus 5000 --queries 32`` (these two printing finite
   losses), the same training launcher on the reduced Llama-3.2-1B and
   PNA (``--arch llama3.2-1b`` / ``--arch pna``, finite losses), and
   ``examples/torch_lm_embedding_retrieval.py`` at its defaults
   (printing ``exact=True``).
19. The threshold check: those ``calibrate_threshold`` values must equal
   the thresholds the range paths used, bit for bit (which joins their
   threads before phase 20 times anything).
20. Two tower train: the full two-tower config (``TWO_TOWER``: vocab
   10^6, bf16, tower MLP 1024-512-256, 256 dims, 8 user and 4 item
   fields), its weights drawn by ``init_params`` from a CUDA generator
   seeded 0 (parameter bytes, peak device memory), trained by ``TrainLoop``
   for 20 steps of ``ClickStream`` batches of 32,768 rows (seed 0) with
   AdamW at lr 3e-3, one checkpoint (``keep_last=1``) under ``build/``
   after printing the free disk space.  Prints each step's ms by host
   clock, the first and last five losses, peak memory, the checkpoint's
   bytes and its save and restore seconds.  The checkpoint is restored onto
   the card: every leaf must equal the live state's bit for bit (bf16 by
   its bits) and the stream's state must come back; one further step from
   the live state (forward + backward and the optimizer timed apart by
   CUDA events) and one from the restored state (the whole step) must give
   the same parameters, optimizer state and loss bit for bit.  Every loss
   must be finite.  The restored parameters go on to phase 21.  Prints the
   (B, B) part of the forward + backward's peak memory and 65,536 rows
   reckoned from it.
21. Two tower: the recsys family's serving path at the full two-tower
   config over phase 20's trained model.  The bf16 towers on 256 user
   and 256 item rows against the float32 CPU forward over the same
   weights: every row's cosine at least 0.999, nearest its own of the CPU
   rows, and its distance to it at most their median pairwise distance
   (untrained rows lie in a narrow cone); a float32 copy of the towers on
   the card within 1e-5 of the CPU, each row nearest its own CPU row.  1,000,000 items embedded in chunks of 262,144
   and 512 users (ms a chunk by CUDA events), the corpus's geometry (mean
   row norm, median pairwise and nearest-neighbour distance of a 4,096-row
   sample, rows equal to another in bf16).  ``RetrievalServer`` (cosine;
   16 pivots, 24 planes, 128-row blocks: 7,813 blocks) built on the card;
   with every launch count zeroed just before and read just after: kNN
   (k = 10) in fp32 and bf16, ``range_query`` at the min-score whose
   distance is the 1e-5 quantile of the float64 distances of 64 users, and
   range in fp32 and bf16.  Then the plain ``"torch"`` backend on all 512
   users and the float64 brute force on 64, held by the rules of phases 4
   and 5 (ties within 1e-5 counted, not failed), and bf16 equal to fp32 in
   every field.  ``forward`` with the index's candidates and
   ``forward_retrieval_pruned`` (budget 3,136 blocks) on 8 single-user
   calls: recall of the dense top-10, ms a call.  Rows 1, 3b, 2 (at the
   path's live share and at 30%) and 2b at these shapes (K = 256) against
   their plain versions.  Wide&Deep, DIN and DLRM-RM2 at their full
   configs: one 512-row forward on the card against the float32 CPU
   forward (relative error within ``CTR_REL``), ``bce_loss``.  The
   untrained corpus's figures (PERF.md §6) are printed beside the
   trained one's.
22. LM: the LM family's serving path (``repro_torch.models.transformer``)
   at full width, weights drawn by ``init_params`` from a CUDA generator
   seeded 0, prompts from ``TokenStream`` (seed 0).  The full Llama-3.2-1B
   (bf16): ``prefill`` of 4 x 2,048 tokens and 32 greedy ``decode_step``s
   into a 2,080-slot bf16 cache; prefill's logits, and the first two
   decode steps', within 2e-2 of max|logit| of ``forward`` over the same
   (grown) sequence; a float32 copy on the card within 1e-4 of the float32
   CPU forward on 1 x 64 tokens; the bf16 last-position logits within
   0.05 of the float32 copy's (argmax agreement printed).  Then 32,768 +
   512 windows of 32 tokens embedded by the example's ``embed_windows``
   (256 a batch) and searched as the example does (``calibrate_threshold``
   at 2e-3, ``build_bss("l2", n_pivots=12, n_pairs=16, block=128)``), the
   512 queries through ``bss_query_batched`` on ``"cuda"`` in fp32 and bf16
   with every launch count zeroed just before and read just after; held
   to ``"torch"`` (all queries), the numpy oracle and the float64
   exhaustive search (64), a differing hit only where its float64 distance
   lies within the identity's rounding of t (``identity_hit_diffs``), bf16
   equal to fp32 in every field; rows 1, 3b, 2 and 2b at these shapes (K =
   2,048), the l2 rows held by ``identity_compare``.  The full Gemma 2 9B:
   ``prefill`` of 1 x 8,192 tokens (past the 4,096 window) against
   ``forward``; 16 greedy decode steps with a bf16 cache and the same
   tokens through the config's int8 cache (last logits within 5%).
   Phi-3.5-MoE at full width cut to 2 layers: prefill 2,048 and 8 decode
   steps, the pairs past capacity and the load per expert of each MoE
   call, a float32 copy on the card against the CPU.  Prints ms, tokens/s,
   peak memory and the card's name and power limit.
23. LM train: the full Llama-3.2-1B (drawn afresh from seed 0, as phase
   22 drew it; bf16, remat on) trained on one ``TokenStream`` batch of
   2 x 4,096 tokens (``train_4k`` cut in batch: PERF.md §4) with AdamW at
   lr 3e-4 for 4 steps after an untimed step over 256 tokens: each step's
   ms by CUDA events and host clock, loss and peak memory; the losses
   finite and falling; a step run twice from one state equal in the loss,
   every gradient, parameter and moment, bit for bit; a float32 copy cut
   to 2 layers, 256 tokens, against the CPU (loss within 1e-5 relative,
   each gradient leaf within 1e-4 of its largest).  Then Phi-3.5-MoE at
   full width, 2 layers: one bf16 step over its 4 microbatches of 512
   tokens (float32 accumulation) with its config's AdamW applied in place,
   run twice bit-equal, peak memory, the pairs past capacity counted; a
   float32 copy cut to 1 layer, 64 tokens, against the CPU.
24. GNN train: PNA on ``full_graph_sm``, ``minibatch_lg`` (a
   ``NeighborSampler`` draw, 1,024 seeds at fanout 15-10, over a synthetic
   graph of 232,965 nodes and 602 features) and ``molecule`` at their
   padded shapes, the nodes relabelled so each of 512 blocks fits the
   cell's E_loc: flat and dst-partitioned logits within 1e-5; 4 AdamW
   steps (lr 3e-4) in each layout, finite and falling; a step run twice
   and a checkpoint restored and stepped, bit-equal; one step of each
   layout under torch.profiler (device busy ms, idle share, kernel
   events, the host's top operators); the float32 segment ops, forward
   and backward, at the cell's shapes equal to the CPU's bits.  Then, with
   every timed step done, the CPU references: the float32 loss on the card
   within 1e-5 of the CPU's; the float64 gradients within 1e-5 of each
   leaf's largest; each float32 gradient leaf within 5e-2 of the CPU's
   float64 one (a bound for a wrong term: PNA's float32 gradient is
   ill-conditioned), printed beside the CPU's own float32 leaf's distance.
   ``ogb_products`` is reckoned, not run.
24b. Sharded train (``SHARDED_TRAIN``'s note): the sharded train step of
   each family on mesh devices of the one card against the one-device
   step from the same state: Llama-3.2-1B at full width, 2 layers, 2 x
   4,096 tokens on S = 2 and, split over "model", on (1, 2), (1, 4) and
   (2, 2); Phi-3.5-MoE at full width, 1 layer, 4 microbatches of 512
   tokens, expert-parallel on (1, 2) and (2, 2) (its MoE block's routing
   and output against one device's); the full two-tower config at
   B = 32,768 on S = 2 and 4 and, its tables split over "model", on
   (1, 2) and (2, 2); DLRM-RM2 at full width (vocabulary cut to 500,000)
   at B = 65,536 on (1, 2) and (2, 2); PNA's ``minibatch_lg`` over node
   shards on (2, 1) and (2, 2), and a well-conditioned graph; one-data-
   shard meshes bit for bit; the rest by the loss, each gradient leaf
   against a wider copy's (no worse than twice the one-device step's own
   gap to it), and the training bound on float32 Llama, Phi and DLRM
   copies and float64 two-tower and PNA copies; split lookups bit for
   bit with one device's; each mesh's gradient computed twice, bit for
   bit; ms a step, peak memory, the bytes each mesh device holds and
   computes with, the bytes its collectives move (PNA's halo).
24c. Dry run: per-device bytes, FLOPs and collectives of three cells that
   do not fit one card on the 16 x 16 meta mesh (``launch.dryrun``).
25. One JSON line with every kernel's numbers (``launches`` from the range
   path of its metric and precision, ``serving_launches`` from the serving
   phase, ``forest_launches`` from the forest phases, which must have
   launched the masked l2, bf16 l2 and JSD tiles, ``sharded_launches``
   from the sharded phases, nonzero for every kernel a shard launches;
   ``audit_launches`` from the invariants phase, nonzero for every kernel
   on an engine path; ``two_tower_launches`` from phase 21's serving
   calls, nonzero for rows 1, 2, 2b and 3b, whose records also carry
   ``two_tower``: their numbers at that path's shapes; ``lm_launches``
   from phase 22's search, nonzero for the same rows, whose records also
   carry ``lm`` at K = 2,048; the unmasked bf16
   forms and the d1/d2 form of the planar bound are on no engine path and
   carry ``"on_main_path": false``), then the result line ``{"ok": true,
   "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import hashlib
from concurrent.futures import ThreadPoolExecutor
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
ORACLE_QUERIES = 64  # queries held to the float64 oracles
# threads for the float64 host work numpy can split without changing a bit
# (its array loops release the interpreter lock; the card's host has 8 cores)
HOST_THREADS = 4
PLAIN_KNN_BATCHES = 4  # the plain JSD / Triangular kNN: 1.7 s a JSD batch
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


def identity_compare(torch, got, want, x, y, rtol=RTOL) -> tuple[float, bool, bool]:
    """``compare`` for two fp32 evaluations of l2 by the identity |x|^2 +
    |y|^2 - 2 x.y over rows far from the origin (the LM corpus, PERF.md
    §2): the identity cancels terms of size |x|^2 + |y|^2, and its rounding
    (sigma ~ 2^-24 sqrt(K/3) sqrt(6) |x|^2, 3.8e-6 |x|^2 at K = 2,048) is a
    share of those, not of d.  So d^2 is held within rtol of |x|^2 + |y|^2,
    about five sigma.  Returns (max abs error of d, same +inf, within)."""
    same_inf = bool(torch.equal(torch.isinf(got), torch.isinf(want)))
    fin = torch.isfinite(want)
    scale = (x.float() ** 2).sum(1)[:, None] + (y.float() ** 2).sum(1)[None, :]
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    diff2 = (got.float() ** 2 - want.float() ** 2).abs()
    close = bool((diff2[fin] <= rtol * scale.expand_as(got)[fin]).all())
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


def random_mask(np, rng, shape, share: float, dead_row: bool = True):
    """A (query tiles, blocks) tile mask, each tile live with probability
    ``share``; tile row 1 all dead (the dead-tile path) if ``dead_row``."""
    mask = rng.random(shape) < share
    if dead_row:
        mask[1] = False
    return mask


def tile_bound(metric: str, q: int, n: int, k: int, y_bytes: int = 4) -> tuple[float, str]:
    """bound_ms of an unmasked (Q, N) tile: x, y and the output once; l2
    does 2 operations an (i, j, k) plus its norms and epilogue at the fp32
    peak, JSD / Triangular one SFU result an (i, j, k)."""
    n_bytes = 4 * (q * k + q * n) + y_bytes * n * k
    if metric == "l2":
        return bound_ms(n_bytes, 2 * q * n * k + 2 * (q + n) * k + 4 * q * n)
    return bound_ms(n_bytes, q * n * k, CARD["sfu_rate"])


def masked_tile_bound(metric: str, mask_np, q: int, n: int, k: int, bq: int, blk: int,
                      y_bytes: int = 4) -> tuple[float, str]:
    """bound_ms of a masked (Q, N) tile: the rows of x and of y that a live
    tile reads, the output and the mask once; the operations of the live
    tiles alone (l2: 2 an (i, j, k) at the fp32 peak; JSD / Triangular: one
    SFU result)."""
    live = int(mask_np.sum()) * bq * blk
    rows = int(mask_np.any(axis=1).sum()) * bq
    cols = int(mask_np.any(axis=0).sum()) * blk
    n_bytes = 4 * (rows * k + q * n + mask_np.size) + y_bytes * cols * k
    if metric == "l2":
        return bound_ms(n_bytes, 2 * live * k)
    return bound_ms(n_bytes, live * k, CARD["sfu_rate"])


def planar_pairs_bound(q: int, p: int, m: int, b: int) -> tuple[float, str]:
    """bound_ms of the pairs form of the planar bound (row 3b): the (Q, P)
    query -> pivot matrix, the int64 pairs, the deltas and the boxes."""
    return planar_bound_ms(q, m, b, 4 * q * p + 8 * 2 * m + 4 * (m + 4 * b * m))


def l2_pivot_check(torch, x, piv, plain_iters: int, identity: bool = False
                   ) -> tuple[dict, bool]:
    """Row 1, the unmasked l2 tile, on (x, piv) against its plain version:
    (its numbers, within RTOL / ATOL with the same +inf; ``identity``:
    ``identity_compare``)."""
    from repro_torch.kernels import pairwise_dist as pdist
    from repro_torch.kernels import ref

    got, want = pdist.pairwise_l2_kernel_call(x, piv), ref.pairwise_l2_ref(x, piv)
    err, same_inf, close = (identity_compare(torch, got, want, x, piv) if identity
                            else compare(torch, got, want))
    nb, by = tile_bound("l2", x.shape[0], piv.shape[0], x.shape[1])
    return dict(max_abs_err=err, ms=device_ms(torch, lambda: pdist.pairwise_l2_kernel_call(x, piv)),
                plain_ms=time_ms(torch, lambda: ref.pairwise_l2_ref(x, piv), plain_iters),
                bound_ms=nb, bound_by=by,
                library_ms=device_ms(torch, lambda: torch.cdist(x, piv))), same_inf and close


def masked_check(torch, metric: str, x, y, mask_np, bq: int, blk: int, iters: int = 20,
                 plain_iters: int = 20, identity: bool = False) -> tuple[dict, bool]:
    """Rows 2, 5, 7 (and their bf16 ``y`` forms): the masked tile of
    ``metric`` on (x, y, mask) against its plain version, timed between
    CUDA events beside ``torch.cdist`` for l2: (its numbers, within RTOL /
    ATOL with the same +inf; ``identity``: ``identity_compare``)."""
    from repro_torch.kernels import pairwise_dist as pdist
    from repro_torch.kernels import ref

    dense = {"l2": ref.pairwise_l2_ref, "jsd": ref.pairwise_jsd_ref,
             "triangular": ref.pairwise_tri_ref}[metric]
    mask = torch.as_tensor(mask_np, device=x.device)

    def kernel():
        return pdist.masked_pairwise_kernel_call(metric, x, y, mask, bm=bq, bn=blk)

    def plain():
        return ref.masked_pairwise_metric_ref(dense(x, y), mask, bq, blk)

    got, want = kernel(), plain()
    err, same_inf, close = (identity_compare(torch, got, want, x, y) if identity
                            else compare(torch, got, want))
    del got, want
    (q, k), n = x.shape, y.shape[0]
    nb, by = masked_tile_bound(metric, mask_np, q, n, k, bq, blk, y.element_size())
    return dict(max_abs_err=err, ms=time_ms(torch, kernel, iters),
                plain_ms=time_ms(torch, plain, plain_iters), bound_ms=nb, bound_by=by,
                library_ms=(time_ms(torch, lambda: torch.cdist(x, y.float()), iters)
                            if metric == "l2" else None)), same_inf and close


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
        if e.device_type == DeviceType.CUDA and not is_span(e):
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
    numbers, ok = l2_pivot_check(torch, x, piv, 200)
    out["pairwise_l2"] = _row(failures, "pairwise_l2", "pairwise_l2", False,
                              numbers.pop("max_abs_err"), ok, **numbers)

    # planar bound (Q x B), both forms on the same inputs
    dqp, pairs, d1, d2, deltas, boxes = planar_inputs(torch, np, dev, shapes)
    for name, fn, (nb, no) in (
            ("planar_lower_bound", lambda: planar.planar_lower_bound_kernel_call(
                d1, d2, deltas, boxes), planar_bound_ms(q, m, b, 4 * (2 * q * m + m + 4 * b * m))),
            ("planar_lower_bound_pairs", lambda: planar.planar_lower_bound_pairs_kernel_call(
                dqp, pairs, deltas, boxes), planar_pairs_bound(q, p, m, b))):
        got = fn()
        want = ref.planar_lower_bound_ref(d1, d2, deltas, boxes)
        err, same_inf, _ = compare(torch, got, want)
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
    mask_np = random_mask(np, rng, (-(-q // bq), -(-n // blk)), 0.3)
    numbers, ok = masked_check(torch, "l2", x, y, mask_np, bq, blk)
    out["masked_pairwise_l2"] = _row(failures, "masked_pairwise_l2", "pairwise_l2", True,
                                     numbers.pop("max_abs_err"), ok, **numbers)

    # JSD / Triangular query -> pivot tiles (Q x P) on simplex rows
    xs, pivs = (torch.as_tensor(simplex(np, rng, r, k), device=dev) for r in (q, p))
    for metric, entry in PROB.items():
        plain = ref.pairwise_jsd_ref if metric == "jsd" else ref.pairwise_tri_ref
        got = pdist.pairwise_kernel_call(metric, xs, pivs)
        err, same_inf, close = compare(torch, got, plain(xs, pivs), PROB_RTOL, PROB_ATOL)
        nb, no = tile_bound(metric, q, p, k)
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
    nb, no = tile_bound("jsd", q, n, k)
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
    rng = np.random.default_rng(1)
    q, k, n, bq, blk = (shapes[s] for s in ("q", "k", "n", "bq", "blk"))
    x = torch.as_tensor(simplex(np, rng, q, k), device=dev)
    y = torch.as_tensor(simplex(np, rng, n, k), device=dev)
    out = {}
    for metric, entry in PROB.items():
        mask_np = random_mask(np, rng, (-(-q // bq), -(-n // blk)), live_share[metric])
        log(f"masked {metric}: live tile share {float(mask_np.mean()):.5f} (the range "
            f"path's {live_share[metric]:.5f}, one of {mask_np.shape[0]} tile rows dead)")
        numbers, ok = masked_check(torch, metric, x, y, mask_np, bq, blk, 10, 5)
        out["masked_" + entry] = _row(failures, "masked_" + entry, entry, True,
                                      numbers.pop("max_abs_err"), ok, **numbers)
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


def identity_hit_diffs(np, pairwise_np, corpus, queries, a, b, t) -> tuple[int, list, float]:
    """``boundary_hit_diffs`` of l2 hits over rows far from the origin: a
    hit may differ where its float64 distance lies within the larger of
    BAND * max(1, t) and the identity's rounding near t, RTOL * (|q|^2 +
    |y|^2) / (2 t) (``identity_compare``).  Also returns the largest
    |d - t| over that band among the differing hits."""
    n_diff, bad, worst = 0, [], 0.0
    for qi, (ha, hb) in enumerate(zip(a, b)):
        diff = sorted(set(ha) ^ set(hb))
        if not diff:
            continue
        n_diff += len(diff)
        q = queries[qi].astype(np.float64)
        ys = corpus[diff].astype(np.float64)
        d = pairwise_np("l2", queries[qi], corpus[diff])[0]
        band = np.maximum(BAND * max(1.0, t), RTOL * ((q * q).sum() + (ys * ys).sum(1)) / (2 * t))
        ratio = np.abs(d - t) / band
        worst = max(worst, float(ratio.max()))
        bad += [(qi, i) for i, r in zip(diff, ratio) if r > 1.0]
    return n_diff, bad, worst


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


def is_span(e) -> bool:
    """A ``record_function`` span's event (host or device side), the
    profiler's step span among them: it covers work, it is none."""
    return bool(getattr(e, "is_user_annotation", False)) or e.key.startswith("ProfilerStep")


def trace_device(prof) -> tuple[dict, dict]:
    """Device ms and event count per kernel in a ``torch.profiler`` trace:
    the device's own events, so an operator and its kernel are not counted
    twice; the device-side copies of spans (the engine's, the profiler's
    step) are left out."""
    from torch.autograd import DeviceType

    device, launches = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or is_span(e):
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
            and not is_span(e)}
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
               cfg, thresholds: "Thresholds", backend: str = "cuda") -> dict:
    """Phase 4 for one metric: SISAP colors at paper size through the cuda
    backend.  Returns the metric's launch counts and its mean live-tile
    share at the widest threshold."""
    from repro_torch.configs.supermetric import build_index
    from repro_torch.core import flat_index
    from repro_torch.core.backends import EngineOpts
    from repro_torch.core.npdist import pairwise_np
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.tiles import TILE_BQ

    corpus32, queries32 = corpus.astype(np.float32), queries.astype(np.float32)
    t0 = time.perf_counter()
    index = build_index(dataclasses.replace(cfg, metric=metric), corpus, device=dev)
    _ = index.device
    torch.cuda.synchronize()
    log(f"build_bss {metric}: n_pad {index.data.shape[0]} blocks {index.n_blocks} "
        f"planes {index.pairs.shape[0]} in {time.perf_counter() - t0:.2f} s")
    ts = thresholds.get(metric)
    log(f"{metric} thresholds (selectivity -> t): {dict(zip(cfg.selectivities, ts))}")
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

    # the float64 oracle: the first ORACLE_QUERIES queries' distances to
    # every row, once for the three thresholds and the kNN phase's brute
    # force (``oracle_d``); a threshold's hits in the index's storage
    # order, as ``flat_index.bss_query`` lists them
    stored = index.perm[np.nonzero(index.perm >= 0)[0]]

    def oracle():
        t0 = time.perf_counter()
        d = oracle_distances(np, pairwise_np, metric, queries32[:ORACLE_QUERIES], corpus32)
        return d, time.perf_counter() - t0

    # the plain backend's timed runs first, with nothing beside them
    plain_runs = []
    for t in ts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_hits, _ = run_queries(flat_index, EngineOpts, index, queries, t, "torch")
        torch.cuda.synchronize()
        plain_runs.append((p_hits, time.perf_counter() - t0))
    # then the float64 oracle in a thread of its own, beside the untimed
    # comparisons (numpy's loops release the lock)
    pool = ThreadPoolExecutor(1)
    o_run = pool.submit(oracle)
    for t, sel, ((hits, stats), secs), (p_hits, plain_secs) in zip(
            ts, cfg.selectivities, cuda_runs, plain_runs):
        dists, excl = per_query(stats, "per_query_dists"), per_query(stats, "excluded")
        tiles = [st["tiles_computed"] for st in stats]
        alive_c, alive_p = lb[backend] <= np.float32(t), lb["torch"] <= np.float32(t)
        alive_diff = alive_c != alive_p
        bad_alive = int((np.abs(lb["torch"][alive_diff] - t) > BAND).sum())
        n_hit_diff, bad_hits = boundary_hit_diffs(
            np, pairwise_np, metric, corpus32, queries32, hits, p_hits, t)
        d64, oracle_secs = o_run.result()
        o_hits = [stored[row[stored] <= t].tolist() for row in d64]
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
            plain_torch_queries=nq, plain_torch_queries_per_s=nq / plain_secs,
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
    pool.shutdown()

    if total_hits == 0:
        failures.append(f"the {metric} range path found no hits at any threshold")
    if metric in PROB:
        prob_error_near_t(torch, np, failures, record, index, queries32, metric, ts)
    record.setdefault("exact phase alone", {})[metric] = exact_phase_alone(
        torch, index, queries, ts[-1], metric)

    try:  # a failed profile fails the run but keeps the checks above
        for t in ((ts[0], ts[-1]) if metric == "l2" else (ts[-1],)):
            for name in (backend, "torch"):
                prof = profile_batches(
                    torch, lambda qb: flat_index.bss_query_batched(
                        index, qb, t, opts=EngineOpts(backend=name)), queries, t=t)
                log(f"profile {metric} range {name} " + json.dumps(prof))
    except Exception:
        failures.append(f"phase profile {metric} raised:\n{traceback.format_exc()}")

    cosine_index = None
    if metric == "l2":
        cosine_index = cosine_batch(np, failures, record, dev, corpus, queries32, cfg, backend)
    return dict(counts=counts, live_share=live_share, index=index, ts=ts,
                cosine_index=cosine_index, oracle_d=o_run.result()[0],
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


def cosine_batch(np, failures, record, dev, corpus, queries32, cfg, backend):
    """One cosine range batch on its own index, at the widest selectivity.
    Returns the index (the cosine kNN batch runs on it)."""
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
    return cindex


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


def oracle_distances(np, pairwise_np, metric, queries, corpus, chunk=8192):
    """float64 distances (Q, N) over corpus chunks (a JSD intermediate of 64
    x 101,414 x 112 float64 is 5.8 GB whole), ``HOST_THREADS`` chunks at a
    time."""
    with ThreadPoolExecutor(HOST_THREADS) as pool:
        return np.concatenate(list(pool.map(
            lambda s: pairwise_np(metric, queries, corpus[s:s + chunk]),
            range(0, len(corpus), chunk))), axis=1)


def oracle_top_k(np, d, k: int):
    """(Q, k) ids by ascending float64 distance, lowest id first on ties:
    ``np.argsort(d, kind="stable")[:, :k]`` without sorting whole rows."""
    kth = np.partition(d, k - 1, axis=1)[:, k - 1]
    out = []
    for row, t in zip(d, kth):
        ids = np.nonzero(row <= t)[0]
        out.append(ids[np.argsort(row[ids], kind="stable")][:k])
    return np.stack(out)


def brute_force_knn(np, pairwise_np, metric, corpus, queries, k):
    """(Q, k) ids of the float64 brute force (``oracle_top_k``)."""
    return oracle_top_k(np, oracle_distances(np, pairwise_np, metric, queries, corpus), k)


def knn_path(torch, np, failures: list, record: dict, index, corpus, queries, metric: str,
             backend: str = "cuda", n_queries: int | None = None,
             plain_batches: int | None = None, oracle_d=None) -> dict:
    """Phase 5 for one metric: kNN (k = 10) over the queries in 512-query
    batches on the cuda backend, on the metric's range-path ``index``, held
    to the torch backend (on its first ``plain_batches`` batches, or all)
    and a float64 brute force (over ``oracle_d``, the range path's float64
    distances of the first ORACLE_QUERIES queries, where given).  Returns
    the metric's launch counts, index and the cuda run's results."""
    from repro_torch.core import flat_index
    from repro_torch.core.backends import EngineOpts
    from repro_torch.core.npdist import pairwise_np
    from repro_torch.core.precision import prob_error_verdict
    from repro_torch.kernels import launch_counts, reset_launch_counts

    queries = queries[:n_queries] if n_queries else queries
    corpus32, queries32 = corpus.astype(np.float32), queries.astype(np.float32)
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
    truth = (oracle_top_k(np, oracle_d, KNN_K) if oracle_d is not None else
             brute_force_knn(np, pairwise_np, space, corpus32, queries32[:ORACLE_QUERIES], KNN_K))
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
            for name in (backend, "torch"):
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
    for metric, plain in plain_of.items():
        entry = PROB.get(metric, "pairwise_l2")

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
        nb_, no_ = tile_bound(metric, q, p, k, y_bytes=2)
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
        mask_np = random_mask(np, rng, (-(-q // bq), -(-n // blk)), live_share[metric])
        log(f"masked {metric} bf16: live tile share {float(mask_np.mean()):.5f} (the bf16 range "
            f"path's {live_share[metric]:.5f}, one of {mask_np.shape[0]} tile rows dead)")
        heavy = metric != "l2"
        numbers, ok = masked_check(torch, metric, x, y16, mask_np, bq, blk,
                                   10 if heavy else 20, 5 if heavy else 20)
        out["masked_" + entry + "_bf16"] = _row(
            failures, "masked_" + entry + "_bf16", entry, True, numbers.pop("max_abs_err"), ok,
            **numbers)
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

    def check(index, label, oracle=None):
        # the float64 oracle in a thread of its own, beside the card's runs
        # (the device mirror is built first, by this thread alone); a
        # generation over the live rows of an earlier one takes its oracle,
        # each query's hits put in this index's storage order
        _ = index.device

        def run_oracle():
            if oracle is None:
                return flat_index.bss_query(index, queries32[:ORACLE_QUERIES], t)[0]
            rank = np.zeros(n, np.int64)
            at = np.nonzero(index.perm >= 0)[0]
            rank[index.perm[at]] = at
            return [sorted(h, key=lambda i: rank[i]) for h in oracle]

        with ThreadPoolExecutor(1) as pool:
            o_run = pool.submit(run_oracle)
            h32, d32, _ = range_hits(index, fp32)
            h16, d16, s16 = range_hits(index, bf16)
            k32 = [flat_index.bss_knn_batched(index, queries32[s:s + BATCH], KNN_K, opts=fp32)
                   for s in (0, BATCH)]
            k16 = [flat_index.bss_knn_batched(index, queries32[s:s + BATCH], KNN_K, opts=bf16)
                   for s in (0, BATCH)]
            o_hits = o_run.result()
        n_or, bad_or = boundary_hit_diffs(np, pairwise_np, metric, corpus32, queries32,
                                          h32[:ORACLE_QUERIES], o_hits, t)
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
        return h32, o_hits

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
    _, o_live = check(idx2, "deleted 1%")
    (idx3, ms), row["compact_seconds"] = timed(lambda: compact(idx2, refresh_pivots=True))
    row["compact"] = dataclasses.asdict(ms)
    # the compacted index holds the deleted generation's live rows: the
    # float64 oracle of the same queries over the same rows is that one's
    h3, _ = check(idx3, "compacted", oracle=o_live)
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
            ts: list, n_requests: int | None = None, mutate: bool = True, built=None) -> dict:
    """Phase 10 for one metric: ``RetrievalServer`` on the card with the
    configuration's settings and its ``async_front`` (default ladder,
    ``max_delay_s=0.002``, ``cache_size=4096``); waves of one request per
    query from SERVE_CLIENTS threads; every result checked against a
    direct ``"cuda"`` call on the generation it names.  ``built``: the
    range path's index over the whole corpus (``mutate=False``), served
    as it is rather than built a second time."""
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
    if built is not None and mutate:
        raise ValueError("a mutating wave builds its server on part of the corpus")
    server = RetrievalServer(corpus32[:n0], metric=metric, n_pivots=cfg.n_pivots,
                             n_pairs=cfg.n_pairs, block=cfg.block, built=built)
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
                                bq=TILE_BQ, backend="cuda")[1][:, :nb].cpu().numpy()
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


class Thresholds:
    """Each metric's range thresholds at the configuration's selectivities.
    ``calibrate_threshold`` draws one 200 x 20,000 float64 distance matrix
    per call, the same for every selectivity; here each metric's matrix is
    drawn once (``calibration_distances``) and every quantile read off it.
    ``start_check`` runs ``calibrate_threshold`` itself for every (metric,
    selectivity) in background threads, during phases that time nothing
    the host paces, and ``verify`` requires the two bit-equal."""

    def __init__(self, np, corpus, selectivities, metrics):
        t0 = time.perf_counter()
        self.corpus, self.selectivities = corpus, tuple(selectivities)
        self.ts = {}
        for m in metrics:
            d = calibration_distances(np, m, corpus)
            self.ts[m] = [float(np.quantile(d, s)) for s in self.selectivities]
        self.pool = self.theirs = None
        log(f"thresholds of {list(metrics)} in {time.perf_counter() - t0:.2f} s")

    def get(self, metric: str) -> list:
        return self.ts[metric]

    def start_check(self) -> None:
        from repro_torch.data.metricsets import calibrate_threshold

        # three at a time: a JSD matrix's float64 intermediates take ~15 GB
        self.pool = ThreadPoolExecutor(max_workers=3)
        self.theirs = {(m, s): self.pool.submit(calibrate_threshold, m, self.corpus, s)
                       for s in self.selectivities for m in self.ts}

    def verify(self, failures: list) -> dict:
        if self.theirs is None:
            self.start_check()
        out = {}
        for m, mine in self.ts.items():
            theirs = [self.theirs[m, s].result() for s in self.selectivities]
            out[m] = dict(thresholds=mine, calibrate_threshold=theirs, equal=mine == theirs)
            if mine != theirs:
                failures.append(f"{m} thresholds {mine} differ from calibrate_threshold's "
                                f"{theirs}")
        self.pool.shutdown()
        return out


def calibration_distances(np, metric: str, corpus, seed: int = 0,
                          n_query_sample: int = 200, n_data_sample: int = 20_000):
    """The distances ``calibrate_threshold`` (``repro_torch.data.metricsets``)
    takes its quantile of, with its defaults: the same draws, the same
    matrix, the same filter.  JSD and Triangular evaluate each (row,
    column) on its own, so their rows are split over ``HOST_THREADS``
    threads; l2 and cosine go through a matmul, whose blocking may follow
    the shape, so they run whole."""
    from repro_torch.core.npdist import pairwise_np

    rng = np.random.default_rng(seed)
    qi = rng.choice(corpus.shape[0], size=min(n_query_sample, corpus.shape[0]), replace=False)
    di = rng.choice(corpus.shape[0], size=min(n_data_sample, corpus.shape[0]), replace=False)
    parts = np.array_split(qi, HOST_THREADS if metric in ("jsd", "triangular") else 1)
    with ThreadPoolExecutor(len(parts)) as pool:
        rows = list(pool.map(lambda q: pairwise_np(metric, corpus[q], corpus[di]), parts))
    d = np.concatenate(rows).ravel()
    return d[d > 1e-12]


# every kernel an engine path launches (PERF.md §6 rows 1, 2, 2b, 3b, 5, 6,
# 6b, 7, 8, 8b): the invariants phase must run each
AUDIT_PATH = ("pairwise_l2", "masked_pairwise_l2", "masked_pairwise_l2_bf16",
              "planar_lower_bound_pairs", "pairwise_jsd", "masked_pairwise_jsd",
              "masked_pairwise_jsd_bf16", "pairwise_tri", "masked_pairwise_tri",
              "masked_pairwise_tri_bf16")


def invariants(torch, np, failures: list, record: dict, queries, paths: dict, cfg) -> dict:
    """Phase 17: the port's audit on the card (``repro_torch.analysis``).
    Returns the launch counts of the phase."""
    from repro_torch.analysis.audit import audit_index, audit_rebuilds, run_audit
    from repro_torch.kernels import launch_counts, reset_launch_counts

    dev = torch.device("cuda")
    problems = []
    reset_launch_counts()
    t0 = time.perf_counter()
    found, cells = run_audit(full=True, device=dev)
    problems += found
    row = dict(cells=len(cells), matrix_problems=len(found),
               matrix_seconds=time.perf_counter() - t0,
               backends=sorted({c["cell"].split("/")[2].split("-")[0] for c in cells}))
    t0 = time.perf_counter()
    found, info = audit_rebuilds(device=dev)
    problems += found
    row.update(rebuild_problems=len(found), rebuilds=info,
               rebuild_seconds=time.perf_counter() - t0)
    t = {m: p["ts"][cfg.selectivities.index(1e-3)] for m, p in paths.items()}
    for metric in ("l2", "jsd", "triangular"):
        t0 = time.perf_counter()
        found, cells = audit_index(paths[metric]["index"], queries[:BATCH], t[metric])
        problems += found
        row[f"index_{metric}"] = dict(t=t[metric], cells=cells, problems=len(found),
                                      seconds=time.perf_counter() - t0)
    counts = launch_counts()
    row.update(problems=[p.format() for p in problems], launches=counts)
    record["invariants"] = row
    log("invariants " + json.dumps(row))
    for p in problems:
        failures.append(f"invariants: {p.format()}")
    for entry in AUDIT_PATH:
        if counts.get(entry, 0) <= 0:
            failures.append(f"invariants: kernel {entry} was not launched by the audit")
    return counts


def quickstart(torch, failures: list, record: dict) -> None:
    """Phase 18: ``examples/torch_quickstart.py`` on the card at its own size,
    in a subprocess that must exit 0 (its trace lands in build/quickstart)."""
    import os

    torch.cuda.empty_cache()  # the subprocess allocates on the same card
    out_dir = ROOT / "build" / "quickstart"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py"), "--device", "cuda"],
        env=dict(os.environ, PYTHONPATH=str(SRC)), cwd=out_dir, capture_output=True,
        text=True, timeout=900,
    )
    row = dict(rc=proc.returncode, seconds=time.perf_counter() - t0)
    record["quickstart"] = row
    for line in proc.stdout.splitlines():
        if not line.startswith(("  ", "==")):  # the dashboard of step 12 is long
            log(f"quickstart: {line}")
    log("quickstart " + json.dumps(row))
    if proc.returncode != 0:
        failures.append(f"quickstart exited {proc.returncode}:\n{proc.stderr[-4000:]}")


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


# The two-tower path at the full TWO_TOWER config (PERF.md §4): 10^6 items
# (the retrieval_cand cell), embedded in serve_bulk chunks, and 512 users
# (serve_p99); the float64 oracles on 64 users; the pruned forward on 8
# single-user calls (its gather is (Q, budget, 128, 256) float32).
TT_SIZES = dict(items=1_000_000, users=512, chunk=262_144, oracle=64, sample=4096,
                tower_rows=256, pruned_users=8, budget=3136, ctr_rows=512, quantile=1e-5)
# every kernel the two-tower path launches (PERF.md §6 rows 1, 2, 2b, 3b)
TWO_TOWER_PATH = ("pairwise_l2", "masked_pairwise_l2", "masked_pairwise_l2_bf16",
                  "planar_lower_bound_pairs")
TOWER_MIN_COS = 0.999  # a bf16 tower row against the float32 CPU row
# The untrained full-config rows lie in a narrow cone: two different items
# are ~0.007 apart (median pairwise distance), so the cosine alone cannot
# tell a wrong row.  A bf16 row must also lie nearest its own of the CPU
# rows, and within this share of their median pairwise distance of it: its
# rounding alone (2**-9 of each output element) may move it ~0.002, up to
# ~0.6 of that distance, while a wrong row lies at a pairwise distance, over
# the median for half the rows.  The card's float32 copy of the towers must
# lie within ATOL of the CPU and nearest its own CPU row.
TOWER_BF16_SHARE = 1.0
# The two-tower training phase: the reference example's optimizer (AdamW,
# lr 3e-3), 20 steps of ClickStream batches, one checkpoint at the end.  The
# train_batch cell's 65,536 rows would hold four (B, B) float32 matrices of
# the in-batch softmax at 17.2 GB each beside the state: over one 80 GB
# card, so the batch is cut to 32,768 (PERF.md §4).
TT_TRAIN = dict(batch=32_768, steps=20, lr=3e-3, seed=0)
# the untrained full-config corpus (PERF.md §6), printed beside the
# trained one's
TT_UNTRAINED = dict(knn_dists_per_query=1_000_144, knn_saving=-0.000144,
                    mean_row_norm=0.999987, median_pairwise=0.00710,
                    median_nearest_neighbour=0.00470)
# a bf16 CTR forward against the float32 one over the same weights: each
# layer's output rounds to bf16 (relative 2**-9), through up to five layers
# and a final sum that may cancel; held relative to the largest |logit|
CTR_REL = 5e-2


def event_ms(torch, fn):
    """(fn(), its ms between CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


LAUNCH_CKPT = ROOT / "build" / "launch_train_ckpt"  # the training launcher's checkpoints


def launcher_commands(ckpt: Path) -> list:
    """(name, argv) of the launchers run beside the quickstart: the serving
    launcher at its defaults and with ``--min-score 0.5``, the training
    launcher on the reduced two-tower, Llama-3.2-1B and PNA (checkpoints
    under ``ckpt``), and the training-and-serving example."""
    return [
        ("serve", ["-m", "repro_torch.launch.serve"]),
        ("serve --min-score 0.5", ["-m", "repro_torch.launch.serve", "--min-score", "0.5"]),
        ("train", ["-m", "repro_torch.launch.train", "--arch", "two-tower-retrieval",
                   "--reduced", "--steps", "20", "--checkpoint-dir", str(ckpt)]),
        *((f"train {arch}", ["-m", "repro_torch.launch.train", "--arch", arch, "--reduced",
                             "--steps", "20", "--checkpoint-dir", str(ckpt / arch)])
          for arch in ("llama3.2-1b", "pna")),
        ("retrieval serving example", [str(ROOT / "examples" / "torch_retrieval_serving.py"),
                                       "--steps", "20", "--corpus", "5000",
                                       "--queries", "32"]),
    ]


# the LM-embedding example at its defaults (reduced Llama, 4,096 windows),
# beside the quickstart
LM_EXAMPLE_COMMANDS = [("lm embedding retrieval example",
                        [str(ROOT / "examples" / "torch_lm_embedding_retrieval.py")])]


def start_launchers(commands: list, device_args: tuple = ()) -> list:
    """Each command in a subprocess, all started together."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    return [(name, subprocess.Popen(
        [sys.executable, *argv, *device_args], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name, argv in commands]


def printed_losses(lines: list) -> list:
    """Every loss a launcher printed (``loss=2.77``, ``final loss 2.77``,
    ``loss 2.77 -> 2.76``), as floats (``nan`` stays nan)."""
    return [float(v) for line in lines if "loss" in line
            for v in re.findall(r"(?:loss[= ]|-> )\s*([^\s,()]+)", line)]


def finish_launchers(failures: list, procs: list) -> list:
    """Each must exit 0; a training one must also print finite losses."""
    import math

    rows = []
    for name, proc in procs:
        out, err = proc.communicate(timeout=600)
        lines = out.strip().splitlines()
        losses = printed_losses(lines)
        row = dict(name=name, rc=proc.returncode, stdout=lines, losses=losses)
        rows.append(row)
        if proc.returncode != 0:
            failures.append(f"launcher {name} exited {proc.returncode}:\n"
                            f"{err[-4000:]}")
        elif name.startswith(("train", "retrieval")) and not (
                losses and all(math.isfinite(v) for v in losses)):
            failures.append(f"launcher {name} printed no finite losses: {lines}")
        elif name.startswith("lm") and not any("exact=True" in line for line in lines):
            failures.append(f"launcher {name} printed no exact search: {lines}")
    return rows


def launchers(failures: list, record: dict, procs: list) -> None:
    """Join the launchers (``launcher_commands``) and print their output."""
    import shutil

    record["launchers"] = finish_launchers(failures, procs)
    shutil.rmtree(LAUNCH_CKPT, ignore_errors=True)
    for r in record["launchers"]:
        log(f"launcher {r['name']} rc {r['rc']}: " + " | ".join(r["stdout"]))


def int_bits(torch, t):
    """``t`` as the same-width integers (bit-for-bit comparison)."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.itemsize])


def differing_leaves(torch, a, b) -> list:
    """Keys of the leaves of two trees that differ in any bit (or in
    structure, dtype or shape)."""
    from repro_torch.pytree import leaves_with_paths, path_key

    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        return ["<structure>"]
    return [path_key(p) for (p, x), (_, y) in zip(la, lb)
            if x.dtype != y.dtype or x.shape != y.shape
            or not torch.equal(int_bits(torch, x), int_bits(torch, y.to(x.device)))]


class Stamps:
    """Time marks: CUDA events on a card (device time), the host clock on
    the CPU (the smoke's CPU tests)."""

    def __init__(self, torch, dev):
        self.torch, self.cuda = torch, dev.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> list:
        """ms between consecutive marks."""
        if self.cuda:
            self.torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def two_tower_train(torch, np, failures: list, record: dict, dev, cfg=None,
                    batch: int = TT_TRAIN["batch"], steps: int = TT_TRAIN["steps"],
                    ckpt_dir: Path = ROOT / "build" / "two_tower_ckpt"):
    """Phase 20: the full TWO_TOWER config trained on the card
    (``TrainLoop``, AdamW at lr 3e-3, ``ClickStream`` batches of ``batch``
    rows, a checkpoint at the last step), the checkpoint restored onto the
    card bit for bit with the stream's state, and one further step from the
    live and from the restored state, bit-equal.  Returns the model holding
    the restored (trained) parameters, which phase 21 embeds and serves.
    ``cfg`` / ``batch`` / ``steps`` / ``dev`` shrink it for the CPU tests."""
    import math
    import shutil

    from repro_torch.configs.recsys_archs import TWO_TOWER
    from repro_torch.data.pipeline import ClickStream
    from repro_torch.models.recsys import TwoTowerModel
    from repro_torch.optim import adamw
    from repro_torch.pytree import leaves
    from repro_torch.train.loop import TrainLoop, TrainLoopConfig
    from repro_torch.train.step import functional_loss, to_device

    cfg = cfg or TWO_TOWER
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak() -> int | None:
        return torch.cuda.max_memory_allocated() if cuda else None

    def reset_peak():
        if cuda:
            torch.cuda.reset_peak_memory_stats()

    row: dict = {}
    record["two tower train"] = row
    if cuda:
        row["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        log(f"two tower train card: {row['card']}")
    model = TwoTowerModel(cfg)
    reset_peak()
    t0 = time.perf_counter()
    model.init_params(torch.Generator(dev).manual_seed(TT_TRAIN["seed"]), device=dev)
    sync()
    n_params = sum(math.prod(p.shape) for p in leaves(model.param_tree()))
    row["init"] = dict(config=cfg.name, vocab=cfg.vocab, dtype=str(cfg.dtype),
                       embed_dim=cfg.embed_dim, tower_mlp=list(cfg.tower_mlp),
                       params=n_params, param_bytes=model.param_bytes(),
                       seconds=time.perf_counter() - t0, max_memory_allocated=peak())
    log("two tower train init " + json.dumps(row["init"]))
    # the towers at the initial weights, every check held (the weights and
    # rows the two-tower phase held before it served a trained model)
    _, item_ids, user_ids = two_tower_ids(np, cfg)
    row["init_towers"] = towers(torch, np, failures, model, dev, item_ids, user_ids,
                                TT_SIZES["tower_rows"])
    log("two tower train init towers " + json.dumps(row["init_towers"]))

    # the checkpoint: parameters, AdamW's float32 m and v, two step counts
    state_bytes = model.param_bytes() + 8 * n_params + 8
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    free = shutil.disk_usage(ckpt_dir).free
    row["disk"] = dict(path=str(ckpt_dir), free_bytes=free, state_bytes=state_bytes)
    log("two tower train disk " + json.dumps(row["disk"]))
    if free < 2 * state_bytes:
        failures.append(f"two tower train: {free} bytes free for a {state_bytes}-byte state")
        return model

    loop = TrainLoop(functional_loss(model, model.loss_fn), adamw(lr=TT_TRAIN["lr"]),
                     ClickStream(cfg, batch=batch, seed=TT_TRAIN["seed"]),
                     TrainLoopConfig(total_steps=steps, checkpoint_every=steps,
                                     checkpoint_dir=str(ckpt_dir), keep_last=1,
                                     log_every=steps), device=dev)
    state = loop.init_or_restore(model.param_tree)
    model.to_empty(device="meta")  # the state holds the parameters now
    sync()
    base = torch.cuda.memory_allocated() if cuda else None
    reset_peak()
    t0 = time.perf_counter()
    state = loop.run(state)
    run_s = time.perf_counter() - t0
    losses = loop.losses
    train = dict(batch=batch, steps=steps, lr=TT_TRAIN["lr"], run_seconds=run_s,
                 host_ms_per_step=[1e3 * v for v in loop.step_seconds],
                 host_ms_per_step_median_after_first=float(
                     np.median(loop.step_seconds[1:] or loop.step_seconds)) * 1e3,
                 first_losses=losses[:5], last_losses=losses[-5:],
                 finite=all(math.isfinite(v) for v in losses),
                 state_bytes_on_device=base, max_memory_allocated=peak(),
                 stragglers=loop.stragglers)
    if not train["finite"] or len(losses) != steps:
        failures.append(f"two tower train: losses {losses}")
    ckpt = dict(loop.ckpt.last_save)
    ckpt["save_seconds"] = ckpt.get("host_copy_s", 0.0) + ckpt.get("write_s", 0.0)

    # restore onto the card: every leaf bit for bit, and the stream's state
    t0 = time.perf_counter()
    restored, extra = loop.ckpt.restore(state, device=dev)
    sync()
    ckpt["restore_seconds"] = time.perf_counter() - t0
    ckpt["differing_leaves"] = differing_leaves(torch, state, restored)
    ckpt["stream_restored"] = extra.get("stream") == loop.stream.state()
    ckpt["leaves"] = len(leaves(state))
    row["checkpoint"] = ckpt
    log("two tower train checkpoint " + json.dumps(ckpt))
    if ckpt["differing_leaves"] or not ckpt["stream_restored"]:
        failures.append(f"two tower train: restored state differs: {ckpt}")

    # one further step from each on the same batch: forward + backward and
    # the optimizer timed apart on the live state, the whole step on the
    # restored one; parameters, optimizer state and loss bit for bit
    b = to_device(loop.stream.next(), dev)
    step = loop.step_fn
    stamps = Stamps(torch, dev)
    sync()
    before = torch.cuda.memory_allocated() if cuda else None
    reset_peak()
    stamps.mark()
    loss, grads = step.grads(state["params"], b)
    stamps.mark()
    grads_peak = peak()
    reset_peak()
    stamps.mark()
    live = step.apply(state, grads)
    stamps.mark()
    apply_peak = peak()
    del grads, state
    stamps.mark()
    again, metrics = step(restored, b)
    stamps.mark()
    fwd_bwd_ms, _, apply_ms, _, step_ms = stamps.ms()
    differ = differing_leaves(torch, live, again)
    same_loss = bool(torch.equal(int_bits(torch, loss), int_bits(torch, metrics["loss"])))
    train.update(event_ms_forward_backward=fwd_bwd_ms, event_ms_optimizer=apply_ms,
                 event_ms_step=step_ms, further_step_loss=float(loss),
                 further_step_differing_leaves=differ, further_step_same_loss=same_loss,
                 max_memory_forward_backward=grads_peak, max_memory_optimizer=apply_peak)
    if cuda:
        # the (B, B) part of forward + backward, and 65,536 rows reckoned
        # from it: that part x 4, beside the state and the gradients
        bb = grads_peak - before - model.param_bytes()
        train["bb_part_bytes"] = bb
        train["reckoned_peak_at_65536"] = max(base + model.param_bytes() + 4 * bb, apply_peak)
    row["train"] = train
    log("two tower train " + json.dumps(train))
    if differ or not same_loss:
        failures.append(f"two tower train: a step from the restored state differs from one "
                        f"from the live state: leaves {differ}, same loss {same_loss}")
    params = restored["params"]
    del live, again, restored
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    model.load_param_tree(params)
    if cuda:
        torch.cuda.empty_cache()
    return model


def tower_check(torch, np, failures, model, card32, cpu, ids, ids_dev, tower: str,
                bf16_rows: bool = True) -> dict:
    """One tower's rows on the card, bf16 (``model``) and float32
    (``card32``), against the float32 CPU copy over the same weights, held
    to the scale of the cone (``TOWER_BF16_SHARE``).  ``bf16_rows=False``
    (trained towers, whose rows lie closer together than a bf16 row's
    rounding: PERF.md §6) prints the bf16 rows' distance share and
    nearest-row share without holding them; every other check holds."""
    with torch.inference_mode():
        got = getattr(model, tower)(ids_dev).float().cpu().numpy()
        got32 = getattr(card32, tower)(ids_dev).cpu().numpy()
        want = getattr(cpu, tower)(torch.as_tensor(ids)).numpy()
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    apart = pairwise_dist_np(np, want, want)
    median_pairwise = float(np.median(apart[np.triu_indices(len(want), 1)]))
    d16, d32 = pairwise_dist_np(np, got, want), pairwise_dist_np(np, got32, want)
    own = np.arange(len(want))
    row = dict(rows=len(ids), max_abs_err=float(np.abs(got - want).max()),
               min_cosine=float(cos.min()), median_pairwise=median_pairwise,
               bf16_max_row_dist=float(d16[own, own].max()),
               bf16_max_row_share=float(d16[own, own].max()) / median_pairwise,
               bf16_nearest_own_share=float((d16.argmin(1) == own).mean()),
               bf16_rows_held=bf16_rows,
               fp32_max_abs_err=float(np.abs(got32 - want).max()),
               fp32_nearest_own=bool((d32.argmin(1) == own).all()),
               finite=bool(np.isfinite(got).all() and np.isfinite(got32).all()))
    bf16_ok = (row["bf16_max_row_share"] <= TOWER_BF16_SHARE
               and row["bf16_nearest_own_share"] == 1.0) or not bf16_rows
    if not (row["finite"] and row["min_cosine"] >= TOWER_MIN_COS and bf16_ok
            and row["fp32_max_abs_err"] <= ATOL and row["fp32_nearest_own"]):
        failures.append(f"two tower: {tower} on the card against the CPU: {row}")
    return row


def two_tower_ids(np, cfg, sizes=TT_SIZES):
    """(rng, item ids, user ids) of the two-tower phases: the corpus's and
    the users' ids, drawn first from ``default_rng(0)``."""
    from repro_torch.models.recsys import check_ids

    rng = np.random.default_rng(0)
    item_ids = rng.integers(0, cfg.vocab, size=(sizes["items"], cfg.n_item_fields))
    user_ids = rng.integers(0, cfg.vocab, size=(sizes["users"], cfg.n_user_fields))
    check_ids(item_ids, cfg.vocab, "item ids")
    check_ids(user_ids, cfg.vocab, "user ids")
    return rng, item_ids, user_ids


def towers(torch, np, failures, model, dev, item_ids, user_ids, n: int,
           bf16_rows: bool = True) -> dict:
    """``tower_check`` of both towers on the first ``n`` user and item rows,
    against float32 copies of ``model`` on the CPU and on ``dev``."""
    from repro_torch.models.recsys import cast_model

    t0 = time.perf_counter()
    cpu = cast_model(model, torch.float32, "cpu")
    card32 = cast_model(model, torch.float32, dev)
    out = {tower: tower_check(torch, np, failures, model, card32, cpu, ids[:n],
                              torch.as_tensor(ids[:n], device=dev), tower, bf16_rows)
           for tower, ids in (("user_embed", user_ids), ("item_embed", item_ids))}
    del cpu, card32
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def pairwise_dist_np(np, a, b):
    """(len(a), len(b)) l2 distances of float32 rows, by their differences."""
    return np.linalg.norm(a[:, None, :] - b[None, :, :], axis=2)


def corpus_geometry(torch, np, corpus16, rng, sample: int) -> dict:
    """How collapsed the embedded corpus is: the norm of its mean row, the
    median pairwise and nearest-neighbour distance (to the whole corpus) of
    a sample, and the rows equal to another row in bf16."""
    cf = corpus16.float()
    idx = torch.as_tensor(np.sort(rng.choice(len(cf), sample, replace=False)),
                          device=cf.device)
    xs = cf[idx]
    nn_d = []
    for s in range(0, sample, 512):
        d = torch.cdist(xs[s:s + 512], cf)
        d[torch.arange(d.shape[0], device=d.device), idx[s:s + 512]] = torch.inf
        nn_d.append(d.min(dim=1).values)
    pair = torch.cdist(xs, xs)
    iu = torch.triu_indices(sample, sample, 1, device=cf.device)
    _, counts = torch.unique(corpus16.view(torch.int16), dim=0, return_counts=True)
    cn = cf / torch.linalg.norm(cf, dim=1, keepdim=True)
    return dict(sample=sample, mean_row_norm=float(torch.linalg.norm(cn.mean(0))),
                median_pairwise=float(pair[iu[0], iu[1]].median()),
                median_nearest_neighbour=float(torch.cat(nn_d).median()),
                rows_equal_to_another_in_bf16=int(counts[counts > 1].sum()),
                distinct_bf16_rows=int(counts.numel()))


def kth_ties(np, d, k: int) -> int:
    """Items beyond the kth of each row whose float64 distance lies within
    BAND of the kth: ids any exact engine may return in its place."""
    kth = np.partition(d, k - 1, axis=1)[:, k - 1:k]
    return int(((np.abs(d - kth) <= BAND).sum(axis=1) - 1).sum())


def path_kernels(torch, np, failures: list, index, q_eng, live: dict, tag: str,
                 identity: bool = False) -> dict:
    """Rows 1, 3b, 2 and 2b of PERF.md §6 at a path's shapes (the two-tower
    path: 512 queries, 16 pivots, K = 256, 7,813 blocks, 24 planes; the LM
    search: 512 queries, 12 pivots, K = 2,048, 256 blocks, 16 planes) on
    the path's own index and queries, against their plain versions: row 2
    at the path's live-tile share (a random mask at that share) and at a
    30% random mask with one dead tile row, row 2b at the bf16 path's
    share.  ``identity``: the l2 rows are held by ``identity_compare``."""
    from repro_torch.kernels import pairwise_dist as pdist
    from repro_torch.kernels import planar_exclusion as planar
    from repro_torch.kernels import ref

    dev = index.device
    x = torch.as_tensor(q_eng, device=index.torch_device)
    q, k = x.shape
    p, m, b = dev.pivots.shape[0], dev.pairs.shape[0], index.n_blocks
    n, blk, bq = dev.data.shape[0], index.block, 128
    numbers, ok = l2_pivot_check(torch, x, dev.pivots, 50, identity)
    out = {"pairwise_l2": dict(shape=[q, p, k], ok=ok, **numbers)}
    dqp = pdist.pairwise_l2_kernel_call(x, dev.pivots)

    def bound():
        return planar.planar_lower_bound_pairs_kernel_call(dqp, dev.pairs, dev.deltas, dev.boxes)

    def plain_bound():
        return ref.planar_lower_bound_pairs_ref(dqp, dev.pairs, dev.deltas, dev.boxes)

    got, want = bound(), plain_bound()
    err, same_inf, _ = compare(torch, got, want)
    nb, by = planar_pairs_bound(q, p, m, b)
    out["planar_lower_bound_pairs"] = dict(
        shape=[q, b, m], max_abs_err=err, ok=same_inf and bool(torch.equal(got, want)),
        ms=device_ms(torch, bound), plain_ms=time_ms(torch, plain_bound, 20),
        bound_ms=nb, bound_by=by, library_ms=None)
    rng = np.random.default_rng(5)
    shape = (-(-q // bq), -(-n // blk))
    for key, y, share in (("masked_pairwise_l2", dev.data, live["fp32"]),
                          ("masked_pairwise_l2@0.3", dev.data, 0.3),
                          ("masked_pairwise_l2_bf16", index.device_bf16, live["bf16"])):
        # the dead-tile path under the 30% mask
        mask_np = random_mask(np, rng, shape, share, dead_row=share == 0.3)
        numbers, ok = masked_check(torch, "l2", x, y, mask_np, bq, blk, 10, 2, identity)
        out[key] = dict(shape=[q, n, k], live_share=float(mask_np.mean()), ok=ok, **numbers)
    for key, rec in out.items():
        log(f"{tag} kernel {key}: " + json.dumps(rec))
        if not rec["ok"]:
            failures.append(f"{tag}: kernel {key} disagrees with its plain version: {rec}")
    return out


def ctr_forwards(torch, np, failures: list, dev, rows: int) -> dict:
    """The three CTR models at their full configs: one serve_p99 forward on
    the card (bf16) against the float32 CPU forward over the same weights,
    and ``bce_loss``; each model's parameters are dropped after."""
    from repro_torch.configs.common import recsys_batch_spec
    from repro_torch.configs.registry import registry
    from repro_torch.models.recsys import bce_loss, cast_model, check_ids

    out = {}
    for name in ("wide-deep", "din", "dlrm-rm2"):
        bundle = registry()[name]
        model, cfg = bundle.model, bundle.cfg
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model.init_params(torch.Generator(dev).manual_seed(0), device=dev)
        rng = np.random.default_rng(1)
        batch = {}
        for key, spec in recsys_batch_spec(cfg, rows, train=True).items():
            if spec.dtype == torch.int32:
                batch[key] = rng.integers(0, cfg.vocab, size=spec.shape).astype(np.int32)
                check_ids(batch[key], cfg.vocab, key)
            elif spec.dtype == torch.bool:
                batch[key] = rng.random(spec.shape) < 0.8
            elif key == "label":
                batch[key] = (rng.random(spec.shape) < 0.5).astype(np.float32)
            else:
                batch[key] = rng.normal(size=spec.shape).astype(np.float32)
        on_card = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with torch.inference_mode():
            got, ms = event_ms(torch, lambda: model.forward(on_card))
            loss = float(bce_loss(model, on_card))
            cpu = cast_model(model, torch.float32, "cpu")
            on_cpu = {k: torch.as_tensor(v) for k, v in batch.items()}
            want = cpu.forward(on_cpu).numpy()
            cpu_loss = float(bce_loss(cpu, on_cpu))
        got = got.cpu().numpy()
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        row = dict(param_bytes=model.param_bytes(),
                   max_memory_allocated=torch.cuda.max_memory_allocated(), rows=rows,
                   forward_ms=ms, rel_err=rel, bound=CTR_REL, finite=bool(np.isfinite(got).all()),
                   bce_loss=loss, cpu_bce_loss=cpu_loss, seconds=time.perf_counter() - t0)
        out[name] = row
        log(f"two tower ctr {name} " + json.dumps(row))
        if not (row["finite"] and rel <= CTR_REL and np.isfinite(loss)):
            failures.append(f"two tower: {name} forward on the card against the CPU: {row}")
        del cpu, got, on_card
        model.to_empty(device="meta")
        torch.cuda.empty_cache()
    return out


def two_tower(torch, np, failures: list, record: dict, dev, model, sizes=TT_SIZES) -> dict:
    """Phase 21: the recsys family's serving path at the full TWO_TOWER
    config, over ``model``: the model phase 20 trained, checkpointed and
    restored.  Returns the launch counts of its serving calls and the
    kernel records at its shapes."""
    from repro_torch.core.backends import EngineOpts
    from repro_torch.core.npdist import pairwise_np
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.tiles import TILE_BQ
    from repro_torch.serve.retrieval import (RetrievalServer, distance_to_score,
                                             score_to_distance)

    row: dict = {}
    record["two tower"] = row
    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats()

    rng, item_ids, user_ids = two_tower_ids(np, cfg, sizes)
    n_items, n_users = sizes["items"], sizes["users"]
    items_dev = torch.as_tensor(item_ids, device=dev)
    users_dev = torch.as_tensor(user_ids, device=dev)

    # 1. the trained towers against the float32 CPU forward over the same
    # weights; their rows lie closer together than a bf16 row's rounding, so
    # the bf16 rows' nearest-row checks held phase 20 on the initial weights
    row["towers"] = towers(torch, np, failures, model, dev, item_ids, user_ids,
                           sizes["tower_rows"], bf16_rows=False)
    log("two tower towers " + json.dumps(row["towers"]))

    # 2. embed the corpus in serve_bulk chunks and the users in one batch
    chunk_ms, parts = [], []
    with torch.inference_mode():
        for s in range(0, n_items, sizes["chunk"]):
            e, ms = event_ms(torch, lambda s=s: model.item_embed(items_dev[s:s + sizes["chunk"]]))
            parts.append(e)
            chunk_ms.append(ms)
        corpus16 = torch.cat(parts)
        del parts
        users16, users_ms = event_ms(torch, lambda: model.user_embed(users_dev))
    corpus = corpus16.float().cpu().numpy()
    users = users16.float().cpu().numpy()
    t0 = time.perf_counter()
    geometry = corpus_geometry(torch, np, corpus16, rng, sizes["sample"])
    geometry["seconds"] = time.perf_counter() - t0
    row["embed"] = dict(items=n_items, chunk=sizes["chunk"], ms_per_chunk=chunk_ms,
                        users=n_users, users_ms=users_ms, geometry=geometry,
                        max_memory_allocated=torch.cuda.max_memory_allocated())
    log("two tower embed " + json.dumps(row["embed"]))
    log("two tower embed untrained (PERF.md §6) " + json.dumps(
        {k: TT_UNTRAINED[k] for k in ("mean_row_norm", "median_pairwise",
                                      "median_nearest_neighbour")}))
    del corpus16

    # 3. the index and the server (cosine; 16 pivots, 24 planes, 128-row blocks)
    t0 = time.perf_counter()
    server = RetrievalServer(corpus, device=dev)
    _ = server.index.device
    torch.cuda.synchronize()
    index = server.index
    row["build"] = dict(seconds=time.perf_counter() - t0, n_pad=int(index.data.shape[0]),
                        blocks=int(index.n_blocks), planes=int(index.pairs.shape[0]),
                        pivots=int(index.pivots.shape[0]), dim=int(index.data.shape[1]))
    del corpus
    q_eng = server._prep(users)
    n_or = sizes["oracle"]
    pool = ThreadPoolExecutor(1)
    oracle = pool.submit(lambda: oracle_distances(np, pairwise_np, "l2", q_eng[:n_or],
                                                  server.corpus, chunk=65_536))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # the bf16 mirror and its margin are made on first use (host numpy):
    # made here, outside the timed calls
    t0 = time.perf_counter()
    _ = index.device_bf16
    row["build"]["bf16_margin"] = index.bf16_margin()
    torch.cuda.synchronize()
    row["build"]["bf16_mirror_seconds"] = time.perf_counter() - t0
    log("two tower build " + json.dumps(row["build"]))
    # warm-up (the first launches at K = 256), not counted
    server.search(users[:8], "knn", k=KNN_K)
    # the oracle ran beside the mirror and the warm-up; nothing runs
    # beside the timed calls
    t0 = time.perf_counter()
    d64 = oracle.result()
    pool.shutdown()
    oracle_wait = time.perf_counter() - t0
    reset_launch_counts()
    top, knn32_s = timed(lambda: server.top_k(users, KNN_K))
    knn32 = server.search(users, "knn", k=KNN_K)  # the same call with its stats
    knn16, knn16_s = timed(lambda: server.search(
        users, "knn", k=KNN_K, opts=EngineOpts(precision="bf16")))
    min_score = float(distance_to_score(np.quantile(d64, sizes["quantile"])))
    t = float(score_to_distance(np.asarray(min_score)))
    hits, range_s = timed(lambda: server.range_query(users, min_score))
    rng32 = server.search(users, "range", t=t)
    rng16 = server.search(users, "range", t=t, opts=EngineOpts(precision="bf16"))
    counts = launch_counts()
    log(f"two tower launch counts: {counts}")

    # the plain backend on the same card, the float64 oracle, bf16 == fp32
    plain_knn, plain_knn_s = timed(lambda: server.search(
        users, "knn", k=KNN_K, opts=EngineOpts(backend="torch")))
    plain_rng, plain_rng_s = timed(lambda: server.search(
        users, "range", t=t, opts=EngineOpts(backend="torch")))
    n_diff, bad = knn_id_diffs(np, pairwise_np, "l2", server.corpus, q_eng, knn32.indices,
                               plain_knn.indices)
    count_diff = np.nonzero(knn32.stats["per_query_dists"]
                            != plain_knn.stats["per_query_dists"])[0]
    kth, p_kth = knn32.distances[:, -1], plain_knn.distances[:, -1]
    bad_counts = [int(i) for i in count_diff
                  if abs(kth[i] - p_kth[i]) > BAND * max(1.0, float(p_kth[i]))]
    truth = oracle_top_k(np, d64, KNN_K)
    n_or_diff, bad_or = knn_id_diffs(np, pairwise_np, "l2", server.corpus, q_eng,
                                     knn32.indices[:n_or], truth)
    n_hit_diff, bad_hits = boundary_hit_diffs(np, pairwise_np, "l2", server.corpus, q_eng,
                                              hits, plain_rng.hits, t)
    or_hits = [np.nonzero(d64[i] <= t)[0].tolist() for i in range(n_or)]
    n_hor_diff, bad_hor = boundary_hit_diffs(np, pairwise_np, "l2", server.corpus, q_eng,
                                             [sorted(h) for h in hits[:n_or]], or_hits, t)
    equal = dict(
        top_k_is_search=bool(np.array_equal(np.stack(top), knn32.indices)),
        knn_indices=bool(np.array_equal(knn16.indices, knn32.indices)),
        knn_distances=same_bits(np, knn16.distances, knn32.distances),
        knn_rounds=knn16.stats["rounds"] == knn32.stats["rounds"],
        knn_per_query_dists=bool(np.array_equal(knn16.stats["per_query_dists"],
                                                knn32.stats["per_query_dists"])),
        range_hits=rng16.hits == rng32.hits == hits,
        **{f"range_{k}": v for k, v in equal_fields(
            np, range_fields(np, [rng16.stats]), range_fields(np, [rng32.stats])).items()})
    n_blocks, n_valid = index.n_blocks, index.n_valid
    qtiles = -(-n_users // TILE_BQ)
    live = {"fp32": rng32.stats["tiles_computed"] / (qtiles * n_blocks),
            "bf16": rng16.stats["tiles_computed"] / (qtiles * n_blocks)}
    serve = dict(
        users=n_users, k=KNN_K, min_score=min_score, t=t, quantile=sizes["quantile"],
        knn_queries_per_s=n_users / knn32_s, knn_bf16_queries_per_s=n_users / knn16_s,
        range_queries_per_s=n_users / range_s,
        plain_knn_queries_per_s=n_users / plain_knn_s,
        plain_range_queries_per_s=n_users / plain_rng_s,
        knn_rounds=knn32.stats["rounds"],
        knn_dists_per_query=float(knn32.stats["dists_per_query"]),
        knn_saving=1.0 - float(knn32.stats["dists_per_query"]) / n_valid,
        range_dists_per_query=float(rng32.stats["dists_per_query"]),
        range_saving=1.0 - float(rng32.stats["dists_per_query"]) / n_valid,
        range_block_exclusion_rate=float(rng32.stats["block_exclusion_rate"]),
        live_tile_share=live, hits=sum(map(len, hits)),
        server_saving=server.stats.saving,
        bf16_recheck_points_per_query=float(rng16.stats["recheck_points_per_query"]),
        id_diff_queries_vs_torch=n_diff, id_diff_queries_vs_oracle=n_or_diff,
        count_diff_queries=len(count_diff), kth_ties_within_band=kth_ties(np, d64, KNN_K),
        oracle_users=n_or, oracle_wait_s=oracle_wait,
        hit_boundary_diffs_vs_torch=n_hit_diff, hit_boundary_diffs_vs_oracle=n_hor_diff,
        equal_to_fp32=equal, finite=bool(np.isfinite(knn32.distances).all()))
    row["serve"] = serve
    log("two tower serve " + json.dumps(serve))
    log("two tower serve untrained (PERF.md §6) " + json.dumps(
        {k: TT_UNTRAINED[k] for k in ("knn_dists_per_query", "knn_saving")}))
    if bad or bad_or or bad_counts or bad_hits or bad_hor or not serve["finite"]:
        failures.append(f"two tower: ids differ away from ties {(bad + bad_or)[:10]}, counts "
                        f"differ with kth apart {bad_counts[:10]}, hits differ away from t "
                        f"{(bad_hits + bad_hor)[:10]}, finite {serve['finite']}")
    if not all(equal.values()):
        failures.append(f"two tower: bf16 differs from fp32: {equal}")
    if serve["hits"] == 0:
        failures.append("two tower: the range query found no hits")
    del d64

    # 4. forward with candidates (1 user x the corpus) and the pruned forward
    mirror = index.device
    pruned = dict(calls=sizes["pruned_users"], budget_blocks=sizes["budget"], blocks=n_blocks,
                  gather_bytes_per_user=sizes["budget"] * index.block * index.data.shape[1] * 4,
                  dense_ms=[], pruned_ms=[], recall_at_10=[])
    with torch.inference_mode():
        for i in range(sizes["pruned_users"]):
            batch = dict(user_ids=users_dev[i:i + 1], candidates=mirror.data,
                         pivots=mirror.pivots, pair_idx=mirror.pairs, deltas=mirror.deltas,
                         boxes=mirror.boxes)
            dense, ms = event_ms(torch, lambda: model.forward(
                dict(user_ids=batch["user_ids"], candidates=batch["candidates"])))
            pruned["dense_ms"].append(ms)
            (scores, rows_), ms = event_ms(torch, lambda: model.forward_retrieval_pruned(
                batch, block=index.block, budget_blocks=sizes["budget"]))
            pruned["pruned_ms"].append(ms)
            want = set(torch.topk(dense[0], 10).indices.tolist())
            got = set(rows_[0][torch.topk(scores[0], 10).indices].tolist())
            pruned["recall_at_10"].append(len(want & got) / 10)
            if not (torch.isfinite(dense).all() and torch.isfinite(scores).all()):
                failures.append("two tower: non-finite retrieval scores")
    row["pruned"] = pruned
    log("two tower pruned " + json.dumps(pruned))

    # 5. the kernels at these shapes; 6. the CTR models
    kernels = path_kernels(torch, np, failures, index, q_eng, live, "two tower")
    model.to_empty(device="meta")
    del server, index, mirror, items_dev
    torch.cuda.empty_cache()
    row["ctr"] = ctr_forwards(torch, np, failures, dev, sizes["ctr_rows"])
    return dict(counts=counts, kernels=kernels)


# The LM family's serving path (PERF.md §4): the full Llama-3.2-1B config
# prefilling 4 x 2,048 tokens and decoding 32 greedy steps into a 2,080-slot
# bf16 cache; the full Gemma 2 9B config over 1 x 8,192 tokens (past its
# 4,096-token window) decoding 16 steps with its int8 cache and a bf16 one;
# Phi-3.5-MoE at full width cut to 2 layers; 32,768 + 512 token windows of
# 32 tokens embedded by the Llama and searched at K = 2,048.
LM_SIZES = dict(batch=4, prompt=2048, steps=32, cache=2080, check_tokens=64,
                gemma_prompt=8192, gemma_steps=16, phi_layers=2, phi_prompt=2048,
                phi_steps=8, windows=32_768, queries=512, window_batch=256,
                window_len=32, oracle=64)
# every kernel the LM-embedding search launches (PERF.md §6 rows 1, 2, 2b, 3b)
LM_PATH = TWO_TOWER_PATH
# prefill and decode against forward, of the largest |logit|: the reference's
# own bound (tests/test_arch_smoke.py), bf16 summed in another order
LM_REL = 2e-2
# the float32 copy on the card against the float32 CPU forward (PERF.md §2:
# IEEE float32 in both, summed in another order)
LM_FP32_REL = 1e-4
# bf16 against the float32 copy, and the int8 cache against the bf16 one
# (the reference's bound, tests/test_arch_smoke.py)
LM_BF16_REL = 5e-2


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def rel_err(torch, got, want) -> float:
    """max |got - want| over max |want| (float32)."""
    got, want = got.float(), want.float().to(got.device)
    return float((got - want).abs().max() / want.abs().max())


def lm_tokens(np, vocab: int, batch: int, seq: int):
    """(batch, seq) prompt tokens from ``TokenStream(vocab, batch, seq, seed=0)``."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models.params import check_ids

    toks = TokenStream(vocab=vocab, batch=batch, seq=seq, seed=0).next()["tokens"][:, :-1]
    check_ids(toks, vocab, "tokens")
    return np.ascontiguousarray(toks)


def decode_cache(torch, model, prefill_cache: dict, max_seq: int, int8: bool = False) -> dict:
    """A ``max_seq``-slot decode cache holding ``prefill_cache`` (bf16 K/V
    of the prompt) in its first slots; ``int8`` quantises it per layer as
    ``quantize_kv`` does, the int8 cache's own write."""
    from repro_torch.models import layers

    c = model.cfg
    dev = prefill_cache["k"].device
    s = prefill_cache["k"].shape[2]
    spec = dataclasses.replace(c, kv_cache_dtype="int8" if int8 else "bf16")
    shapes = type(model)(spec).init_cache_shapes(prefill_cache["k"].shape[1], max_seq)
    cache = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev) for k, v in shapes.items()}
    for key in ("k", "v"):
        for i in range(c.n_layers):
            if int8:
                q, scale = layers.quantize_kv(prefill_cache[key][i])
                cache[key][i, :, :s] = q
                cache[key + "_scale"][i, :, :s] = scale
            else:
                cache[key][i, :, :s] = prefill_cache[key][i]
    return cache


def greedy(torch, model, cache: dict, first, start: int, steps: int, feed=None):
    """``steps`` decode steps from position ``start``, each feeding the
    argmax of the last logits (or ``feed[:, i]``); returns (the tokens fed
    (B, steps), each step's logits, ms by CUDA events, s by host clock)."""
    toks, outs = [], []
    tok = first
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    with torch.inference_mode():
        for i in range(steps):
            if feed is not None:
                tok = feed[:, i:i + 1]
            toks.append(tok)
            logits, cache = model.decode_step(cache, tok, start + i)
            outs.append(logits)
            tok = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
    ev1.record()
    torch.cuda.synchronize()
    return torch.cat(toks, dim=1), outs, ev0.elapsed_time(ev1), time.perf_counter() - t0


def fp32_copy_check(torch, np, failures, tag: str, model, dev, tokens_np) -> dict:
    """A float32 copy of ``model`` on the card against the float32 copy on
    the CPU, ``forward`` over ``tokens_np``: within LM_FP32_REL of the
    largest |logit|.  Returns the row and the card's copy."""
    from repro_torch.models.params import cast_model

    t0 = time.perf_counter()
    card32 = cast_model(model, torch.float32, dev)
    # the CPU copy from the card's float32 one: a plain copy of the same
    # values (bf16 -> float32 is exact), no conversion on the host
    cpu = cast_model(card32, torch.float32, "cpu")
    t_copy = time.perf_counter() - t0
    with torch.inference_mode():
        got = card32.forward(torch.as_tensor(tokens_np, device=dev)).cpu()
        want = cpu.forward(torch.as_tensor(tokens_np))
    del cpu
    row = dict(tokens=list(tokens_np.shape), rel_err=rel_err(torch, got, want),
               max_abs_logit=float(want.abs().max()),
               finite=bool(torch.isfinite(got).all()), copy_seconds=t_copy,
               seconds=time.perf_counter() - t0)
    if not (row["finite"] and row["rel_err"] <= LM_FP32_REL):
        failures.append(f"lm {tag}: the float32 copy on the card against the CPU: {row}")
    return row, card32


class MoELoads:
    """Counts, per ``moe_block`` call of the port, the pairs each expert
    was given and those past capacity, from the call's own inputs and the
    same router arithmetic (the model's ``layers.moe_block`` wrapped)."""

    def __init__(self, torch):
        from repro_torch.models import layers

        self.torch, self.layers, self.calls = torch, layers, []
        self._orig = layers.moe_block

    def __enter__(self):
        torch, layers = self.torch, self.layers

        def wrapped(x, router_w, w_gate, w_up, w_down, dims):
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ router_w.float(), dim=-1)
            top_e = layers._top_k_largest(probs, dims.top_k)[1]
            load = torch.bincount(top_e.reshape(-1), minlength=dims.n_experts)
            self.calls.append((load, dims.capacity))
            return self._orig(x, router_w, w_gate, w_up, w_down, dims)

        layers.moe_block = wrapped
        return self

    def __exit__(self, *exc):
        self.layers.moe_block = self._orig

    def rows(self) -> list:
        return [dict(pairs=int(load.sum()), capacity=cap, load=load.tolist(),
                     dropped=int((load - cap).clamp_min(0).sum()))
                for load, cap in self.calls]


def lm_llama(torch, np, failures: list, record: dict, dev, sizes=LM_SIZES):
    """Step 1: the full Llama-3.2-1B config (bf16, weights from seed 0 on
    the card): prefill, greedy decode, held to ``forward``; a float32 copy
    on the card held to the CPU and the bf16 logits to it.  Returns the
    bf16 model for the embedding search."""
    from repro_torch.configs.lm_archs import LLAMA32_1B
    from repro_torch.models.transformer import LMModel

    cfg = LLAMA32_1B
    row: dict = {}
    record["lm llama"] = row
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LMModel(cfg).init_params(torch.Generator(dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    row["init"] = dict(seconds=time.perf_counter() - t0, n_params=cfg.n_params(),
                       param_bytes=model.param_bytes())
    b, s, steps = sizes["batch"], sizes["prompt"], sizes["steps"]
    prompt = torch.as_tensor(lm_tokens(np, cfg.vocab, b, s), device=dev)
    with torch.inference_mode():
        model.prefill(prompt[:, :128])  # warm-up, not timed
        (logits, pcache), pre_ms = event_ms(torch, lambda: model.prefill(prompt))
        full, fwd_ms = event_ms(torch, lambda: model.forward(prompt))
        prefill_rel = rel_err(torch, logits, full[:, -1])
        del full
    cache = decode_cache(torch, model, pcache, sizes["cache"])
    del pcache
    first = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
    greedy(torch, model, decode_cache(torch, model, {k: v[:, :, :8] for k, v in cache.items()},
                                      16), first, 8, 1)  # warm-up
    fed, outs, dec_ms, dec_s = greedy(torch, model, cache, first, s, steps)
    decode_rel = []
    with torch.inference_mode():
        for i in range(2):  # forward over the grown sequence
            grown = torch.cat([prompt, fed[:, :i + 1]], dim=1)
            decode_rel.append(rel_err(torch, outs[i], model.forward(grown)[:, -1]))
    finite = bool(torch.isfinite(logits).all()) and all(bool(torch.isfinite(o).all())
                                                        for o in outs)
    row["serve"] = dict(
        prompt=[b, s], prefill_ms=pre_ms, prefill_tokens_per_s=b * s / (pre_ms / 1e3),
        forward_ms=fwd_ms, decode_steps=steps, cache_slots=sizes["cache"],
        decode_ms_per_step=dec_ms / steps, decode_tokens_per_s=b * steps / (dec_ms / 1e3),
        decode_host_ms_per_step=dec_s * 1e3 / steps,
        decode_host_tokens_per_s=b * steps / dec_s,
        prefill_vs_forward=prefill_rel, decode_vs_forward=decode_rel, finite=finite,
        max_memory_allocated=torch.cuda.max_memory_allocated())
    log("lm llama serve " + json.dumps(row["serve"]))
    if not (finite and prefill_rel <= LM_REL and all(r <= LM_REL for r in decode_rel)):
        failures.append(f"lm llama: prefill / decode against forward: {row['serve']}")
    del cache, outs

    # the float32 copy: on the card against the CPU, and the bf16 logits to it
    row["fp32"], card32 = fp32_copy_check(torch, np, failures, "llama", model, dev,
                                          lm_tokens(np, cfg.vocab, 1, sizes["check_tokens"]))
    with torch.inference_mode():
        logits32, _ = card32.prefill(prompt)
    del card32
    torch.cuda.empty_cache()
    agree = (logits.argmax(-1) == logits32.argmax(-1)).float().mean()
    row["bf16_vs_fp32"] = dict(rel_err=rel_err(torch, logits, logits32),
                               argmax_agreement=float(agree), positions=b)
    log("lm llama fp32 " + json.dumps(row["fp32"]) + " bf16 vs fp32 "
        + json.dumps(row["bf16_vs_fp32"]))
    if row["bf16_vs_fp32"]["rel_err"] > LM_BF16_REL:
        failures.append(f"lm llama: bf16 against the float32 copy: {row['bf16_vs_fp32']}")
    return model


def lm_retrieval(torch, np, failures: list, record: dict, dev, model, sizes=LM_SIZES) -> dict:
    """Step 5: 32,768 + 512 windows embedded by the full Llama (the
    example's ``embed_windows``), indexed and searched at K = 2,048 as the
    example does, held by phase 4's rules; rows 1, 3b, 2, 2b at these
    shapes.  Returns the launch counts and the kernel records."""
    import importlib.util

    from repro_torch.core import flat_index, tree
    from repro_torch.core.backends import EngineOpts
    from repro_torch.core.npdist import pairwise_np
    from repro_torch.data.metricsets import calibrate_threshold
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.tiles import TILE_BQ
    from repro_torch.models.params import check_ids

    spec = importlib.util.spec_from_file_location(
        "torch_lm_embedding_retrieval", ROOT / "examples" / "torch_lm_embedding_retrieval.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    row: dict = {}
    record["lm retrieval"] = row
    nb, seq = sizes["window_batch"], sizes["window_len"]
    n_windows = sizes["windows"] + sizes["queries"]
    stream = TokenStream(vocab=model.cfg.vocab, batch=nb, seq=seq, seed=0)
    batch_ms, embs = [], []
    t0 = time.perf_counter()
    for _ in range(n_windows // nb):
        toks = stream.next()["tokens"][:, :-1]
        check_ids(toks, model.cfg.vocab, "tokens")
        toks_dev = torch.as_tensor(toks, device=dev)
        e, ms = event_ms(torch, lambda: example.embed_windows(model, toks_dev))
        embs.append(e)
        batch_ms.append(ms)
    embed_s = time.perf_counter() - t0
    emb = np.concatenate(embs)
    queries, corpus = emb[:sizes["queries"]], emb[sizes["queries"]:]
    row["embed"] = dict(windows=n_windows, window_tokens=seq, batch=nb,
                        ms_per_batch_median=float(np.median(batch_ms)),
                        ms_per_batch_max=float(np.max(batch_ms)),
                        tokens_per_s=n_windows * seq / (sum(batch_ms) / 1e3),
                        host_seconds=embed_s, finite=bool(np.isfinite(emb).all()),
                        corpus=list(corpus.shape))
    log("lm retrieval embed " + json.dumps(row["embed"]))
    model.to_empty(device="meta")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    t = calibrate_threshold("l2", corpus, 2e-3)
    t_cal = time.perf_counter() - t0
    # the float64 oracles run beside the build and the warm-up; nothing runs
    # beside the timed calls
    n_or = sizes["oracle"]
    pool = ThreadPoolExecutor(2)
    truth = pool.submit(lambda: tree.exhaustive_search("l2", corpus, queries[:n_or], t))
    index = flat_index.build_bss("l2", corpus, n_pivots=12, n_pairs=16, block=128, device=dev)
    _ = index.device, index.device_bf16
    torch.cuda.synchronize()
    row["build"] = dict(seconds=time.perf_counter() - t0, calibrate_seconds=t_cal, t=t,
                        blocks=int(index.n_blocks), n_pad=int(index.data.shape[0]),
                        dim=int(index.data.shape[1]))
    oracle = pool.submit(lambda: flat_index.bss_query(index, queries[:n_or], t)[0])
    for precision in ("fp32", "bf16"):  # warm-up at K = 2,048, not timed
        flat_index.bss_query_batched(index, queries, t, opts=EngineOpts(precision=precision))
    t0 = time.perf_counter()
    oracle_hits, truth_hits = oracle.result(), truth.result()
    pool.shutdown()
    row["build"]["oracle_wait_seconds"] = time.perf_counter() - t0
    log("lm retrieval build " + json.dumps(row["build"]))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    reset_launch_counts()
    (hits, st32), s32 = timed(lambda: flat_index.bss_query_batched(
        index, queries, t, opts=EngineOpts(backend="cuda")))
    (hits16, st16), s16 = timed(lambda: flat_index.bss_query_batched(
        index, queries, t, opts=EngineOpts(backend="cuda", precision="bf16")))
    counts = launch_counts()
    log(f"lm retrieval launch counts: {counts}")
    (plain, stp), sp = timed(lambda: flat_index.bss_query_batched(
        index, queries, t, opts=EngineOpts(backend="torch")))
    hits = [sorted(h) for h in hits]
    n_p, bad_p, w_p = identity_hit_diffs(np, pairwise_np, corpus, queries, hits,
                                         [sorted(h) for h in plain], t)
    n_o, bad_o, w_o = identity_hit_diffs(np, pairwise_np, corpus, queries, hits[:n_or],
                                         [sorted(h) for h in oracle_hits], t)
    n_x, bad_x, w_x = identity_hit_diffs(np, pairwise_np, corpus, queries, hits[:n_or],
                                         [sorted(h) for h in truth_hits], t)
    sq = (corpus.astype(np.float64) ** 2).sum(1)
    equal = dict(hits=[sorted(h) for h in hits16] == hits,
                 **equal_fields(np, range_fields(np, [st16]), range_fields(np, [st32])))
    qtiles = -(-len(queries) // TILE_BQ)
    live = {"fp32": st32["tiles_computed"] / (qtiles * index.n_blocks),
            "bf16": st16["tiles_computed"] / (qtiles * index.n_blocks)}
    row["search"] = dict(
        queries=len(queries), t=t, hits=sum(map(len, hits)),
        dists_per_query=float(st32["dists_per_query"]),
        block_exclusion_rate=float(st32["block_exclusion_rate"]),
        queries_per_s=len(queries) / s32, bf16_queries_per_s=len(queries) / s16,
        plain_queries_per_s=len(queries) / sp, live_tile_share=live,
        bf16_recheck_points_per_query=float(st16["recheck_points_per_query"]),
        count_diff_queries_vs_torch=int(np.count_nonzero(
            np.asarray(st32["per_query_dists"]) != np.asarray(stp["per_query_dists"]))),
        hit_boundary_diffs_vs_torch=n_p, hit_boundary_diffs_vs_oracle=n_o,
        hit_boundary_diffs_vs_float64=n_x, oracle_queries=n_or,
        largest_diff_share_of_band=max(w_p, w_o, w_x),
        median_row_norm_sq=float(np.median(sq)), identity_band_at_t=float(
            RTOL * 2 * np.median(sq) / (2 * t)), equal_to_fp32=equal)
    log("lm retrieval search " + json.dumps(row["search"]))
    if bad_p or bad_o or bad_x:
        failures.append(f"lm retrieval: hits differ away from t {(bad_p + bad_o + bad_x)[:10]}")
    if not all(equal.values()):
        failures.append(f"lm retrieval: bf16 differs from fp32: {equal}")
    if row["search"]["hits"] == 0 or not row["embed"]["finite"]:
        failures.append(f"lm retrieval: no hits or non-finite embeddings: {row}")
    t0 = time.perf_counter()
    kernels = path_kernels(torch, np, failures, index, queries, live, "lm", identity=True)
    log(f"lm retrieval kernels {time.perf_counter() - t0:.2f} s")
    return dict(counts=counts, kernels=kernels)


def lm_gemma(torch, np, failures: list, record: dict, dev, sizes=LM_SIZES) -> None:
    """Step 2: the full Gemma 2 9B config: prefill over 8,192 tokens (past
    the window) against ``forward``; 16 greedy decode steps with a bf16
    cache and the same tokens through the config's int8 cache."""
    from repro_torch.configs.lm_archs import GEMMA2_9B
    from repro_torch.models.transformer import LMModel

    cfg = GEMMA2_9B
    row: dict = {}
    record["lm gemma"] = row
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LMModel(cfg).init_params(torch.Generator(dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    row["init_seconds"] = time.perf_counter() - t0
    s, steps = sizes["gemma_prompt"], sizes["gemma_steps"]
    prompt = torch.as_tensor(lm_tokens(np, cfg.vocab, 1, s), device=dev)
    with torch.inference_mode():
        model.prefill(prompt[:, :128])  # warm-up, not timed
        (logits, pcache), pre_ms = event_ms(torch, lambda: model.prefill(prompt))
        full, fwd_ms = event_ms(torch, lambda: model.forward(prompt))
        prefill_rel = rel_err(torch, logits, full[:, -1])
        del full
    first = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
    cache = decode_cache(torch, model, pcache, s + steps)
    fed, outs16, ms16, _ = greedy(torch, model, cache, first, s, steps)
    del cache
    cache8 = decode_cache(torch, model, pcache, s + steps, int8=True)
    del pcache
    _, outs8, ms8, _ = greedy(torch, model, cache8, first, s, steps, feed=fed)
    del cache8
    int8_rel = [rel_err(torch, a, b) for a, b in zip(outs8, outs16)]
    finite = all(bool(torch.isfinite(o).all()) for o in [logits, *outs16, *outs8])
    row.update(prompt=[1, s], window=cfg.sliding_window, prefill_ms=pre_ms,
               prefill_tokens_per_s=s / (pre_ms / 1e3), forward_ms=fwd_ms,
               prefill_vs_forward=prefill_rel, decode_steps=steps,
               decode_ms_per_step_bf16=ms16 / steps, decode_ms_per_step_int8=ms8 / steps,
               int8_vs_bf16_last=int8_rel[-1], int8_vs_bf16_max=max(int8_rel), finite=finite,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    log("lm gemma " + json.dumps(row))
    if not (finite and prefill_rel <= LM_REL and int8_rel[-1] <= LM_BF16_REL):
        failures.append(f"lm gemma: {row}")
    model.to_empty(device="meta")
    del outs16, outs8, logits
    torch.cuda.empty_cache()


def lm_phi(torch, np, failures: list, record: dict, dev, sizes=LM_SIZES) -> None:
    """Step 3: Phi-3.5-MoE at full width cut to 2 layers: prefill 2,048
    tokens and 8 greedy decode steps, the tokens past capacity and the load
    per expert of each MoE call; a float32 copy on the card against the
    CPU."""
    from repro_torch.configs.lm_archs import PHI35_MOE
    from repro_torch.models.transformer import LMModel

    row: dict = {}
    record["lm phi"] = row
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(PHI35_MOE, n_layers=sizes["phi_layers"])
    model = LMModel(cfg).init_params(torch.Generator(dev).manual_seed(0), device=dev)
    s, steps = sizes["phi_prompt"], sizes["phi_steps"]
    prompt = torch.as_tensor(lm_tokens(np, cfg.vocab, 1, s), device=dev)
    with torch.inference_mode():
        model.prefill(prompt[:, :128])  # warm-up, not timed
        with MoELoads(torch) as loads:
            (logits, pcache), pre_ms = event_ms(torch, lambda: model.prefill(prompt))
    first = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
    cache = decode_cache(torch, model, pcache, s + steps)
    del pcache
    with MoELoads(torch) as dloads:
        _, outs, dec_ms, _ = greedy(torch, model, cache, first, s, steps)
    del cache
    finite = all(bool(torch.isfinite(o).all()) for o in [logits, *outs])
    row["serve"] = dict(layers=cfg.n_layers, prompt=[1, s], prefill_ms=pre_ms,
                        prefill_tokens_per_s=s / (pre_ms / 1e3), decode_steps=steps,
                        decode_ms_per_step=dec_ms / steps, prefill_moe=loads.rows(),
                        decode_dropped=sum(r["dropped"] for r in dloads.rows()),
                        finite=finite, max_memory_allocated=torch.cuda.max_memory_allocated())
    log("lm phi " + json.dumps(row["serve"]))
    if not finite:
        failures.append(f"lm phi: non-finite logits: {row['serve']}")
    row["fp32"], card32 = fp32_copy_check(torch, np, failures, "phi", model, dev,
                                          lm_tokens(np, cfg.vocab, 1, sizes["check_tokens"]))
    log("lm phi fp32 " + json.dumps(row["fp32"]))
    del card32
    model.to_empty(device="meta")
    torch.cuda.empty_cache()


def lm(torch, np, failures: list, record: dict, dev, sizes=LM_SIZES) -> dict:
    """Phase 22: the LM family's serving path on the card: the Llama, its
    embedding search (before the card is given to Gemma), Gemma 2, Phi.
    Returns the search's launch counts and kernel records."""
    torch.cuda.empty_cache()
    log(f"lm phase on {card_line()}")
    seconds = {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        return out

    model = step("llama", lambda: lm_llama(torch, np, failures, record, dev, sizes))
    out = step("retrieval", lambda: lm_retrieval(torch, np, failures, record, dev, model,
                                                 sizes))
    step("gemma", lambda: lm_gemma(torch, np, failures, record, dev, sizes))
    step("phi", lambda: lm_phi(torch, np, failures, record, dev, sizes))
    log("lm seconds " + json.dumps(seconds))
    return out


# LM training on the card (PERF.md §4): the full Llama-3.2-1B config (bf16,
# remat on) at train_4k's 4,096 tokens a row, its batch cut from 256 rows to
# the 2 that fit about 70 GB, AdamW at the config's settings (lr held at its
# schedule's peak: the 200-step warm-up's first rates move no bf16 weight),
# one TokenStream batch repeated; Phi-3.5-MoE at full width, 2 of 32 layers,
# one step over its config's 4 microbatches of 512 tokens, with its
# config's AdamW applied in place (the functional apply would hold AdamW's
# float32 m and v for its 2.86 B parameters twice beside the float32
# gradients, past 80 GB); float32 copies at cut depth against the CPU
# (Phi's at 1 layer: its 2-layer copy held the CPU 28 s).
LM_TRAIN = dict(batch=2, seq=4096, steps=4, lr=3e-4, seed=0, warmup_seq=256,
                check_layers=2, check_tokens=256, phi_layers=2, phi_batch=4,
                phi_seq=512, phi_check_layers=1, phi_check_tokens=64)
# the float32 copy's loss on the card against the CPU's, relative: a mean of
# cross-entropies over logits held at 1e-4 of max|logit| (LM_FP32_REL), whose
# errors average out (read in the tests: within 1e-7 of JAX's)
LM_TRAIN_LOSS_REL = 1e-5
# each gradient leaf of the float32 copy against the CPU's, of the leaf's
# largest |gradient|: the logits' bound, LM_FP32_REL (IEEE float32 on both,
# summed in another order; K-term products off by ~sqrt(K)·2^-24 ≈ 5e-6 at
# K ≤ 8,192, the backward's products as the forward's)
LM_TRAIN_GRAD_REL = LM_FP32_REL

# GNN training on the card (PERF.md §4): the PNA trunk with each cell's head
# at the cell's padded shape, flat and dst-partitioned (512 blocks) layouts,
# AdamW at the config's peak lr of 3e-4 on one batch repeated (3e-3
# overshoots at the second step on the Cora and molecule heads); minibatch_lg from NeighborSampler
# (1,024 seeds, fanout 15-10) over a synthetic graph of Reddit's 232,965
# nodes, 602 features and 41 classes, 15 neighbours a node (Reddit's 114.6 M
# edges cut: the fanout is all the sample reads).
GNN_TRAIN = dict(seed=0, steps=4, lr=3e-4, lg_nodes=232_965, lg_degree=15,
                 lg_fanout=(15, 10), lg_seeds=1024)
GNN_CELLS = ("full_graph_sm", "minibatch_lg", "molecule")
# the two layouts' logits (tests/test_arch_smoke.py:95's bound); the float32
# loss on the card against the CPU's, relative; each gradient leaf of a
# float64 copy on the card against the CPU's, of the leaf's largest.  PNA's
# float32 gradient is ill-conditioned: where a (node, channel)'s variance
# lies within a rounding of 0, the std's d/dvar = 0.5 / sqrt(var + 1e-6)
# (up to 500) moves with the variance's rounding, and maximum(var, 0)
# passes all, half or none of it.  So a float32 gradient lies far more than
# a rounding from the float64 one on either device, by an amount that
# changes from one rounding to the next: in the smoke's runs the CPU's own
# float32 w_in lies 1.3e-3 of its largest from float64 on full_graph_sm
# where the card's lies 2.6e-4, and on minibatch_lg the card's b_msg lies
# 2.1 times as far as the CPU's.  A float32 leaf on the card is held to
# the CPU's float64 one within GNN_F32_GRAD_REL, a bound for a wrong or
# missing term (which moves a leaf by a share of its own size), not for
# rounding; the segment ops, the card's own float32 code, are held to the
# CPU's bit for bit, forward and backward, at each cell's shapes
GNN_LAYOUT_TOL = 1e-5
GNN_REL = 1e-5
GNN_F32_GRAD_REL = 5e-2


def cut_layers(model, n: int):
    """A model of ``model``'s config cut to its first ``n`` layers, over views
    of the same weights."""
    _, keys = model._layer_params()
    tree = {k: (v[:n] if k in keys else v) for k, v in model.param_tree().items()}
    return type(model)(dataclasses.replace(model.cfg, n_layers=n)).load_param_tree(tree)


def grads_of(model, batch: dict, microbatches: int = 1):
    """(loss, gradient tree) of ``model.loss_fn`` over ``batch``, as the
    train step computes them."""
    from repro_torch.train.step import functional_loss, make_train_step

    step = make_train_step(functional_loss(model, model.loss_fn), None, microbatches)
    return step.grads(model.param_tree(), batch)


def leaf_rel(torch, got, want) -> dict:
    """Each leaf's max |got - want| over its largest |want| (on ``got``'s
    device)."""
    from repro_torch.pytree import leaves_with_paths, path_key

    out = {}
    for (p, g), (_, w) in zip(leaves_with_paths(got), leaves_with_paths(want)):
        w = w.to(g.device)
        out[path_key(p)] = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
    return out


def against(torch, loss, grads, ref) -> dict:
    """(loss, gradients) of a card against ``ref``, the CPU's: the loss's
    relative error and each leaf's error over its largest |gradient|."""
    from repro_torch.pytree import leaves

    want_l, want = ref
    errs = leaf_rel(torch, grads, want)
    finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                                for g in leaves(grads))
    return dict(loss=float(loss), cpu_loss=float(want_l),
                loss_rel=abs(float(loss) - float(want_l)) / abs(float(want_l)),
                grad_rel_max=max(errs.values()), grad_rel=errs, finite=finite)


def grads_against_cpu(torch, model32, cpu32, batch: dict) -> dict:
    """The loss and gradients of ``model32`` (on a card) against ``cpu32``
    (the same weights on the CPU) over ``batch`` (``against``)."""
    dev = next(model32.parameters()).device
    loss, grads = grads_of(model32, {k: v.to(dev) for k, v in batch.items()})
    return against(torch, loss, grads, grads_of(cpu32, {k: v.cpu() for k, v in batch.items()}))


def repeat_step(torch, step, state, batch) -> dict:
    """One train step run twice from ``state`` on ``batch``: the leaves of
    the loss, the gradients and the new state that differ in any bit.
    Returns the row and the first run's new state."""
    l1, g1 = step.grads(state["params"], batch)
    l2, g2 = step.grads(state["params"], batch)
    row = dict(loss_equal=bool(torch.equal(int_bits(torch, l1), int_bits(torch, l2))),
               differing_grads=differing_leaves(torch, g1, g2))
    del g2
    s1 = step.apply(state, g1)
    s2 = step.apply(state, g1)
    row["differing_state"] = differing_leaves(torch, s1, s2)
    row["bit_equal"] = row["loss_equal"] and not row["differing_grads"] \
        and not row["differing_state"]
    return row, s1


def timed_steps(torch, np, step, state, batch, n: int, dev) -> tuple[dict, dict]:
    """``n`` train steps on ``batch``: each step's ms by CUDA events (host
    clock on the CPU) and by host clock around its loss read, its loss and
    the peak memory.  Returns (the row, the last state)."""
    import math

    cuda = dev.type == "cuda"
    rows = []
    for _ in range(n):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        stamps = Stamps(torch, dev)
        t0 = time.perf_counter()
        stamps.mark()
        state, met = step(state, batch)
        stamps.mark()
        loss = float(met["loss"])
        host_ms = (time.perf_counter() - t0) * 1e3
        rows.append(dict(ms=stamps.ms()[0], host_ms=host_ms, loss=loss,
                         max_memory_allocated=torch.cuda.max_memory_allocated()
                         if cuda else None))
    losses = [r["loss"] for r in rows]
    out = dict(steps=rows, losses=losses, finite=all(math.isfinite(v) for v in losses),
               falls=len(losses) > 1 and losses[-1] < losses[0],
               ms_median_after_first=float(np.median([r["ms"] for r in rows[1:]] or
                                                     [rows[0]["ms"]])))
    return out, state


def lm_train_llama(torch, np, failures: list, record: dict, dev, model,
                   sizes=LM_TRAIN) -> None:
    """Step 1 of ``lm train``: ``model`` (the full Llama-3.2-1B, its weights
    drawn here from seed 0) trained on one TokenStream batch of ``batch`` ×
    ``seq`` tokens: timed steps, a step run twice, the float32 copy at cut
    depth against the CPU."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models.params import cast_model, check_ids
    from repro_torch.optim import adamw
    from repro_torch.train.step import functional_loss, init_state, make_train_step, to_device

    cfg = model.cfg
    # the generator and seed of the lm phase's draw
    t0 = time.perf_counter()
    model.init_params(torch.Generator(dev).manual_seed(0), device=dev)
    row: dict = dict(config=cfg.name, remat=cfg.remat, dtype=str(cfg.dtype),
                     init_seconds=time.perf_counter() - t0,
                     n_params=cfg.n_params(), batch=[sizes["batch"], sizes["seq"]],
                     microbatches=cfg.microbatches, lr=sizes["lr"])
    record["lm train llama"] = row
    if not cfg.remat:
        failures.append("lm train llama: the config's remat is off")
    raw = TokenStream(vocab=cfg.vocab, batch=sizes["batch"], seq=sizes["seq"],
                      seed=sizes["seed"]).next()
    check_ids(raw["tokens"], cfg.vocab, "tokens")
    batch = to_device(raw, dev)
    opt = adamw(lr=sizes["lr"])
    step = make_train_step(functional_loss(model, model.loss_fn), opt, cfg.microbatches)
    # a step over the first warmup_seq tokens, not timed, from a state not kept
    t0 = time.perf_counter()
    step.grads(model.param_tree(), {"tokens": batch["tokens"][:, :sizes["warmup_seq"] + 1]})
    row["warmup_seconds"] = time.perf_counter() - t0
    state = init_state(model.param_tree(), opt)
    row["train"], state = timed_steps(torch, np, step, state, batch, sizes["steps"], dev)
    log("lm train llama " + json.dumps(row))
    if not (row["train"]["finite"] and row["train"]["falls"]):
        failures.append(f"lm train llama: losses {row['train']['losses']}")
    row["repeat"], _ = repeat_step(torch, step, state, batch)
    del state
    log("lm train llama repeat " + json.dumps(row["repeat"]))
    if not row["repeat"]["bit_equal"]:
        failures.append(f"lm train llama: a step run twice differs: {row['repeat']}")
    torch.cuda.empty_cache()

    # the float32 copy at full width, cut depth, against the CPU
    t0 = time.perf_counter()
    cut = cut_layers(model, sizes["check_layers"])
    card32 = cast_model(cut, torch.float32, dev)
    cpu32 = cast_model(card32, torch.float32, "cpu")
    toks = TokenStream(vocab=cfg.vocab, batch=1, seq=sizes["check_tokens"], seed=1).next()
    row["fp32"] = grads_against_cpu(torch, card32, cpu32, to_device(toks, "cpu"))
    row["fp32"].update(layers=sizes["check_layers"], tokens=sizes["check_tokens"],
                       seconds=time.perf_counter() - t0, loss_bound=LM_TRAIN_LOSS_REL,
                       grad_bound=LM_TRAIN_GRAD_REL)
    del card32, cpu32, cut
    torch.cuda.empty_cache()
    log("lm train llama fp32 " + json.dumps(row["fp32"]))
    if not (row["fp32"]["finite"] and row["fp32"]["loss_rel"] <= LM_TRAIN_LOSS_REL
            and row["fp32"]["grad_rel_max"] <= LM_TRAIN_GRAD_REL):
        failures.append(f"lm train llama: the float32 copy against the CPU: {row['fp32']}")


def lm_train_phi(torch, np, failures: list, record: dict, dev, sizes=LM_TRAIN,
                 cfg=None) -> None:
    """Step 2 of ``lm train``: Phi-3.5-MoE at full width, 2 layers, one bf16
    step (its config's microbatches, float32 accumulation, its config's
    optimizer: AdamW on the cosine schedule) applied IN PLACE
    (``TrainStep.apply_``: one optimizer state);
    the step run twice from the same state (drawn again from seed 0), its
    gradients and new state compared by each leaf's digest, one state held
    at a time; the pairs past capacity counted; a float32 copy against the
    CPU.  ``cfg`` /
    ``dev`` shrink it for the CPU tests."""
    from repro_torch.configs.lm_archs import PHI35_MOE
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models.params import cast_model
    from repro_torch.models.transformer import LMModel
    from repro_torch.optim import make_optimizer
    from repro_torch.pytree import leaves
    from repro_torch.train.step import functional_loss, init_state, make_train_step, to_device

    cfg = cfg or dataclasses.replace(PHI35_MOE, n_layers=sizes["phi_layers"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = LMModel(cfg)
    opt = make_optimizer(cfg.optimizer)
    step = make_train_step(functional_loss(model, model.loss_fn), opt, cfg.microbatches,
                           accum_dtype=getattr(torch, cfg.grad_accum_dtype))
    batch = to_device(TokenStream(vocab=cfg.vocab, batch=sizes["phi_batch"],
                                  seq=sizes["phi_seq"], seed=0).next(), dev)

    def fresh():
        model.init_params(torch.Generator(dev).manual_seed(0), device=dev)
        return init_state(model.param_tree(), opt)

    state = fresh()
    stamps = Stamps(torch, dev)
    stamps.mark()
    l0, g0 = step.grads(state["params"], batch)
    stamps.mark()
    grads_first = leaf_digests(torch, g0)
    # the pairs each expert is sent, from a forward over the same
    # microbatches at the step's weights (remat runs each MoE call again in
    # the backward)
    with torch.no_grad(), MoELoads(torch) as loads:
        for mb in step._split(batch):
            model.loss_fn(mb)
    rows = loads.rows()
    stamps.mark()
    step.apply_(state, g0)
    stamps.mark()
    fwd_bwd_ms, _, apply_ms = stamps.ms()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    finite = bool(torch.isfinite(l0)) and all(bool(torch.isfinite(p).all())
                                             for p in leaves(state["params"]))
    first = leaf_digests(torch, state)
    del g0, state
    # the step again from the same state, drawn afresh: one state at a time
    state = fresh()
    l1, g1 = step.grads(state["params"], batch)
    repeat = dict(loss_equal=bool(torch.equal(int_bits(torch, l0), int_bits(torch, l1))),
                  differing_grads=[i for i, (a, b) in enumerate(
                      zip(grads_first, leaf_digests(torch, g1))) if a != b])
    step.apply_(state, g1)
    repeat["differing_state"] = [i for i, (a, b) in enumerate(
        zip(first, leaf_digests(torch, state))) if a != b]
    repeat["bit_equal"] = repeat["loss_equal"] and not repeat["differing_grads"] \
        and not repeat["differing_state"]
    del g1, state
    row = dict(layers=cfg.n_layers, batch=[sizes["phi_batch"], sizes["phi_seq"]],
               microbatches=cfg.microbatches, optimizer=cfg.optimizer, apply="in place",
               loss=float(l0), finite=finite, event_ms_forward_backward=fwd_bwd_ms,
               event_ms_optimizer=apply_ms, moe_calls=len(rows),
               pairs=sum(r["pairs"] for r in rows), dropped=sum(r["dropped"] for r in rows),
               capacity=rows[0]["capacity"] if rows else None,
               max_memory_allocated=peak, repeat=repeat)
    record["lm train phi"] = row
    log("lm train phi " + json.dumps(row))
    if not (finite and row["repeat"]["bit_equal"] and rows):
        failures.append(f"lm train phi: {row}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    card32 = cast_model(cut_layers(model, sizes["phi_check_layers"]), torch.float32, dev)
    model.to_empty(device="meta")
    cpu32 = cast_model(card32, torch.float32, "cpu")
    toks = TokenStream(vocab=cfg.vocab, batch=1, seq=sizes["phi_check_tokens"], seed=1).next()
    row["fp32"] = grads_against_cpu(torch, card32, cpu32, to_device(toks, "cpu"))
    row["fp32"].update(layers=sizes["phi_check_layers"], tokens=sizes["phi_check_tokens"],
                       seconds=time.perf_counter() - t0)
    del card32, cpu32
    torch.cuda.empty_cache()
    log("lm train phi fp32 " + json.dumps({k: v for k, v in row["fp32"].items()
                                           if k != "grad_rel"}))
    if not (row["fp32"]["finite"] and row["fp32"]["loss_rel"] <= LM_TRAIN_LOSS_REL
            and row["fp32"]["grad_rel_max"] <= LM_TRAIN_GRAD_REL):
        failures.append(f"lm train phi: the float32 copy against the CPU: {row['fp32']}")


def lm_train(torch, np, failures: list, record: dict, dev) -> None:
    """Phase 23: LM training on the card (the full Llama, then Phi)."""
    from repro_torch.configs.lm_archs import LLAMA32_1B
    from repro_torch.models.transformer import LMModel

    torch.cuda.empty_cache()
    log(f"lm train phase on {card_line()}")
    seconds = {}
    t0 = time.perf_counter()
    model = LMModel(LLAMA32_1B)
    lm_train_llama(torch, np, failures, record, dev, model)
    seconds["llama"] = time.perf_counter() - t0
    model.to_empty(device="meta")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm_train_phi(torch, np, failures, record, dev)
    seconds["phi"] = time.perf_counter() - t0
    log("lm train seconds " + json.dumps(seconds))


def block_balanced_ids(np, dst, n_pad: int, s_blocks: int):
    """New node ids placing the ``n_pad`` nodes ``s_blocks`` blocks of
    ``n_pad // s_blocks`` so that each block's in-edges are even (greedy:
    the nodes by in-degree, largest first, each into the least-loaded block
    with room), as a partitioner balancing edges lays out a graph's nodes.
    Returns ``new_id`` (``new_id[old] = new``)."""
    import heapq

    n_loc = n_pad // s_blocks
    deg = np.bincount(dst, minlength=n_pad)
    order = np.argsort(-deg, kind="stable")
    heap = [(0, b) for b in range(s_blocks)]
    fill = np.zeros(s_blocks, np.int64)
    new_id = np.empty(n_pad, np.int64)
    for node in order:
        load, b = heapq.heappop(heap)
        new_id[node] = b * n_loc + fill[b]
        fill[b] += 1
        if fill[b] < n_loc:
            heapq.heappush(heap, (load + int(deg[node]), b))
    return new_id


def relabel(np, batch: dict, new_id) -> dict:
    """``batch`` with node ``i`` moved to ``new_id[i]``."""
    inv = np.empty_like(new_id)
    inv[new_id] = np.arange(new_id.size)
    out = dict(batch)
    for k in ("x", "labels", "label_mask", "graph_id"):
        if k in out and out[k].shape[0] == new_id.size:
            out[k] = out[k][inv]
    out["edge_src"] = new_id[batch["edge_src"]].astype(np.int32)
    out["edge_dst"] = new_id[batch["edge_dst"]].astype(np.int32)
    return out


def gnn_cell_batch(np, cell: str, spec: dict, seed: int, sizes=GNN_TRAIN) -> dict:
    """A flat batch of ``cell`` at the shape of its spec (``gnn_cells``):
    full_graph_sm a random graph of Cora's counts, molecule 128
    ``batched_molecules``, minibatch_lg a ``NeighborSampler`` draw over a
    synthetic graph of Reddit's nodes; padding nodes have degree 0 and no
    label weight (a graph id past the last, for molecules)."""
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.data.pipeline import NeighborSampler, batched_molecules

    s = GNN_SHAPES[cell]
    n_pad, f = spec["x"].shape
    rng = np.random.default_rng(seed)
    if cell == "molecule":
        g = s["graphs"]
        b = batched_molecules(rng, g, s["n"] // g, s["e"] // g, f, s["classes"])
        pad = n_pad - s["n"]
        b["x"] = np.concatenate([b["x"], np.zeros((pad, f), np.float32)])
        b["graph_id"] = np.concatenate([b["graph_id"], np.full(pad, g, np.int32)])
        return b
    if cell == "minibatch_lg":
        n, d = sizes["lg_nodes"], sizes["lg_degree"]
        indptr = np.arange(n + 1, dtype=np.int64) * d
        indices = rng.integers(0, n, n * d)
        feats = rng.standard_normal((n, f), dtype=np.float32)
        labels = rng.integers(0, s["classes"], n).astype(np.int32)
        b = NeighborSampler(indptr, indices, feats, labels, sizes["lg_seeds"],
                            sizes["lg_fanout"], seed=seed).next()
        if b["x"].shape[0] != n_pad or b["edge_src"].size != s["e"]:
            raise ValueError(f"{cell}: the sample has {b['x'].shape[0]} nodes and "
                             f"{b['edge_src'].size} edges")
        return b
    n, e = s["n"], s["e"]
    x = np.zeros((n_pad, f), np.float32)
    x[:n] = rng.standard_normal((n, f), dtype=np.float32)
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = 1.0
    return {"x": x, "edge_src": rng.integers(0, n, e).astype(np.int32),
            "edge_dst": rng.integers(0, n, e).astype(np.int32),
            "labels": rng.integers(0, s["classes"], n_pad).astype(np.int32),
            "label_mask": mask}


def gnn_layouts(np, cell: str, spec: dict, seed: int, sizes=GNN_TRAIN):
    """(flat batch, dst-partitioned batch) of ``cell``: the nodes relabelled
    so each of the spec's blocks fits its ``E_loc`` edges, then packed by
    ``partition_edges``.  Raises if a block would overflow."""
    from repro_torch.models.gnn import PNAModel

    s_blocks, e_loc = spec["edge_src"].shape
    flat = gnn_cell_batch(np, cell, spec, seed, sizes)
    n_pad = flat["x"].shape[0]
    flat = relabel(np, flat, block_balanced_ids(np, flat["edge_dst"], n_pad, s_blocks))
    counts = np.bincount(flat["edge_dst"] // (n_pad // s_blocks), minlength=s_blocks)
    if counts.max() > e_loc:
        raise ValueError(f"{cell}: a block holds {counts.max()} edges, E_loc is {e_loc}")
    ps, pd, pv = PNAModel.partition_edges(flat["edge_src"], flat["edge_dst"], n_pad, s_blocks,
                                          e_loc)
    part = {k: v for k, v in flat.items() if k not in ("edge_src", "edge_dst")}
    part.update(edge_src=ps, edge_dst_local=pd, edge_valid=pv)
    for key, (shape, dtype) in spec.items():
        got = part[key]
        if tuple(got.shape) != tuple(shape) or str(got.dtype) != str(dtype).split(".")[-1]:
            raise ValueError(f"{cell}: {key} is {got.shape} {got.dtype}, the cell's {shape} "
                             f"{dtype}")
    return flat, part, int(counts.max())


def timed(fn, *args):
    """(fn(*args), its seconds)."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def gnn_grad_checks(torch, card32, card64, r32, r64) -> tuple[dict, bool]:
    """The card's (loss, gradients) in float32 and float64 (``card32``,
    ``card64``) against the CPU's (``r32``, ``r64``): the float32 loss
    within GNN_REL of the CPU's, the float64 loss and each float64 leaf
    within GNN_REL (of the leaf's largest), and each float32 leaf's
    distance from the CPU's float64 one (``card_f32_vs_f64``) within
    GNN_F32_GRAD_REL; the CPU's own float32 leaf's distance
    (``cpu_f32_vs_f64``) is printed beside it.  Returns (the row, whether
    every check held)."""
    fp32, fp64 = against(torch, *card32, r32), against(torch, *card64, r64)
    card_gap, cpu_gap = leaf_rel(torch, card32[1], r64[1]), leaf_rel(torch, r32[1], r64[1])
    over = {k: v for k, v in card_gap.items() if not v <= GNN_F32_GRAD_REL}
    row = dict(fp32=fp32, fp64=fp64, card_f32_vs_f64=card_gap, cpu_f32_vs_f64=cpu_gap,
               f32_beyond_bound=over)
    ok = (fp32["finite"] and fp32["loss_rel"] <= GNN_REL and fp64["finite"]
          and fp64["loss_rel"] <= GNN_REL and fp64["grad_rel_max"] <= GNN_REL and not over)
    return row, ok


def segment_ops_against_cpu(torch, np, flat_np: dict, d: int, dev, seed: int = 0) -> list:
    """``models/gnn.py``'s segment ops in float32 at a cell's shapes (its
    flat edges; (E, d) messages with ReLU's zeros, so ties in the max and
    min) on ``dev`` against the CPU: the outputs and the gradients of
    ``segment_sum``, ``segment_max``, ``segment_min`` (through the
    ``isfinite`` fill) and ``take_rows``.  Returns the names whose bits
    differ."""
    from repro_torch.models import gnn

    rng = np.random.default_rng(seed)
    n = flat_np["x"].shape[0]
    src, dst = flat_np["edge_src"], flat_np["edge_dst"]
    vals = np.maximum(rng.standard_normal((dst.size, d), dtype=np.float32), 0)
    weights = rng.standard_normal((n, d), dtype=np.float32)
    rows = rng.standard_normal((n, d), dtype=np.float32)

    def run(device):
        v = torch.as_tensor(vals, device=device).requires_grad_(True)
        ids, w = torch.as_tensor(dst, device=device), torch.as_tensor(weights, device=device)
        out = {}
        for fn in (gnn.segment_sum, gnn.segment_max, gnn.segment_min):
            o = fn(v, ids, n)
            out[fn.__name__] = o.detach()
            out[fn.__name__ + " grad"], = torch.autograd.grad(
                (gnn._finite_or_zero(o) * w).sum(), v)
        h = torch.as_tensor(rows, device=device).requires_grad_(True)
        t = gnn.take_rows(h, torch.as_tensor(src, device=device).long())
        out["take_rows"] = t.detach()
        out["take_rows grad"], = torch.autograd.grad((t * v.detach()).sum(), h)
        return out

    got, want = run(dev), run(torch.device("cpu"))
    return [k for k in want
            if not torch.equal(int_bits(torch, got[k].cpu()), int_bits(torch, want[k]))]


def profile_step(torch, step, state, batch) -> dict:
    """One train step under ``torch.profiler`` (after one traced and thrown
    away): its ms, the device's busy ms and idle share, the kernel events
    the trace holds, and the five kernels with the most device time and
    the five host operators with the most self time (ms, calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    device, launches = trace_device(prof)
    busy = sum(device.values())
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type != DeviceType.CUDA and not is_span(e)),
                  key=lambda r: -r[1])[:5]
    return dict(traced_ms=ms, device_busy_ms=busy, device_idle_share=1.0 - busy / ms,
                kernel_events=sum(launches.values()),
                device_top={k: [round(t, 3), launches[k]] for k, t in
                            sorted(device.items(), key=lambda kv: -kv[1])[:5]},
                host_top={k: [round(t, 3), c] for k, t, c in host})


def gnn_cell(torch, np, failures: list, cell: str, model, data: tuple, dev,
             ckpt_dir: Path, sizes=GNN_TRAIN) -> tuple:
    """One GNN cell on ``dev`` over ``data`` (``gnn_layouts``): the two
    layouts' logits, AdamW steps in each layout, a step run twice, a
    checkpoint restored and stepped; then, on a card, a step of each layout
    profiled, the segment ops against the CPU's bits, and the card's
    float32 and float64 loss and gradients.  Returns the row and a function that
    computes the CPU references and checks the card against them (None on
    the CPU), for the caller to run once no step is timed."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.params import cast_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import functional_loss, init_state, make_train_step, to_device

    t0 = time.perf_counter()
    flat_np, part_np, max_block = data
    flat, part = to_device(flat_np, dev), to_device(part_np, dev)
    row = dict(nodes=int(flat_np["x"].shape[0]), edges=int(flat_np["edge_src"].size),
               features=int(flat_np["x"].shape[1]), blocks=list(part_np["edge_src"].shape),
               max_block_edges=max_block)
    with torch.no_grad():
        a, b = model.forward(flat), model.forward(part)
    row["layouts_max_abs"] = float((a - b).abs().max())
    row["layouts_agree"] = bool(torch.allclose(a, b, rtol=GNN_LAYOUT_TOL, atol=GNN_LAYOUT_TOL))
    if not (row["layouts_agree"] and bool(torch.isfinite(a).all())):
        failures.append(f"gnn {cell}: flat and partitioned logits differ: {row}")
    del a, b
    for name, batch in (("flat", flat), ("partitioned", part)):
        opt = adamw(lr=sizes["lr"])
        step = make_train_step(functional_loss(model, model.loss_fn), opt)
        state = init_state(model.param_tree(), opt)
        run, state = timed_steps(torch, np, step, state, batch, sizes["steps"], dev)
        run["repeat"], live = repeat_step(torch, step, state, batch)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        mgr = CheckpointManager(ckpt_dir, keep_last=1)
        mgr.save(sizes["steps"], state)
        restored, _ = mgr.restore(state, device=dev)
        again, _ = step(restored, batch)
        run["checkpoint_differing"] = differing_leaves(torch, live, again)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        row[name] = run
        if not (run["finite"] and run["falls"] and run["repeat"]["bit_equal"]
                and not run["checkpoint_differing"]):
            failures.append(f"gnn {cell} {name}: {run}")
    if dev.type == "cpu":
        row["card_seconds"] = time.perf_counter() - t0
        return row, None
    for name, batch in (("flat", flat), ("partitioned", part)):
        opt = adamw(lr=sizes["lr"])
        row[name]["profile"] = profile_step(
            torch, make_train_step(functional_loss(model, model.loss_fn), opt),
            init_state(model.param_tree(), opt), batch)
    row["segment_ops_differing"] = segment_ops_against_cpu(torch, np, flat_np,
                                                           model.cfg.d_hidden, dev)
    if row["segment_ops_differing"]:
        failures.append(f"gnn {cell}: segment ops differ from the CPU's bits: "
                        f"{row['segment_ops_differing']}")
    card32 = grads_of(model, part)
    card64 = grads_of(cast_model(model, torch.float64, dev), part)
    cpu32 = cast_model(model, torch.float32, "cpu")
    row["card_seconds"] = time.perf_counter() - t0

    def references():
        t1 = time.perf_counter()
        batch = to_device(part_np, "cpu")
        with ThreadPoolExecutor(2) as pool:
            r32 = pool.submit(grads_of, cpu32, batch)
            r64 = pool.submit(grads_of, cast_model(cpu32, torch.float64, "cpu"), batch)
            r32, r64 = r32.result(), r64.result()
        row["cpu_reference_seconds"] = time.perf_counter() - t1
        checks, ok = gnn_grad_checks(torch, card32, card64, r32, r64)
        row.update(checks)
        if not ok:
            failures.append(f"gnn {cell}: the card against the CPU: {checks}")

    return row, references


def gnn_train(torch, np, failures: list, record: dict, dev, sizes=GNN_TRAIN,
              cells=GNN_CELLS, ckpt_dir: Path = ROOT / "build" / "gnn_ckpt",
              layouts: dict | None = None) -> None:
    """Phase 24: GNN training on the card, each cell of ``cells`` at its
    padded shape (every cell's batch made on the host before the first
    step; the CPU references after the last, so nothing runs beside a
    timed step); ogb_products reckoned, not run.  ``layouts`` receives
    each cell's ``gnn_layouts`` (the sharded phase steps the same batch)."""
    layouts = {} if layouts is None else layouts
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.configs.registry import get_arch

    bundle = get_arch("pna")
    cuda = dev.type == "cuda"
    if cuda:
        log(f"gnn train phase on {card_line()}")
        torch.cuda.reset_peak_memory_stats()
    with ThreadPoolExecutor(len(cells)) as pool:
        data = {cell: pool.submit(timed, gnn_layouts, np, cell, bundle.cells[cell].inputs(),
                                  sizes["seed"], sizes) for cell in cells}
        data = {cell: f.result() for cell, f in data.items()}
    layouts.update({cell: d[0] for cell, d in data.items()})
    done = []
    for cell in cells:
        model = bundle.model_for(cell).init_params(
            torch.Generator(dev).manual_seed(sizes["seed"]), device=dev)
        row, references = gnn_cell(torch, np, failures, cell, model, data[cell][0], dev,
                                   ckpt_dir, sizes)
        row["data_seconds"] = data[cell][1]
        done.append((cell, row, references))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cells)) as pool:
        for f in [pool.submit(fn) for _, _, fn in done if fn is not None]:
            f.result()
    if cuda:
        log(f"gnn train cpu references {time.perf_counter() - t0:.2f} s")
    for cell, row, _ in done:
        record[f"gnn train {cell}"] = row
        log(f"gnn train {cell} " + json.dumps(row))
    if cuda:
        log(f"gnn train max_memory_allocated {torch.cuda.max_memory_allocated()}")

    # ogb_products does not fit one card: its partitioned edges, gathered
    s = GNN_SHAPES["ogb_products"]
    spec = bundle.cells["ogb_products"].inputs()
    e_pad = spec["edge_src"].shape[0] * spec["edge_src"].shape[1]
    d = bundle.model_for("ogb_products").cfg.d_hidden
    reckon = dict(nodes=s["n"], edges=s["e"], padded_edges=e_pad,
                  gather_bytes_each=e_pad * d * 4, concat_bytes=2 * e_pad * d * 4)
    record["gnn train ogb_products"] = reckon
    log("gnn train ogb_products not run (it does not fit one card; the dryrun line "
        "reckons it per device on the 16 x 16 mesh) " + json.dumps(reckon))


# The sharded train phase (PERF.md §4): each family's sharded step
# (parallel.sharded_step) on mesh devices of the one card (cuda:0 reused)
# against the one-device step from the same state, each timed after an
# untimed forward + backward whose gradient the timed one must repeat bit
# for bit.  Llama-3.2-1B at full width, depth cut to llama_layers, 2 x
# 4,096 tokens, AdamW in place, over S = 2 data shards and, split over
# "model" (the "model" plan: heads, MLP columns and vocabulary split, the
# residual stream sequence-sharded), over (1, 2), (1, 4) and (2, 2)
# ("data", "model") meshes; Phi-3.5-MoE at full width, depth cut to
# phi_layers, phi_microbatches microbatches of phi_batch / phi_microbatches
# rows x phi_seq tokens, expert-parallel over (1, 2) and (2, 2), its MoE
# block's routing (loads and drops per expert) held to one device's
# exactly and its output compared bit for bit; the full two-tower config at
# B = 32,768 over S = 2 and 4 and, its tables in "model" pieces (the lookups
# combined over "model", bit for bit with one device's), over (1, 2) and
# (2, 2) (the float64 copy, which holds the meshes that are not bit for
# bit, not on (1, 2): its one-device state beside the mesh's and the
# (B, B) float64 softmax pass 80 GB there); DLRM-RM2 at full width (26
# tables, B = 65,536, the reference's
# train_batch), its vocabulary cut to dlrm_vocab rows (the float32 copy's
# states and their comparisons at 10^6 rows pass 80 GB: PERF.md §4), over
# (1, 2) and (2, 2) with a float32 copy; PNA's minibatch_lg in the
# dst-partitioned layout over node shards (the "node" plan: (2, 1) and
# (2, 2)), its gradients held on a float64 copy (its float32 gradient is
# ill-conditioned: PERF.md §2; the float32 one's gap is recorded), and the
# reduced PNA on a well-conditioned graph (in-degree 8, 512 nodes in 16
# blocks) in float32.  A mesh whose one data shard computes it all (a
# data axis of 1 under "split" or "in_batch") is held bit for bit in loss,
# parameters and moments.
# Any other mesh is held to the loss within SHARDED_LOSS_REL relative, and
# each parameter within 2 lr of the one-device step's (plus one rounding
# for bf16: AdamW's first step moves an element by at most lr, so this
# catches an update misplaced or applied twice, not a wrong gradient).
# Its gradients are held two ways: float32 Llama and Phi copies and a
# float64 two-tower copy (the same weights, the full batch) to the
# training bound of PERF.md §2 (each gradient leaf within SHARDED_GRAD_REL
# of its largest, at most 1% of a leaf's parameters beyond 1e-5); the bf16
# configs and the float32 two tower, whose gradients carry their dtype's
# rounding (and the two tower's logits' cone, PERF.md §2), leaf by leaf
# against that wider copy's one-device gradient: the sharded step's
# largest gap to it no more than SHARDED_NO_WORSE times the one-device
# step's own, plus one rounding of the leaf's dtype for each shard of the
# mesh (``reference_gaps``).  A bf16 LM split over "model" rounds each
# shard's partial product to bf16 before the sum; at full width its loss
# still moves by less than 1e-5, so split_loss_rel is SHARDED_LOSS_REL here
# (a reduced width moves it more: the CPU tests set their own), and its
# gap to the float32 copy's loss is recorded beside the one-device gap.
# The one-device step's in-place apply is held to its functional apply bit
# for bit (Llama).
SHARDED_TRAIN = dict(seed=0, llama_layers=2, llama_batch=2, llama_seq=4096, llama_lr=3e-4,
                     llama_meshes=((2, 1), (1, 2), (1, 4), (2, 2)),
                     llama_f32_meshes=((2, 1), (1, 4), (2, 2)),
                     phi_layers=1, phi_batch=8, phi_seq=256, phi_microbatches=4, phi_lr=3e-4,
                     phi_meshes=((1, 2), (2, 2)),
                     tt_batch=32_768, tt_lr=3e-3, tt_meshes=((2, 1), (4, 1), (1, 2), (2, 2)),
                     tt_f64_meshes=((2, 1), (4, 1), (2, 2)),
                     dlrm_batch=65_536, dlrm_vocab=500_000, dlrm_lr=3e-3,
                     dlrm_meshes=((1, 2), (2, 2)),
                     gnn_cell="minibatch_lg", gnn_lr=3e-4, gnn_meshes=((2, 1), (2, 2)),
                     conditioned_nodes=512, conditioned_degree=8, conditioned_blocks=16,
                     split_loss_rel=1e-5)
# the reduced PNA of the well-conditioned case (tests/test_torch_cuda_gnn.py)
CONDITIONED_PNA = dict(name="pna-conditioned", n_layers=2, d_hidden=16, d_feat=8,
                       n_classes=3)
SHARDED_LOSS_REL = 1e-5
SHARDED_GRAD_REL = 1e-4
SHARDED_NO_WORSE = 2.0
# the cells the dryrun line reckons on the 16 x 16 mesh: none fits one card
DRYRUN_CELLS = (("pna", "ogb_products"), ("phi3.5-moe-42b-a6.6b", "train_4k"),
                ("llama3.2-1b", "train_4k"))


def leaf_digests(torch, tree, chunk: int = 1 << 24) -> list:
    """Three sums of each leaf's bits (int64, wrapping), chunk by chunk: the
    plain sum, the sum of squares, and the sum of each element's bits times
    its position + 1, so that moving values within a leaf (rows swapped)
    changes the digest too.  A step's state compared with another run's
    without a second copy of it.  The sums stay on the device until one
    read at the end."""
    from repro_torch.pytree import leaves

    sums = []
    for t in leaves(tree):
        v = int_bits(torch, t).reshape(-1)
        acc = torch.zeros(3, dtype=torch.int64, device=v.device)
        for i in range(0, v.numel(), chunk):
            x = v[i:i + chunk].long()
            pos = torch.arange(i + 1, i + 1 + x.numel(), dtype=torch.int64, device=x.device)
            acc += torch.stack([x.sum(), (x * x).sum(), (x * pos).sum()])
        sums.append(acc)
    if not sums:
        return []
    return [tuple(row) for row in torch.stack([a.to(sums[0].device) for a in sums]).tolist()]


def clone_tree(torch, tree):
    from repro_torch.pytree import tree_map

    return tree_map(lambda t: t.clone(), tree)


def param_gaps(torch, got: dict, want: dict, lr: float) -> dict:
    """A row-split step's new parameters and gradients (``got``: {"params",
    "grads"}) against the one-device step's (``want``), leaf by leaf: the
    gradient's largest gap over the leaf's largest |gradient|; the
    parameter's largest gap over its bound (2 lr; for a bf16 leaf plus one
    bf16 rounding of the larger value, 2 ** (e - 8) for a value in
    [2 ** (e - 1), 2 ** e)); the share of the leaf's elements beyond 1e-5
    (float32) or one rounding (bf16), in all and among the elements whose
    two gradients agree in sign; the share whose gradients' signs differ."""
    from repro_torch.pytree import leaves_with_paths, path_key

    out = {}
    pairs = zip(leaves_with_paths(got["params"]), leaves_with_paths(want["params"]),
                leaves_with_paths(got["grads"]), leaves_with_paths(want["grads"]))
    for (path, x), (_, y), (_, gx), (_, gy) in pairs:
        d = (x.float() - y.float()).abs()
        bound = torch.full_like(d, 2 * lr)
        floor = torch.full_like(d, 1e-5)
        if x.dtype == torch.bfloat16:
            _, e = torch.frexp(torch.maximum(x.float().abs(), y.float().abs()))
            floor = torch.ldexp(torch.ones_like(d), e - 8)
            bound = bound + floor
        gx, gy = gx.float(), gy.to(gx.device).float()
        same_sign = torch.sign(gx) == torch.sign(gy)
        beyond = d > floor
        out[path_key(path)] = dict(
            dtype=str(x.dtype).split(".")[-1],
            grad_rel=float((gx - gy).abs().max() / gy.abs().max().clamp_min(1e-30)),
            param_over_bound=float((d / bound).max()), param_max_abs=float(d.max()),
            share_beyond=float(beyond.float().mean()),
            share_beyond_same_sign=float((beyond & same_sign).float().mean()),
            share_sign_differs=float((~same_sign).float().mean()))
    return out


def reference_gaps(torch, got, one, ref, shards: int) -> dict:
    """Each gradient leaf of a row-split step over ``shards`` shards
    (``got``) and of the one-device step (``one``) against ``ref``, a wider
    copy's one-device gradient of the same weights on the same batch: each
    one's largest gap over ref's largest |value|, and the bound the sharded
    one is held to: SHARDED_NO_WORSE times the one-device gap, plus a
    rounding of the leaf's dtype for each shard (each shard's gradient is
    rounded to the leaf's dtype before the float32 sum, and the sum again
    after it, where the one-device step rounds once)."""
    from repro_torch.pytree import leaves_with_paths, path_key

    out = {}
    for (path, x), (_, y), (_, r) in zip(leaves_with_paths(got), leaves_with_paths(one),
                                         leaves_with_paths(ref)):
        r = r.to(x.device).double()
        top = r.abs().max().clamp_min(1e-300)
        sharded = float((x.double() - r).abs().max() / top)
        one_device = float((y.to(x.device).double() - r).abs().max() / top)
        out[path_key(path)] = dict(
            sharded=sharded, one_device=one_device,
            bound=SHARDED_NO_WORSE * one_device + shards * torch.finfo(x.dtype).eps / 2)
        del r
    return out


def conditioned_graph(np, seed: int, n: int, deg: int, blocks: int) -> dict:
    """A graph whose float32 PNA gradient is well conditioned (ROADMAP
    Queue 3 item 16): every node receives ``deg`` edges from other nodes
    and the 8 features are spread (standard deviation 2), in the
    dst-partitioned layout of ``blocks`` blocks."""
    from repro_torch.models.gnn import PNAModel

    rng = np.random.default_rng(seed)
    dst = np.repeat(np.arange(n), deg)
    src = (dst + rng.integers(1, n, dst.size)) % n
    ps, pd, pv = PNAModel.partition_edges(src, dst, n, blocks)
    return {"x": (rng.normal(size=(n, 8)) * 2.0).astype(np.float32),
            "edge_src": ps, "edge_dst_local": pd, "edge_valid": pv,
            "labels": rng.integers(0, 3, n).astype(np.int32),
            "label_mask": (rng.random(n) < 0.7).astype(np.float32)}


def split_lookups_equal(torch, model, batch: dict, mesh) -> dict:
    """Each lookup of a recsys model's ``split_loss`` on ``mesh`` (the
    tables in their "model" pieces, combined over "model") against the
    one-device lookup of each data shard's rows: ``{lookup: bit for bit on
    every mesh device}``."""
    from repro_torch.models.recsys import embedding_lookup
    from repro_torch.parallel.sharding import Placement, ShardedTensor, n_shards
    from repro_torch.pytree import tree_map

    specs = model.param_specs(mesh)
    placed = tree_map(lambda sp, t: ShardedTensor.place(t, Placement(mesh, sp)), specs,
                      model.param_tree())
    params = [tree_map(lambda st: st.gather_region(st.model_region(i), d), placed)
              for i, d in enumerate(mesh.devices)]
    del placed
    d = n_shards(mesh)
    rows = next(iter(batch.values())).shape[0]
    step = -(-rows // d)
    shards = [{k: v[s * step:(s + 1) * step] for k, v in batch.items()} for s in range(d)]
    with torch.no_grad():
        got = model.split_lookups(params, shards, mesh, specs)
    m = mesh.n_devices // d
    out = {}
    for name, (key, ids) in model._lookup_ids().items():
        table = getattr(model, key).detach()
        ok = True
        for r, t in enumerate(got[name]):
            i = ids(shards[r // m])
            want = embedding_lookup(table, i) if table.ndim == 3 else table[i.long()]
            ok = ok and bool(torch.equal(int_bits(torch, t), int_bits(torch, want)))
        out[name] = ok
    return out


def model_split(mesh) -> bool:
    """The mesh splits compute over more than one "model" shard."""
    return "model" in mesh.axis_names and mesh.size("model") > 1


def mesh_label(shape) -> str:
    """``S<d>`` for a data-only (d, 1) mesh, ``<d>x<m>`` otherwise."""
    d, m = shape
    return f"S{d}" if m == 1 else f"{d}x{m}"


def piece_digests(torch, grads) -> list:
    """``leaf_digests`` of a gradient tree whose leaves may be in pieces
    (``ShardedTensor``): each piece once, in piece order."""
    from repro_torch.parallel.sharding import ShardedTensor
    from repro_torch.pytree import leaves

    flat = []
    for g in leaves(grads):
        if isinstance(g, ShardedTensor):
            flat.extend(next(iter(by_dev.values())) for by_dev in g.pieces.values())
        else:
            flat.append(g)
    return leaf_digests(torch, flat)


def sharded_against_one(torch, np, failures: list, tag: str, family: str, model, opt,
                        batch: dict, meshes: list, dev, lr: float,
                        check_apply: bool = False, strict: bool = False,
                        reference=None, microbatches: int = 1,
                        reference_loss: float | None = None,
                        split_loss_rel: float = SHARDED_LOSS_REL,
                        reckon: bool = False,
                        hold_reference: bool = True) -> tuple[dict, object]:
    """One family's sharded step on each mesh of ``meshes`` ((label, mesh))
    against the one-device step from the same state (the model's
    parameters): ms a step by CUDA events after an untimed forward +
    backward (whose gradient and loss the timed one must repeat bit for
    bit), peak memory, the bytes one mesh device holds by its specs, the
    bytes held on the card, the parameter bytes each mesh device computes
    with (``compute_bytes``: its "model" pieces, whole over the data axes),
    with ``reckon``, an LM's per-device bytes as the dry run reckons the
    same step (``reckoned_bytes``), the bytes one device's collectives move
    in the timed step (``collectives``; a node split's ``halo_bytes``: its
    all-gathers of ``h``), and the comparison (``SHARDED_TRAIN``'s note; a
    mesh that is not one data shard computing it all: ``strict``, PERF.md
    §2's training bound and every gradient leaf within SHARDED_GRAD_REL of
    its largest; else ``reference``, a wider copy's one-device gradients,
    ``reference_gaps``, recorded and, with ``hold_reference``, held; the
    loss within SHARDED_LOSS_REL of the one-device loss, or
    ``split_loss_rel`` on an LM split over "model"; with
    ``reference_loss``, that copy's loss, each loss's gap to it is recorded
    beside the one-device gap).  Returns the row and the one-device step's
    gradients and loss."""
    from repro_torch.configs.common import loss_for
    from repro_torch.parallel.collectives import tally
    from repro_torch.parallel.sharded_step import gather_state, plan_for, sharded_step_for
    from repro_torch.pytree import leaves
    from repro_torch.train.step import functional_loss, init_state, make_train_step

    cuda = dev.type == "cuda"
    p0 = model.param_tree()  # each state below starts from a clone of it
    one = make_train_step(functional_loss(model, loss_for(family, model)), opt, microbatches)
    rows = plan_for(family, model)["rows"]
    row: dict = dict(rows=rows, dtype=str(model.cfg.dtype).split(".")[-1],
                     batch={k: list(v.shape) for k, v in batch.items()},
                     microbatches=microbatches)
    ref = init_state(clone_tree(torch, p0), opt)
    one.grads(ref["params"], batch)  # untimed
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    stamps = Stamps(torch, dev)
    stamps.mark()
    loss, grads = one.grads(ref["params"], batch)
    stamps.mark()
    functional = one.apply(ref, grads) if check_apply else None
    stamps.mark()
    one.apply_(ref, grads)
    stamps.mark()
    ms = stamps.ms()
    # one data shard of a row plan: the step's own bits (each table row has
    # one owner, the replicated weights' other copies add nothing)
    exact_of = {label: rows in ("split", "in_batch") and mesh.size("data") == 1
                for label, mesh in meshes}
    row["one_device"] = dict(ms=ms[0] + ms[2], ms_forward_backward=ms[0],
                             ms_apply_in_place=ms[2], loss=float(loss),
                             max_memory_allocated=torch.cuda.max_memory_allocated()
                             if cuda else None)
    if check_apply:
        row["in_place_vs_functional"] = differing_leaves(torch, ref, functional)
        del functional
        if row["in_place_vs_functional"]:
            failures.append(f"sharded train {tag}: the in-place apply differs from the "
                            f"functional one: {row['in_place_vs_functional']}")
    if not any(exact_of.values()):
        ref = {"params": ref["params"]}  # parameters are all that is compared
    for label, mesh in meshes:
        step = sharded_step_for(family, model, opt, mesh, microbatches=microbatches)
        state = step.shard(init_state(clone_tree(torch, p0), opt))
        l_first, g_first = step.grads(state, batch)  # untimed
        first = (piece_digests(torch, g_first), int_bits(torch, l_first).clone())
        del g_first
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        stamps = Stamps(torch, dev)
        stamps.mark()
        with tally() as moved:
            l_sh, g_sh = step.grads(state, batch)
        step.apply_(state, g_sh)
        stamps.mark()
        repeated = (piece_digests(torch, g_sh) == first[0]
                    and bool(torch.equal(int_bits(torch, l_sh), first[1])))
        held: dict = {}
        for s in leaves(state):
            for d, n in s.held_bytes().items():
                held[str(d)] = held.get(str(d), 0) + n
        device_bytes = sum(s.device_bytes() for s in leaves(state))
        exact = exact_of[label]
        whole = gather_state(state if exact else {"params": state["params"]}, dev)
        del state
        # one mesh device's share of the state by its specs; held: the
        # bytes on each distinct device (a piece two mesh devices of one
        # card share is held once)
        m = dict(mesh=mesh.sizes, ms=stamps.ms()[0], loss=float(l_sh),
                 device_bytes=device_bytes, held_bytes=held, exact=exact,
                 repeated_bit_for_bit=repeated,
                 compute_bytes=max(step.compute_bytes) if step.compute_bytes else None,
                 collectives=dict(moved),
                 max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else None)
        if rows == "node":
            m["halo_bytes"] = moved.get("all-gather", 0.0)
        if reckon:
            # one mesh device's bytes as the dry run reckons this step (the
            # activations of one model shard); the card holds every device's
            from repro_torch.launch.dryrun import reckon_lm_step

            tok = batch["tokens"].shape
            m["reckoned_bytes"] = reckon_lm_step(model, mesh, tok[0], tok[1] - 1, microbatches)
        if exact:
            m["differing_leaves"] = differing_leaves(torch, whole, ref)
            m["loss_equal"] = bool(torch.equal(int_bits(torch, l_sh),
                                               int_bits(torch, loss.to(l_sh.device))))
            ok = not m["differing_leaves"] and m["loss_equal"]
        else:
            g_sh = gather_state(g_sh, dev)
            m["loss_rel"] = abs(m["loss"] - float(loss)) / abs(float(loss))
            m["leaves"] = param_gaps(torch, {"params": whole["params"], "grads": g_sh},
                                     {"params": ref["params"], "grads": grads}, lr)
            m["lr"] = lr
            m["strict"] = strict
            if not strict:
                if reference is None:
                    raise ValueError(f"{tag}: a split that is not strict needs a "
                                     "reference gradient")
                m["against_reference"] = reference_gaps(torch, g_sh, grads, reference,
                                                        mesh.n_devices)
            m["loss_bound"] = (split_loss_rel if model_split(mesh) and rows == "model"
                               else SHARDED_LOSS_REL)
            if reference_loss is not None:
                # read beside the one-device gap, not held
                top = abs(reference_loss)
                m["loss_against_reference"] = dict(
                    sharded=abs(m["loss"] - reference_loss) / top,
                    one_device=abs(float(loss) - reference_loss) / top)
            ok = m["loss_rel"] <= m["loss_bound"] and all(
                r["param_over_bound"] <= 1.0 and (not strict or (
                    r["grad_rel"] <= SHARDED_GRAD_REL and r["share_beyond"] <= 0.01))
                for r in m["leaves"].values()) and (not hold_reference or all(
                r["sharded"] <= r["bound"] for r in m.get("against_reference", {}).values()))
            m["reference_held"] = hold_reference and "against_reference" in m
        del g_sh
        m["ok"] = ok = ok and repeated
        row[label] = m
        if not ok:
            failures.append(f"sharded train {tag} {label}: {m}")
        del whole
        if cuda:
            torch.cuda.empty_cache()
    return row, grads, float(loss)


def moe_split_against_one(torch, model, tokens, mesh) -> dict:
    """The first layer's MoE block on the rms-normed embeddings of
    ``tokens`` (one microbatch), one device (``layers.moe_block``) against
    expert-parallel over ``mesh`` (``layers.moe_block_split``, rows over
    the data shards, the sequence over "model" as the step lays them):
    the routing (expert ids, capacity, pairs kept and dropped per expert)
    and the output, bit for bit, with the largest difference."""
    from repro_torch.models import layers
    from repro_torch.parallel.collectives import piece_bounds
    from repro_torch.parallel.sharding import n_shards

    c = model.cfg
    x = layers.rms_norm(model.embed[tokens.long()].to(c.dtype), model.mlp_norm[0])
    b, s, d = x.shape
    dims = layers.MoEDims(c.moe_experts, c.moe_top_k, model._capacity(b * s), c.expert_axis)
    w = [model.router[0], model.moe_gate[0], model.moe_up[0], model.moe_down[0]]
    one: dict = {}
    want, _ = layers.moe_block(x, *w, dims, stats=one)
    m = mesh.size("model") if "model" in mesh.axis_names else 1
    rows = tuple(piece_bounds(b, n_shards(mesh), i) for i in range(n_shards(mesh)))
    lay = layers.SplitLayout(mesh, m, rows, s, bool(c.seq_shard_activations) and m > 1)
    split = c.moe_experts % m == 0
    xs, per_rank = [], []
    for r in range(lay.R):
        (b0, b1), (t0, t1) = rows[r // m], lay.seq_piece(r % m)
        dev = lay.device(r)
        xs.append(x[b0:b1, t0:t1].to(dev))
        e0, e1 = piece_bounds(c.moe_experts, m, r % m) if split else (0, c.moe_experts)
        per_rank.append([w[0].to(dev)] + [t[e0:e1].to(dev) for t in w[1:]])
    got_stats: dict = {}
    outs, _ = layers.moe_block_split(xs, *[[p[i] for p in per_rank] for i in range(4)],
                                     dims, lay, split, stats=got_stats)
    got = torch.empty_like(want)
    for r, o in enumerate(outs):
        (b0, b1), (t0, t1) = rows[r // m], lay.seq_piece(r % m)
        got[b0:b1, t0:t1] = o.to(got.device)
    same = lambda k: bool(torch.equal(one[k], got_stats[k].to(one[k].device)))  # noqa: E731
    return dict(capacity=one["capacity"], capacity_equal=one["capacity"] == got_stats["capacity"],
                ids_equal=same("top_e"), loads_equal=same("loads"), drops_equal=same("drops"),
                loads=one["loads"].tolist(), drops=one["drops"].tolist(),
                out_bits_equal=bool(torch.equal(int_bits(torch, got), int_bits(torch, want))),
                out_max_abs_diff=float((got.float() - want.float()).abs().max().detach()),
                out_max_abs=float(want.float().abs().max().detach()))


def sharded_train(torch, np, failures: list, record: dict, dev, sizes=SHARDED_TRAIN,
                  llama_cfg=None, tt_cfg=None, gnn_cell: str | None = None,
                  mesh_fn=None, phi_cfg=None, dlrm_cfg=None,
                  gnn_layouts_of: dict | None = None) -> None:
    """The sharded train phase (``SHARDED_TRAIN``'s note).  ``llama_cfg`` /
    ``phi_cfg`` / ``tt_cfg`` / ``dlrm_cfg`` / ``gnn_cell`` / ``mesh_fn`` /
    ``dev`` shrink it for the CPU tests (``mesh_fn(data, model)`` builds a
    mesh; ``make_local_mesh`` on the card); ``gnn_layouts_of``: the GNN
    phase's ``gnn_layouts`` by cell, whose batch PNA steps here."""
    from repro_torch.configs.lm_archs import LLAMA32_1B, PHI35_MOE
    from repro_torch.configs.recsys_archs import DLRM, TWO_TOWER
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import ClickStream, TokenStream
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.gnn import PNAConfig, PNAModel
    from repro_torch.models.params import cast_model, check_ids
    from repro_torch.models.recsys import DLRMModel, TwoTowerModel
    from repro_torch.models.transformer import LMModel
    from repro_torch.optim import adamw
    from repro_torch.train.step import to_device

    cuda = dev.type == "cuda"
    if mesh_fn is None:
        def mesh_fn(data, model):
            return make_local_mesh(model, n_devices=data * model)
    if cuda:
        log(f"sharded train phase on {card_line()}")
    seconds = {}
    gen = lambda: torch.Generator(dev).manual_seed(sizes["seed"])  # noqa: E731

    def meshes(shapes):
        return [(mesh_label(sh), mesh_fn(*sh)) for sh in shapes]

    def lookups_split(row, model, batch, labelled):
        # each model-split mesh's lookups against one device's, bit for bit
        for label, mesh in labelled:
            if model_split(mesh):
                eq = split_lookups_equal(torch, model, batch, mesh)
                row[label]["lookups_bit_for_bit"] = eq
                if not all(eq.values()):
                    failures.append(f"sharded train {model.cfg.name} {label}: split lookups "
                                    f"differ from one device's: {eq}")

    t0 = time.perf_counter()
    cfg = llama_cfg or dataclasses.replace(LLAMA32_1B, n_layers=sizes["llama_layers"])
    model = LMModel(cfg).init_params(gen(), device=dev)
    raw = TokenStream(vocab=cfg.vocab, batch=sizes["llama_batch"], seq=sizes["llama_seq"],
                      seed=sizes["seed"]).next()
    check_ids(raw["tokens"], cfg.vocab, "tokens")
    # the float32 copy first: its one-device gradient is the bf16 run's
    # reference
    copy = cast_model(model, torch.float32, dev)
    row, ref32, loss32 = sharded_against_one(
        torch, np, failures, "llama float32", "lm", copy, adamw(lr=sizes["llama_lr"]),
        to_device(raw, dev), meshes(sizes["llama_f32_meshes"]), dev, sizes["llama_lr"],
        strict=True)
    record["sharded train llama float32"] = row
    log("sharded train llama float32 " + json.dumps(row))
    copy.to_empty(device="meta")
    row, _, _ = sharded_against_one(
        torch, np, failures, "llama", "lm", model, adamw(lr=sizes["llama_lr"]),
        to_device(raw, dev), meshes(sizes["llama_meshes"]), dev,
        sizes["llama_lr"], check_apply=True, reference=ref32, reference_loss=loss32,
        split_loss_rel=sizes["split_loss_rel"],
        reckon=True)
    row.update(config=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab)
    record["sharded train llama"] = row
    log("sharded train llama " + json.dumps(row))
    model.to_empty(device="meta")
    del ref32
    seconds["llama"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg = phi_cfg or dataclasses.replace(PHI35_MOE, n_layers=sizes["phi_layers"])
    model = LMModel(cfg).init_params(gen(), device=dev)
    raw = TokenStream(vocab=cfg.vocab, batch=sizes["phi_batch"], seq=sizes["phi_seq"],
                      seed=sizes["seed"]).next()
    check_ids(raw["tokens"], cfg.vocab, "tokens")
    batch = to_device(raw, dev)
    mb = sizes["phi_microbatches"]
    moe = {}
    for label, mesh in meshes(sizes["phi_meshes"]):
        moe[label] = r = moe_split_against_one(
            torch, model, batch["tokens"][:batch["tokens"].shape[0] // mb, :-1], mesh)
        if not (r["capacity_equal"] and r["ids_equal"] and r["loads_equal"]
                and r["drops_equal"]):
            failures.append(f"sharded train phi {label}: the expert-parallel routing "
                            f"differs from one device's: {r}")
    record["sharded train phi moe block"] = moe
    log("sharded train phi moe block " + json.dumps(moe))
    copy = cast_model(model, torch.float32, dev)
    row, ref32, loss32 = sharded_against_one(
        torch, np, failures, "phi float32", "lm", copy, adamw(lr=sizes["phi_lr"]), batch,
        meshes(sizes["phi_meshes"]), dev, sizes["phi_lr"], strict=True, microbatches=mb)
    record["sharded train phi float32"] = row
    log("sharded train phi float32 " + json.dumps(row))
    copy.to_empty(device="meta")
    row, _, _ = sharded_against_one(
        torch, np, failures, "phi", "lm", model, adamw(lr=sizes["phi_lr"]), batch,
        meshes(sizes["phi_meshes"]), dev, sizes["phi_lr"], reference=ref32, microbatches=mb,
        reference_loss=loss32, split_loss_rel=sizes["split_loss_rel"], reckon=True)
    row.update(config=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
               experts=cfg.moe_experts)
    record["sharded train phi"] = row
    log("sharded train phi " + json.dumps(row))
    model.to_empty(device="meta")
    del ref32
    seconds["phi"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg = tt_cfg or TWO_TOWER
    model = TwoTowerModel(cfg).init_params(gen(), device=dev)
    batch = to_device(ClickStream(cfg, batch=sizes["tt_batch"], seed=sizes["seed"]).next(), dev)
    tt_meshes = meshes(sizes["tt_meshes"])
    # the towers' gradient at the initial weights is mostly the logits'
    # rounding in float32 (the cone: PERF.md §2), so the training bound is
    # held on a float64 copy, whose (B, B) product runs in float64, over the
    # whole batch; its one-device gradient is the float32 and bf16 runs'
    # reference
    copy = cast_model(model, torch.float64, dev)
    row, ref64, _ = sharded_against_one(
        torch, np, failures, "two tower float64", "recsys", copy, adamw(lr=sizes["tt_lr"]),
        batch, meshes(sizes["tt_f64_meshes"]), dev, sizes["tt_lr"], strict=True)
    record["sharded train two tower float64"] = row
    log("sharded train two tower float64 " + json.dumps(row))
    copy.to_empty(device="meta")
    copy = cast_model(model, torch.float32, dev)
    row, _, _ = sharded_against_one(
        torch, np, failures, "two tower float32", "recsys", copy, adamw(lr=sizes["tt_lr"]),
        batch, tt_meshes, dev, sizes["tt_lr"], reference=ref64)
    record["sharded train two tower float32"] = row
    log("sharded train two tower float32 " + json.dumps(row))
    copy.to_empty(device="meta")
    row, _, _ = sharded_against_one(
        torch, np, failures, "two tower", "recsys", model, adamw(lr=sizes["tt_lr"]), batch,
        tt_meshes, dev, sizes["tt_lr"], reference=ref64)
    row.update(config=cfg.name, vocab=cfg.vocab)
    lookups_split(row, model, batch, tt_meshes)
    record["sharded train two tower"] = row
    log("sharded train two tower " + json.dumps(row))
    model.to_empty(device="meta")
    del ref64
    seconds["two_tower"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg = dlrm_cfg or dataclasses.replace(DLRM, vocab=sizes["dlrm_vocab"])
    model = DLRMModel(cfg).init_params(gen(), device=dev)
    batch = to_device(ClickStream(cfg, batch=sizes["dlrm_batch"], seed=sizes["seed"]).next(),
                      dev)
    dl_meshes = meshes(sizes["dlrm_meshes"])
    copy = cast_model(model, torch.float32, dev)
    row, ref32, _ = sharded_against_one(
        torch, np, failures, "dlrm float32", "recsys", copy, adamw(lr=sizes["dlrm_lr"]), batch,
        dl_meshes, dev, sizes["dlrm_lr"], strict=True)
    record["sharded train dlrm float32"] = row
    log("sharded train dlrm float32 " + json.dumps(row))
    copy.to_empty(device="meta")
    row, _, _ = sharded_against_one(
        torch, np, failures, "dlrm", "recsys", model, adamw(lr=sizes["dlrm_lr"]), batch,
        dl_meshes, dev, sizes["dlrm_lr"], reference=ref32)
    row.update(config=cfg.name, vocab=cfg.vocab, tables=cfg.n_sparse)
    lookups_split(row, model, batch, dl_meshes)
    record["sharded train dlrm"] = row
    log("sharded train dlrm " + json.dumps(row))
    model.to_empty(device="meta")
    del ref32, batch
    seconds["dlrm"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cell = gnn_cell or sizes["gnn_cell"]
    bundle = get_arch("pna")
    if gnn_layouts_of and cell in gnn_layouts_of:
        part = gnn_layouts_of[cell][1]
    else:
        _, part, _ = gnn_layouts(np, cell, bundle.cells[cell].inputs(), sizes["seed"])
    batch = to_device(part, dev)
    model = bundle.model_for(cell).init_params(gen(), device=dev)
    pna_meshes = meshes(sizes["gnn_meshes"])
    # the float64 copy first: its one-device gradient is the float32 run's
    # reference, recorded and not held (PERF.md §2)
    copy = cast_model(model, torch.float64, dev)
    row, ref64, _ = sharded_against_one(
        torch, np, failures, "pna float64", "gnn", copy, adamw(lr=sizes["gnn_lr"]), batch,
        pna_meshes, dev, sizes["gnn_lr"], strict=True)
    record["sharded train pna float64"] = row
    log("sharded train pna float64 " + json.dumps(row))
    copy.to_empty(device="meta")
    row, _, _ = sharded_against_one(
        torch, np, failures, "pna", "gnn", model, adamw(lr=sizes["gnn_lr"]), batch,
        pna_meshes, dev, sizes["gnn_lr"], reference=ref64, hold_reference=False)
    row.update(cell=cell, blocks=list(part["edge_src"].shape), nodes=int(part["x"].shape[0]))
    record["sharded train pna"] = row
    log("sharded train pna " + json.dumps(row))
    model.to_empty(device="meta")
    del ref64, batch
    small = PNAModel(PNAConfig(**CONDITIONED_PNA)).init_params(gen(), device=dev)
    graph = conditioned_graph(np, sizes["seed"], sizes["conditioned_nodes"],
                              sizes["conditioned_degree"], sizes["conditioned_blocks"])
    row, _, _ = sharded_against_one(
        torch, np, failures, "pna conditioned", "gnn", small, adamw(lr=sizes["gnn_lr"]),
        to_device(graph, dev), pna_meshes, dev, sizes["gnn_lr"], strict=True)
    record["sharded train pna conditioned"] = row
    log("sharded train pna conditioned " + json.dumps(row))
    seconds["pna"] = time.perf_counter() - t0
    log("sharded train seconds " + json.dumps(seconds))


def dryrun_line(record: dict, cells=DRYRUN_CELLS) -> None:
    """Per-device bytes on the 16 x 16 production mesh (``meta`` devices)
    of the cells that do not fit one card (``launch.dryrun``)."""
    from repro_torch.launch.dryrun import reckon_cell
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    out = {}
    for arch, shape in cells:
        rec = reckon_cell(arch, shape, mesh)
        out[f"{arch}/{shape}"] = dict(per_device_bytes=rec["per_device_bytes"],
                                      device_flops=rec["device_flops"],
                                      model_flops=rec["model_flops"],
                                      collective_bytes=rec["collective_bytes"],
                                      plan=rec["plan"], seconds=rec["seconds"])
    record["dryrun"] = out
    log("dryrun 16x16 " + json.dumps(out))


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
    sharded_s4, sharded_counts, audit_counts, two_tower_run, lm_run = {}, {}, {}, {}, {}
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

    def load_phase():
        data["colors"] = load(np, SISAP_COLORS)
        data["thresholds"] = Thresholds(np, data["colors"][0], SISAP_COLORS.selectivities,
                                        ("l2", "jsd", "triangular"))

    def range_phase(metric):
        paths[metric] = range_path(torch, np, failures, record, dev, *data["colors"],
                                   metric, SISAP_COLORS, data["thresholds"])

    def knn_phase():
        for metric in ("l2", "jsd", "triangular"):
            knns[metric] = knn_path(
                torch, np, failures, record, paths[metric]["index"], *data["colors"], metric,
                plain_batches=None if metric == "l2" else PLAIN_KNN_BATCHES,
                oracle_d=paths[metric]["oracle_d"])
        knn_path(torch, np, failures, record, paths["l2"]["cosine_index"], *data["colors"],
                 "cosine", n_queries=BATCH)

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
        ("corpus", load_phase),
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
            paths["jsd"]["ts"], n_requests=4 * BATCH, mutate=False,
            built=paths["jsd"]["index"]))),
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
        # calibrate_threshold's own values for the check below, in background
        # threads beside phases that time nothing the host paces
        ("thresholds check start", lambda: data["thresholds"].start_check()),
        ("invariants", lambda: audit_counts.update(invariants(
            torch, np, failures, record, data["colors"][1], paths, SISAP_COLORS))),
        # the launchers in subprocesses beside the quickstart's: no timed
        # call runs beside them
        ("launchers start", lambda: data.update(launchers=start_launchers(
            launcher_commands(LAUNCH_CKPT) + LM_EXAMPLE_COMMANDS))),
        ("quickstart", lambda: quickstart(torch, failures, record)),
        ("launchers", lambda: launchers(failures, record, data.pop("launchers"))),
        # joins those threads: nothing of theirs runs beside two tower's timed calls
        ("thresholds check", lambda: log("thresholds check " + json.dumps(
            data["thresholds"].verify(failures)))),
        ("two tower train", lambda: data.update(trained=two_tower_train(
            torch, np, failures, record, dev))),
        ("two tower", lambda: two_tower_run.update(two_tower(
            torch, np, failures, record, dev, data["trained"]))),
        ("lm", lambda: lm_run.update(lm(torch, np, failures, record, dev))),
        ("lm train", lambda: lm_train(torch, np, failures, record, dev)),
        ("gnn train", lambda: gnn_train(torch, np, failures, record, dev,
                                        layouts=data.setdefault("gnn layouts", {}))),
        ("sharded train", lambda: sharded_train(torch, np, failures, record, dev,
                                                gnn_layouts_of=data.get("gnn layouts"))),
        ("dryrun", lambda: dryrun_line(record)),
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
        rec["audit_launches"] = int(audit_counts.get(entry, 0))
        rec["two_tower_launches"] = int(two_tower_run.get("counts", {}).get(entry, 0))
        at_k256 = [r for k, r in two_tower_run.get("kernels", {}).items()
                   if k.split("@")[0] == name]
        if at_k256:  # the same kernel at the two-tower path's shapes (K = 256)
            rec["two_tower"] = at_k256
        rec["lm_launches"] = int(lm_run.get("counts", {}).get(entry, 0))
        at_k2048 = [r for k, r in lm_run.get("kernels", {}).items() if k.split("@")[0] == name]
        if at_k2048:  # the same kernel at the LM search's shapes (K = 2,048)
            rec["lm"] = at_k2048
        if entry in LM_PATH and rec["lm_launches"] <= 0:
            failures.append(f"kernel {name} was not launched by the LM search")
        if entry in TWO_TOWER_PATH and rec["two_tower_launches"] <= 0:
            failures.append(f"kernel {name} was not launched by the two-tower path")
        if entry in SHARDED_PATH and rec["sharded_launches"] <= 0:
            failures.append(f"kernel {name} was not launched by the sharded phases")
        if entry in FOREST_PATH and rec["forest_launches"] <= 0:
            failures.append(f"kernel {name} was not launched by the forest")
        if entry in OFF_PATH:
            rec["on_main_path"] = False
        elif rec["launches"] <= 0:
            failures.append(f"kernel {name} was not launched on the main path")
    log(f"depth: float64 oracles {ORACLE_QUERIES} queries; plain range comparisons all "
        f"queries; plain kNN l2 all queries, JSD / Triangular {PLAIN_KNN_BATCHES} batches")
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
