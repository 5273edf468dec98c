"""Quickstart of the PyTorch/CUDA port: supermetric search in a few steps.

    PYTHONPATH=src python examples/torch_quickstart.py             # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu \\
        --corpus 2000 --queries 16                                # on the CPU

Builds the paper's best tree (hpt_fft_log) and the Blocked Supermetric Scan
over a clustered dataset, runs the same range queries with Hyperbolic and
Hilbert exclusion, and prints the paper's figure of merit; then kNN, the
other supermetrics, the device forest, a sharded index, the serving front,
the bf16 exact phase, the port's invariant audit, observability, the
living corpus and the Chrome trace.  Every step asserts its own exactness.
On a CUDA device the engines run the hand-written Hopper kernels; with
``--device cpu`` their plain PyTorch versions.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from repro_torch.core import flat_index, tree
from repro_torch.core.backends import EngineOpts
from repro_torch.core.npdist import pairwise_np
from repro_torch.data import metricsets


def same_hits(metric: str, db, queries, got, want, t: float) -> int:
    """``got`` equals ``want`` as sets, except points whose float64 distance
    lies within 1e-5 * max(1, t) of t (float32 may place those on either
    side); returns how many such points differ."""
    n = 0
    for qv, a, b in zip(queries, got, want):
        for j in set(a) ^ set(b):
            dj = float(pairwise_np(metric, qv, db[j])[0, 0])
            assert abs(dj - t) <= 1e-5 * max(1.0, t), (metric, j, dj, t)
            n += 1
    return n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engines run (default: the CUDA device)")
    ap.add_argument("--corpus", type=int, default=10_000, help="rows generated")
    ap.add_argument("--queries", type=int, default=100, help="queries kept")
    args = ap.parse_args(argv)
    dev = flat_index.resolve_device(None if args.device == "cuda" else args.device)

    # 1. a clustered "real-world-like" metric space (colors surrogate)
    data = metricsets.colors_surrogate(args.corpus, dim=64, seed=0)
    db, queries = metricsets.split_queries(data, frac=0.05, seed=1, max_queries=args.queries)
    t = metricsets.calibrate_threshold("l2", db, selectivity=2e-4)
    print(f"device={dev}  corpus={len(db)}  queries={len(queries)}  threshold t={t:.4f}")

    # 2. the paper's winning structure, both exclusion mechanisms (host walk)
    tr = tree.build_tree("hpt_fft_log", "l2", db, seed=2)
    for mech in ("hyperbolic", "hilbert"):
        results, counter = tree.range_search(tr, queries, t, mech)
        print(f"hpt_fft_log + {mech:10s}: {counter.mean:8.1f} distances/query")

    # 3. exactness against brute force
    truth = tree.exhaustive_search("l2", db, queries, t)
    assert all(sorted(a) == sorted(b) for a, b in zip(results, truth))
    print("exactness: verified against exhaustive search")

    # 4. the blocked engine (one pass a batch: pivot tile, planar bound,
    #    masked exact tile) held to its float64 numpy oracle
    idx = flat_index.build_bss("l2", db, n_pivots=16, n_pairs=24, block=128, device=dev)
    hits, stats = flat_index.bss_query_batched(idx, queries, t)
    oracle_hits, _ = flat_index.bss_query(idx, queries, t)
    n_edge = same_hits("l2", db, queries, hits, oracle_hits, t)
    same_hits("l2", db, queries, hits, truth, t)
    print(f"BSS engine ({stats['backend']}): {stats['dists_per_query']:.0f} distances/query, "
          f"{100 * stats['block_exclusion_rate']:.1f}% of 128-point blocks pruned "
          f"(== numpy oracle; {n_edge} points within 1e-5 of t)")

    # 5. batched exact kNN on the same index (radius-deepening rounds)
    knn_idx, knn_dist, kstats = flat_index.bss_knn_batched(idx, queries, k=5)
    brute = np.sort(pairwise_np("l2", queries, db), axis=1)[:, :5]
    np.testing.assert_allclose(knn_dist, brute, rtol=1e-5, atol=1e-6)  # float32 of float64
    print(f"BSS kNN: top-5 for {len(queries)} queries in {kstats['rounds']} rounds, "
          f"{kstats['dists_per_query']:.0f} distances/query")

    # 6. the other supermetrics (paper §2.2): the colors rows are
    #    probability vectors, valid for JSD / Triangular; cosine rides the
    #    l2 kernels on the unit sphere
    for metric in ("cosine", "jsd", "triangular"):
        t_m = metricsets.calibrate_threshold(metric, db, selectivity=2e-4)
        idx_m = flat_index.build_bss(metric, db, n_pivots=16, n_pairs=24, block=128,
                                     device=dev)
        hits_m, stats_m = flat_index.bss_query_batched(idx_m, queries, t_m)
        oracle_m, _ = flat_index.bss_query(idx_m, queries, t_m)
        same_hits(metric, db, queries, hits_m, oracle_m, t_m)
        print(f"BSS engine [{metric:10s}]: {stats_m['dists_per_query']:.0f} "
              f"distances/query (== numpy oracle)")

    # 7. the device forest: the tree of step 2 encoded as per-level tables
    #    and walked a level at a time for the whole batch; identical result
    #    sets and per-query distance counts
    from repro_torch.forest import encode_tree, forest_range_search

    enc = encode_tree(tr, device=dev)
    f_hits, f_stats = forest_range_search(enc, queries, t, "hilbert")
    assert all(sorted(a) == sorted(b) for a, b in zip(f_hits, results))
    assert (f_stats["per_query_dists"] == counter.per_query).all()
    print(f"device forest (hpt_fft_log): {f_stats['dists_per_query']:8.1f} distances/query "
          f"over {f_stats['n_levels']} levels (results AND per-query counts == host walk)")

    # 8. a sharded index: the corpus blocks partitioned over four shards
    #    (four cards, or one card used four times; four CPU devices with
    #    --device cpu), one pass per shard merged in corpus order; kNN
    #    merges per-shard top-k under one global radius.  Identical hits and
    #    distance counts to the single device.
    from repro_torch.parallel import ShardMesh, local_mesh

    mesh = local_mesh(4) if dev.type == "cuda" else ShardMesh(("cpu",) * 4)
    idx_sh = flat_index.build_bss("l2", db, n_pivots=16, n_pairs=24, block=128, mesh=mesh)
    sh_hits, sh_stats = flat_index.bss_query_batched(idx_sh, queries, t)
    assert sh_hits == hits
    assert (sh_stats["per_query_dists"] == stats["per_query_dists"]).all()
    sh_knn, sh_kd, sh_kstats = flat_index.bss_knn_batched(idx_sh, queries, k=5)
    assert all(set(a.tolist()) == set(b.tolist()) for a, b in zip(sh_knn, knn_idx))
    print(f"sharded BSS over {sh_stats['n_shards']} shards: {sh_stats['dists_per_query']:.0f} "
          f"distances/query (hits, kNN and counts == single device)")

    # 9. async serving: ServingFront assembles batches from single requests
    #    (submit() returns a Future; a driver thread pads each micro-batch to
    #    a bucket ladder), dispatching through the same engines
    from repro_torch.serve.front import ServingFront

    with ServingFront(idx, max_delay_s=0.005) as front:
        futures = [front.submit(qv, "range", t=t * (1 + 0.2 * (i % 2)))
                   for i, qv in enumerate(queries[:20])]
        n_range = len(futures)
        futures += [front.submit(qv, "knn", k=5) for qv in queries[:10]]
        answers = [f.result(timeout=300) for f in futures]
    assert answers[0].hits == hits[0]
    assert set(answers[n_range].indices.tolist()) == set(knn_idx[0].tolist())
    fstats = front.stats()
    print(f"async front: {fstats['completed']} requests in {fstats['batches']} micro-batches "
          f"(mean batch {fstats['batch_size_mean']:.1f}, p95 queue wait "
          f"{1e3 * fstats['queue_wait_s']['p95']:.1f}ms): results == direct engine calls")

    # 10. bf16 exact phase: a bfloat16 mirror of the corpus through the exact
    #     phase, the margin band |d - t| <= eps re-checked in fp32: hits and
    #     per-query counts bit-identical to fp32
    h16, s16 = flat_index.bss_query_batched(idx, queries, t, opts=EngineOpts(precision="bf16"))
    assert h16 == hits
    assert (s16["per_query_dists"] == stats["per_query_dists"]).all()
    print(f"bf16 exact phase: hits + counts == fp32 engine, band eps={s16['band_eps']:.2e}, "
          f"{s16['recheck_points_per_query']:.1f} fp32 re-checked points/query")

    # 11. the invariant checks: the port's audit watches every engine pass
    #     run (no host sync inside a pass, no float64, bf16 only when asked
    #     and never in the pruning); the reference's AST lint scans the
    #     port's source too
    from repro_torch.analysis.audit import run_audit

    problems, cells = run_audit(device=dev)
    for p in problems:
        print(p.format())
    assert not problems
    print(f"invariant audit: {len(cells)} cells of the l2 column clean "
          f"(`python -m repro_torch.analysis --ci` runs every metric; "
          f"`python -m repro.analysis --lint-only` the source lint)")

    # 12. observability: the front reports what it pruned and why;
    #     render() is the one-screen dashboard, explain() replays a request
    with ServingFront(idx, max_delay_s=0.005) as front:
        answers = [front.submit(qv, "range", t=t).result(timeout=300) for qv in queries[:8]]
        print(front.metrics().render())
        trace = front.explain(answers[0].trace_id)
    assert answers[0].hits == hits[0]
    print(f"explain {trace['trace_id']}: {trace['n_dists']} exact distances, excluded "
          f"{trace['excluded']} blocks, span total {1e3 * trace['spans']['total']:.1f}ms "
          f"(engine {1e3 * trace['spans']['engine']:.1f}ms)")

    # 13. living corpus: append against the existing pivots, tombstone,
    #     compact; every mutation is a new generation the front swaps between
    #     batches, and results equal a fresh build over the live rows
    new_rows = metricsets.colors_surrogate(512, dim=64, seed=7)
    with ServingFront(idx, max_delay_s=0.005, metrics=True) as front:
        gen0 = front.index.generation
        ms_a = front.append(new_rows)
        [front.submit(qv, "range", t=t).result(timeout=300) for qv in queries[:8]]
        ms_d = front.delete(np.arange(64))
        ms_c = front.compact()
        final = [front.submit(qv, "range", t=t).result(timeout=300) for qv in queries[:8]]
        gen1 = front.index.generation
    assert gen1 == gen0 + 3
    assert all(r.generation == gen1 for r in final)
    live_ids = np.concatenate([np.arange(64, len(db)), len(db) + np.arange(len(new_rows))])
    fresh = flat_index.build_bss("l2", np.concatenate([db[64:], new_rows]), n_pivots=16,
                                 n_pairs=24, block=128, seed=idx.seed, device=dev)
    fresh_hits, _ = flat_index.bss_query_batched(fresh, queries[:8], t)
    assert [sorted(r.hits) for r in final] == [sorted(live_ids[j] for j in h)
                                               for h in fresh_hits]
    print(f"living corpus: +{ms_a.rows} rows ({ms_a.new_blocks} new blocks, "
          f"{ms_a.table_dists} table distances), -{ms_d.rows} tombstoned, compacted to "
          f"{ms_c.n_blocks} blocks: generation {gen0} -> {gen1}, == fresh rebuild")

    # 14. performance tracing: each request's queue / engine / demux slices,
    #     the driver's dispatches and every mutation on one clock, as Chrome
    #     trace-event JSON (https://ui.perfetto.dev)
    from repro_torch.obs import load_trace, validate_trace

    with ServingFront(idx, max_delay_s=0.005) as front:
        for qv in queries[:8]:
            front.submit(qv, "range", t=t).result(timeout=300)
        front.append(metricsets.colors_surrogate(256, dim=64, seed=8))
        front.submit(queries[0], "knn", k=5).result(timeout=300)
        trace_path = front.export_trace(Path("TRACE_torch_quickstart.json"))
    payload = load_trace(trace_path)
    assert validate_trace(payload) == []
    kinds = {e["name"] for e in payload["traceEvents"]}
    assert {"queue", "engine", "demux", "dispatch/engine", "mutation/append"} <= kinds
    print(f"trace: {len(payload['traceEvents'])} events -> {trace_path}")


if __name__ == "__main__":
    main()
