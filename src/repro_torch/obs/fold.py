"""Fold engine stats into a :class:`~repro_torch.obs.registry.MetricsRegistry`
— the port of ``repro.obs.fold``.

The engines return their counters as host arrays in the stats dict, made
once at the end of an engine call (``repro_torch.obs.__doc__``), and the
serving layer calls :func:`fold_engine_stats` once per dispatched batch.
Folding therefore adds no device work and no extra host syncs.
``fold_engine_stats``, ``fold_mutation`` and ``shard_imbalance`` are the
reference's numpy code.

:func:`poll_compile` is the runtime face of "no new build mid-stream": the
port has no jit, and its counterpart of a new lowering is a kernel library
built or loaded while serving.  Growth of a watched build counter becomes
a ``compile/recompiles`` counter.
"""

from __future__ import annotations

import numpy as np

from repro_torch.obs.registry import MetricsRegistry

__all__ = ["fold_engine_stats", "fold_mutation", "poll_compile",
           "shard_imbalance"]


def shard_imbalance(per_shard) -> float:
    """Max/mean ratio of a per-shard work vector: 1.0 is perfectly
    balanced, S is everything-on-one-shard (for S shards).  Defined as
    1.0 on an all-zero vector (no work is trivially balanced)."""
    vals = [int(v) for v in np.asarray(per_shard).reshape(-1).tolist()]
    if not vals or sum(vals) == 0:
        return 1.0
    return max(vals) * len(vals) / sum(vals)


def fold_engine_stats(reg: MetricsRegistry, stats: dict) -> None:
    """Fold one engine-call stats dict (shared schema, see
    ``repro_torch.obs.schema``) into ``reg``.  Tolerates pre-schema dicts —
    missing keys simply contribute nothing."""
    engine = str(stats.get("engine", "unknown"))
    kind = str(stats.get("kind", "unknown"))
    lbl = dict(engine=engine, kind=kind)

    pq = np.asarray(stats.get("per_query_dists", ()), dtype=np.int64)
    nq = int(stats.get("n_queries", pq.shape[0] if pq.ndim == 1 else 0))
    reg.counter("engine/queries", **lbl).inc(nq)
    if pq.ndim == 1 and pq.size:
        reg.counter("engine/dists", **lbl).inc(int(pq.sum()))
        h = reg.histogram("engine/dists_per_query", **lbl)
        for v in pq.tolist():
            h.observe(v)

    for mech, counts in dict(stats.get("excluded", {})).items():
        c = np.asarray(counts, dtype=np.int64)
        if c.size:
            reg.counter(
                "engine/excluded", mechanism=mech, **lbl
            ).inc(int(c.sum()))

    if "tiles_computed" in stats:
        reg.counter("engine/tiles_computed", **lbl).inc(
            int(stats["tiles_computed"])
        )
    if "tile_exclusion_rate" in stats:
        reg.gauge("engine/tile_exclusion_rate", **lbl).set(
            float(stats["tile_exclusion_rate"])
        )
    if "block_exclusion_rate" in stats:
        reg.gauge("engine/block_exclusion_rate", **lbl).set(
            float(stats["block_exclusion_rate"])
        )

    fo = stats.get("frontier_occupancy")
    if fo is not None:
        for lv, occ in enumerate(np.asarray(fo, dtype=np.int64).tolist()):
            reg.counter(
                "engine/frontier_nodes", level=lv, **lbl
            ).inc(int(occ))

    if stats.get("precision") == "bf16":
        prc = np.asarray(
            stats.get("per_query_recheck", ()), dtype=np.int64
        )
        if prc.size:
            reg.counter("engine/recheck_points", **lbl).inc(int(prc.sum()))
        if "recheck_tiles" in stats:
            reg.counter("engine/recheck_tiles", **lbl).inc(
                int(stats["recheck_tiles"])
            )

    if kind == "knn" and "rounds" in stats:
        reg.histogram("engine/knn_rounds", **lbl).observe(
            int(stats["rounds"])
        )

    if "shard_dists" in stats:
        # the sharded engine's per-shard split of the exact-phase work
        # (functional jit outputs, one slot per mesh device): per-shard
        # traffic counters plus a max/mean imbalance gauge — the number a
        # rebalancing policy would watch
        sd = np.asarray(stats["shard_dists"], dtype=np.int64)
        sb = np.asarray(
            stats.get("shard_blocks", np.zeros_like(sd)), dtype=np.int64
        )
        for i, (d, b) in enumerate(zip(sd.tolist(), sb.tolist())):
            reg.counter("shard/dists", shard=i, **lbl).inc(int(d))
            reg.counter("shard/blocks", shard=i, **lbl).inc(int(b))
        reg.gauge("shard/imbalance", **lbl).set(shard_imbalance(sd))


def fold_mutation(reg: MetricsRegistry, mstats,
                  seconds: float | None = None) -> None:
    """Fold one living-corpus mutation (a
    :class:`~repro_torch.index.maintain.MutationStats`) into ``reg``.

    Gauges track the index's CURRENT shape (``index/generation``,
    ``index/tombstone_frac``, ``index/n_blocks`` — last write wins, so the
    newest mutation's view is the live one); counters accumulate mutation
    traffic per op; ``seconds`` (the host wall time of the mutation,
    including any device-mirror splice) lands in ``index/mutation_s{op=}``.
    """
    lbl = dict(op=str(mstats.op))
    reg.counter("index/mutations", **lbl).inc()
    reg.counter("index/mutated_rows", **lbl).inc(int(mstats.rows))
    reg.counter("index/table_dists", **lbl).inc(int(mstats.table_dists))
    reg.gauge("index/generation").set(int(mstats.generation))
    reg.gauge("index/tombstone_frac").set(float(mstats.tombstone_frac))
    reg.gauge("index/n_blocks").set(int(mstats.n_blocks))
    if mstats.op == "append":
        reg.counter("index/new_blocks").inc(int(mstats.new_blocks))
        if mstats.sharded_in_place:
            reg.counter("index/sharded_in_place").inc()
    if mstats.op == "compact" and mstats.refreshed_pivots:
        reg.counter("index/pivot_refreshes").inc()
    if seconds is not None:
        reg.histogram("index/mutation_s", **lbl).observe(float(seconds))


def poll_compile(reg: MetricsRegistry, watched: dict,
                 last: dict | None = None) -> dict:
    """Sample the build counters in ``watched`` (name -> zero-argument
    callable returning an int).

    Sets ``compile/cache_size{fn=name}`` gauges and increments
    ``compile/recompiles{fn=name}`` by any growth since the previous
    sample (carried in ``last``, which is returned updated for the next
    call).  The serving front watches one counter per CUDA source: the
    times ``repro_torch.kernels._build`` has built or loaded its library
    in this process (``_build.load_count``).
    """
    last = {} if last is None else last
    for name, count in watched.items():
        size = int(count())
        reg.gauge("compile/cache_size", fn=name).set(size)
        prev = last.get(name)
        if prev is not None and size > prev:
            reg.counter("compile/recompiles", fn=name).inc(size - prev)
        last[name] = size
    return last
