# Copy of src/repro/obs/schema.py, kept so the port imports nothing of the JAX
# package; tests/test_torch_copies.py pins it to the original.
"""One documented schema for every engine's ``stats`` dict.

Before this module each engine grew its own ad-hoc key set (the BSS scan
reported ``block_exclusion_rate``, the forest ``n_levels``, the sharded
engine ``n_shards``).  The shared contract is now:

======================  =====================================================
key                     meaning
======================  =====================================================
``schema``              int — schema version (``SCHEMA_VERSION``)
``engine``              ``bss`` | ``sharded`` | ``forest`` | ``monotone``
``kind``                ``range`` | ``knn``
``backend``             resolved compute backend string (``jnp``, ``pallas``,
                        ``pallas-interpret``, ...)
``precision``           ``fp32`` | ``bf16``
``n_queries``           int — number of queries in the batch
``per_query_dists``     int64 ndarray ``(n_queries,)`` — exact distance
                        evaluations per query (the paper's figure of merit)
``dists_per_query``     float — mean of ``per_query_dists``
``excluded``            dict mechanism -> int64 ndarray ``(n_queries,)`` —
                        per-query exclusion attribution.  Mechanisms are a
                        subset of ``MECHANISMS``; units are engine-native
                        (128-point blocks for bss/sharded, tree nodes for
                        the walkers)
======================  =====================================================

Engine-specific keys (``n_blocks``, ``tiles_computed``, ``n_levels``,
``frontier_occupancy``, ``rounds``, the bf16 band keys, the sharded
engine's ``shard_dists`` / ``shard_blocks`` per-shard work vectors, ...)
ride along unchanged — the schema fixes the shared core, it does not
forbid extras.

This module is also the one home of the RUNTIME METRIC NAMESPACE:
:data:`METRIC_NAMES` lists every metric name the codebase may register
on a :class:`~repro.obs.registry.MetricsRegistry`.  Lint rule R6
(``repro.analysis``) fails CI on any ``counter(...)`` / ``gauge(...)`` /
``histogram(...)`` call in ``src/`` whose name literal is not listed
here — dashboards and the regression sentinel key on these names, so an
unregistered name is a silent observability hole.

Host-side and numpy-only: validation runs at the jit boundary on
materialised stats, never inside a traced function.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "SCHEMA_VERSION",
    "ENGINES",
    "KINDS",
    "PRECISIONS",
    "MECHANISMS",
    "METRIC_NAMES",
    "normalise_stats",
    "validate_stats",
    "check_stats",
]

SCHEMA_VERSION = 1

ENGINES = ("bss", "sharded", "forest", "monotone")
KINDS = ("range", "knn")
PRECISIONS = ("fp32", "bf16")
# exclusion mechanisms: the two hyperplane bounds (paper §3), the
# cover-radius ball test, and the centre-witness test
MECHANISMS = ("hilbert", "hyperbolic", "cover", "centre")

# every metric name the codebase registers at runtime (lint rule R6: a
# name used in src/ but absent here fails CI).  Kept as a plain set
# literal so the import-free AST lint can read it with ast.literal_eval.
METRIC_NAMES = {
    # engine-call folding (repro.obs.fold.fold_engine_stats)
    "engine/queries",
    "engine/dists",
    "engine/dists_per_query",
    "engine/excluded",
    "engine/tiles_computed",
    "engine/tile_exclusion_rate",
    "engine/block_exclusion_rate",
    "engine/frontier_nodes",
    "engine/recheck_points",
    "engine/recheck_tiles",
    "engine/knn_rounds",
    # sharded-engine work split (fold_engine_stats on sharded stats)
    "shard/dists",
    "shard/blocks",
    "shard/imbalance",
    # living-corpus mutations (fold_mutation)
    "index/mutations",
    "index/mutated_rows",
    "index/table_dists",
    "index/generation",
    "index/tombstone_frac",
    "index/n_blocks",
    "index/new_blocks",
    "index/sharded_in_place",
    "index/pivot_refreshes",
    "index/mutation_s",
    # compile-cache polling (poll_compile) + the bucket-ladder contract
    "compile/cache_size",
    "compile/recompiles",
    "compile/ladder_buckets",
    # serving front / retrieval server
    "serve/cache_hits",
    "serve/batch_size",
    "serve/engine_s",
    "serve/padded_rows",
    "serve/span_s",
    "serve/call_s",
}

_CORE_KEYS = (
    "schema", "engine", "kind", "backend", "precision",
    "n_queries", "per_query_dists", "dists_per_query", "excluded",
)


def normalise_stats(stats, *, engine, kind, backend, n_queries,
                    excluded=None):
    """Stamp the shared-schema keys onto an engine's ``stats`` dict.

    Mutates and returns ``stats``.  ``excluded`` maps mechanism name to a
    per-query count array; omitted (or ``None``) means the engine recorded
    no attribution — an empty dict, which still validates.  Existing
    engine-specific keys are preserved.
    """
    stats["schema"] = SCHEMA_VERSION
    stats["engine"] = engine
    stats["kind"] = kind
    stats["backend"] = backend
    stats["n_queries"] = int(n_queries)
    stats.setdefault("precision", "fp32")
    excl = {} if excluded is None else dict(excluded)
    stats["excluded"] = {
        m: np.asarray(v, dtype=np.int64) for m, v in excl.items()
    }
    return stats


def _is_count_array(v, n):
    a = np.asarray(v)
    return (
        a.shape == (n,)
        and np.issubdtype(a.dtype, np.integer)
        and (n == 0 or int(a.min()) >= 0)
    )


def validate_stats(stats) -> list:
    """Validate a stats dict against the shared schema.

    Returns a list of human-readable problem strings — empty means valid.
    Never raises on malformed input (use :func:`check_stats` to raise).
    """
    problems: list[str] = []
    if not isinstance(stats, dict):
        return [f"stats is {type(stats).__name__}, expected dict"]
    for k in _CORE_KEYS:
        if k not in stats:
            problems.append(f"missing core key {k!r}")
    if problems:
        return problems

    if stats["schema"] != SCHEMA_VERSION:
        problems.append(
            f"schema={stats['schema']!r}, expected {SCHEMA_VERSION}"
        )
    if stats["engine"] not in ENGINES:
        problems.append(f"engine={stats['engine']!r} not in {ENGINES}")
    if stats["kind"] not in KINDS:
        problems.append(f"kind={stats['kind']!r} not in {KINDS}")
    if stats["precision"] not in PRECISIONS:
        problems.append(
            f"precision={stats['precision']!r} not in {PRECISIONS}"
        )
    if not isinstance(stats["backend"], str) or not stats["backend"]:
        problems.append(f"backend={stats['backend']!r} is not a string")

    n = stats["n_queries"]
    if not isinstance(n, int) or n < 0:
        problems.append(f"n_queries={n!r} is not a non-negative int")
        return problems

    if not _is_count_array(stats["per_query_dists"], n):
        problems.append(
            f"per_query_dists is not a non-negative int array of shape "
            f"({n},)"
        )
    elif n:  # the mean is convention-defined on an empty batch
        mean = float(np.asarray(stats["per_query_dists"]).mean())
        if abs(float(stats["dists_per_query"]) - mean) > 1e-6 * max(mean, 1.0):
            problems.append(
                f"dists_per_query={stats['dists_per_query']} != "
                f"mean(per_query_dists)={mean}"
            )

    excl = stats["excluded"]
    if not isinstance(excl, dict):
        problems.append(f"excluded is {type(excl).__name__}, expected dict")
    else:
        for m, v in excl.items():
            if m not in MECHANISMS:
                problems.append(
                    f"excluded mechanism {m!r} not in {MECHANISMS}"
                )
            elif not _is_count_array(v, n):
                problems.append(
                    f"excluded[{m!r}] is not a non-negative int array of "
                    f"shape ({n},)"
                )

    if stats["precision"] == "bf16":
        for k in ("band_eps", "recheck_points_per_query"):
            if k not in stats:
                problems.append(f"precision=bf16 but missing {k!r}")
    if stats["kind"] == "knn" and "rounds" not in stats:
        problems.append("kind=knn but missing 'rounds'")
    return problems


def check_stats(stats) -> dict:
    """Raise ``ValueError`` listing every problem if ``stats`` does not
    conform; return ``stats`` unchanged if it does."""
    problems = validate_stats(stats)
    if problems:
        raise ValueError(
            "stats schema violation:\n  " + "\n  ".join(problems)
        )
    return stats
