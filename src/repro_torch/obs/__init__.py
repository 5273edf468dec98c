"""Runtime observability of the port: registry, schema, spans, folding,
export, trace.

Engine counters are plain outputs
---------------------------------
Every device-side counter of the port (per-mechanism exclusion
attribution, tile counts, bf16 re-check volume) is a tensor the engine
computes beside its results from masks it already holds.  The engine makes
them host arrays once, at the end of the call, in the same copy that
brings the results back, and returns them in its ``stats`` dict; the host
folds that dict into the :class:`~repro_torch.obs.registry.MetricsRegistry`
(``repro_torch.obs.fold``).  Nothing is called back from the device and
no kernel is launched for observability, so collecting metrics adds no
synchronisation point and cannot change a result (``tests/test_torch_obs.py``
holds a metrics-on and a metrics-off front to the same bits).

Layout
------
- ``registry`` — counters / gauges / bounded-ring histograms with real
  cumulative buckets, JSON snapshot, Prometheus text exposition,
  ``render()`` dashboard
- ``buckets`` — the log-spaced default bucket ladder + per-metric
  overrides used by every histogram
- ``schema`` — the shared engine-stats schema + validator, and
  ``METRIC_NAMES``, the one registry of runtime metric names (lint R6)
- ``spans`` — per-request trace ids and monotonic stage timestamps
- ``trace`` — Chrome trace-event JSON (Perfetto) export of spans, engine
  phases, and mutation events, all on the serving clock
- ``fold`` — stats -> registry after each engine call; kernel-library
  build counters
- ``export`` — snapshot files + exposition round-trip checks

``registry``, ``buckets``, ``schema``, ``spans``, ``trace`` and ``export``
are copies of the JAX package's modules (``tests/test_torch_copies.py``).
"""

from repro_torch.obs.buckets import DEFAULT_LADDER, LADDERS, ladder_for, log_ladder
from repro_torch.obs.export import parse_prometheus, validate_exposition, write_snapshot
from repro_torch.obs.fold import fold_engine_stats, poll_compile, shard_imbalance
from repro_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    fmt_le,
    metric_key,
    prom_name,
)
from repro_torch.obs.schema import (
    MECHANISMS,
    METRIC_NAMES,
    SCHEMA_VERSION,
    check_stats,
    normalise_stats,
    validate_stats,
)
from repro_torch.obs.spans import STAGES, Span, new_trace_id
from repro_torch.obs.trace import (
    TraceBuffer,
    complete_event,
    instant_event,
    load_trace,
    metadata_event,
    span_events,
    validate_trace,
    write_trace,
)

__all__ = [
    "Counter",
    "DEFAULT_LADDER",
    "Gauge",
    "Histogram",
    "LADDERS",
    "MetricsRegistry",
    "MECHANISMS",
    "METRIC_NAMES",
    "SCHEMA_VERSION",
    "STAGES",
    "Span",
    "TraceBuffer",
    "check_stats",
    "complete_event",
    "fmt_le",
    "fold_engine_stats",
    "instant_event",
    "ladder_for",
    "load_trace",
    "log_ladder",
    "metadata_event",
    "metric_key",
    "new_trace_id",
    "normalise_stats",
    "parse_prometheus",
    "poll_compile",
    "prom_name",
    "shard_imbalance",
    "span_events",
    "validate_exposition",
    "validate_stats",
    "validate_trace",
    "write_snapshot",
    "write_trace",
]
