# Copy of src/repro/obs/registry.py, kept so the port imports nothing of the JAX
# package; tests/test_torch_copies.py pins it to the original.
"""Metrics registry: counters, gauges and bounded-ring histograms keyed
``name{label=value}``, with a JSON snapshot, a Prometheus-style text
exposition and a one-screen ``render()`` dashboard.

Everything here is host-side and thread-safe (one lock per registry — the
serving front's driver thread and its clients fold concurrently).  The
histogram keeps a bounded ring of recent observations (percentiles are a
*window* statistic, like the front's ``queue_wait_s`` deque) next to
cumulative ``count`` / ``sum`` / per-bucket tallies (*lifetime*
statistics, which is what the Prometheus histogram convention exports) —
so a long-running front reports recent latency percentiles without
unbounded memory while the exposition carries real ``_bucket`` series.
Bucket boundaries come from ``repro_torch.obs.buckets`` (log-spaced default,
per-metric overrides) unless the caller passes an explicit ladder.

Metric names are slash-namespaced repo-side (``serve/span_s``,
``engine/dists``); :func:`prom_name` maps them to the exposition's
``[a-zA-Z0-9_:]`` charset (``serve_span_s``).  Label values are rendered
with the standard escapes, so a snapshot scraped from the text form parses
back losslessly (``repro_torch.obs.export.parse_prometheus``).
"""

from __future__ import annotations

import json
import re
import threading
from bisect import bisect_left
from collections import deque
from itertools import accumulate

from repro_torch.obs.buckets import ladder_for, validate_ladder
from repro_torch.serve.queue import nearest_rank

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "fmt_le",
    "metric_key",
    "prom_name",
]

_DEFAULT_WINDOW = 2048
_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def fmt_le(bound: float) -> str:
    """Render a bucket boundary as its ``le`` label value (``+Inf`` for
    the overflow bucket) — shared with the parser so round-trips are
    exact."""
    return "+Inf" if bound == float("inf") else f"{bound:.9g}"


def metric_key(name: str, labels: dict) -> str:
    """Canonical series key: ``name{k=v,...}`` with labels sorted by key —
    the same (name, labels) pair always lands on the same series."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def prom_name(name: str) -> str:
    """Repo-side metric name -> Prometheus metric name (the exposition
    charset is ``[a-zA-Z0-9_:]``; ``/`` and ``.`` become ``_``)."""
    return _PROM_BAD.sub("_", name)


def _prom_label_str(labels: dict) -> str:
    if not labels:
        return ""
    # text-format 0.0.4 label-value escapes: backslash, double-quote and
    # newline (an unescaped newline would split the sample line in two)
    esc = lambda v: (  # noqa: E731
        str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )
    inner = ",".join(f'{k}="{esc(labels[k])}"' for k in sorted(labels))
    return f"{{{inner}}}"


class Counter:
    """Monotonically increasing tally (float-valued; negative increments
    are rejected — a counter that can go down is a gauge)."""

    kind = "counter"

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = dict(labels)
        self.value = 0.0

    def inc(self, value: float = 1.0) -> None:
        v = float(value)
        if v < 0:
            raise ValueError(
                f"counter {self.name!r} cannot decrease (got {v}); use a "
                f"gauge"
            )
        self.value += v


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = dict(labels)
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Bounded-ring + cumulative-bucket histogram.

    A deque of the last ``window`` observations backs the dashboard
    percentiles (p50/p95/p99/max via the serving stack's nearest-rank
    percentile); cumulative ``count`` / ``sum`` and one per-bucket tally
    per boundary (``le`` semantics: observation counted in the first
    bucket whose bound is >= the value, overflow in the implicit ``+Inf``
    bucket) never forget — they are what the Prometheus exposition
    exports as ``_bucket`` / ``_sum`` / ``_count`` series.
    """

    kind = "histogram"

    def __init__(self, name: str, labels: dict, window: int = _DEFAULT_WINDOW,
                 buckets=None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.name = name
        self.labels = dict(labels)
        self.window = int(window)
        self.ring: deque[float] = deque(maxlen=self.window)
        self.count = 0
        self.sum = 0.0
        self.buckets = (
            ladder_for(name) if buckets is None else validate_ladder(buckets)
        )
        # raw (non-cumulative) per-bucket tallies; index len(buckets) is
        # the +Inf overflow bucket
        self._bucket_raw = [0] * (len(self.buckets) + 1)

    def observe(self, value: float) -> None:
        v = float(value)
        self.ring.append(v)
        self.count += 1
        self.sum += v
        self._bucket_raw[bisect_left(self.buckets, v)] += 1

    def percentile(self, p: float) -> float:
        return nearest_rank(self.ring, p)

    def bucket_counts(self) -> list:
        """Cumulative ``(le, count)`` pairs ending with ``(+Inf, count)``
        — exactly the ``_bucket`` series the exposition emits."""
        bounds = list(self.buckets) + [float("inf")]
        return list(zip(bounds, accumulate(self._bucket_raw)))

    def summary(self) -> dict:
        vals = list(self.ring)
        return {
            "count": self.count,
            "sum": self.sum,
            "window": len(vals),
            "p50": nearest_rank(vals, 0.50),
            "p95": nearest_rank(vals, 0.95),
            "p99": nearest_rank(vals, 0.99),
            "max": nearest_rank(vals, 1.0),
            "buckets": {
                fmt_le(le): c for le, c in self.bucket_counts()
            },
        }


class MetricsRegistry:
    """Get-or-create registry of metric series.

    ``counter`` / ``gauge`` / ``histogram`` return the live series for
    (name, labels) — callers mutate it directly (``inc``/``set``/
    ``observe``); creation and snapshotting are serialized under the
    registry lock, and the mutators touch only their own series (CPython
    float/deque ops — safe under the GIL from multiple threads).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._series: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, cls, name: str, labels: dict, **kw):
        key = metric_key(name, labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = cls(name, labels, **kw)
                self._series[key] = s
            elif not isinstance(s, cls):
                raise ValueError(
                    f"metric {key!r} already registered as {s.kind}"
                )
            return s

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, window: int = _DEFAULT_WINDOW,
                  buckets=None, **labels) -> Histogram:
        h = self._get(Histogram, name, labels, window=window,
                      buckets=buckets)
        if h.window != int(window):
            raise ValueError(
                f"histogram {metric_key(name, labels)!r} already registered "
                f"with window={h.window}, got {window}"
            )
        if buckets is not None and h.buckets != validate_ladder(buckets):
            raise ValueError(
                f"histogram {metric_key(name, labels)!r} already registered "
                f"with buckets={h.buckets}, got {tuple(buckets)}"
            )
        return h

    def series(self) -> list:
        with self._lock:
            return [self._series[k] for k in sorted(self._series)]

    # ------------------------------------------------------------- export

    def snapshot(self) -> dict:
        """JSON-serialisable snapshot: one entry per series, keyed by the
        canonical ``name{label=value}`` series key."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for s in self.series():
            key = metric_key(s.name, s.labels)
            if s.kind == "counter":
                out["counters"][key] = s.value
            elif s.kind == "gauge":
                out["gauges"][key] = s.value
            else:
                out["histograms"][key] = s.summary()
        return out

    def to_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, **kw)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4): counters and gauges
        as plain samples, histograms as cumulative ``_bucket{le="..."}``
        series (``+Inf`` bucket included) plus ``_sum`` / ``_count``."""
        lines: list[str] = []
        typed: set[str] = set()
        for s in self.series():
            pname = prom_name(s.name)
            if s.kind == "histogram":
                if pname not in typed:
                    typed.add(pname)
                    lines.append(f"# TYPE {pname} histogram")
                for le, cum in s.bucket_counts():
                    lbl = _prom_label_str({**s.labels, "le": fmt_le(le)})
                    lines.append(f"{pname}_bucket{lbl} {cum}")
                base = _prom_label_str(s.labels)
                lines.append(f"{pname}_sum{base} {s.sum:.9g}")
                lines.append(f"{pname}_count{base} {s.count}")
            else:
                if pname not in typed:
                    typed.add(pname)
                    lines.append(f"# TYPE {pname} {s.kind}")
                lbl = _prom_label_str(s.labels)
                lines.append(f"{pname}{lbl} {s.value:.9g}")
        return "\n".join(lines) + ("\n" if lines else "")

    # ------------------------------------------------------------- render

    def render(self, width: int = 78) -> str:
        """One-screen text dashboard: series grouped by name prefix (the
        part before the first ``/``), counters/gauges one per line,
        histograms as ``p50/p95/p99/max`` over the ring window."""
        groups: dict[str, list] = {}
        for s in self.series():
            groups.setdefault(s.name.partition("/")[0], []).append(s)
        if not groups:
            return "(no metrics recorded)"
        lines: list[str] = []
        for g in sorted(groups):
            lines.append(f"== {g} ".ljust(width, "="))
            for s in groups[g]:
                key = metric_key(s.name, s.labels)
                if s.kind == "histogram":
                    m = s.summary()
                    lines.append(
                        f"  {key:<44s} n={m['count']:<8d} "
                        f"p50={m['p50']:.4g} p95={m['p95']:.4g} "
                        f"p99={m['p99']:.4g} max={m['max']:.4g}"
                    )
                else:
                    v = s.value
                    val = f"{v:.6g}" if isinstance(v, float) else str(v)
                    lines.append(f"  {key:<44s} {val} ({s.kind})")
        return "\n".join(lines)
