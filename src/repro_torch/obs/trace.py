# Copy of src/repro/obs/trace.py, kept so the port imports nothing of the JAX
# package; tests/test_torch_copies.py pins it to the original.
"""Chrome trace-event export: one Perfetto-loadable timeline per front.

The serving front already stamps every request's span marks
(admit→batch→dispatch→engine→demux, ``repro_torch.obs.spans``) and times every
dispatched batch and mutation — all on the serving stack's single
monotonic clock (``repro_torch.serve.queue.now``).  This module turns those
timestamps into Chrome trace-event JSON (the ``{"traceEvents": [...]}``
format Perfetto and ``chrome://tracing`` load directly): per-request
stage slices on one track per request, per-dispatch engine phase slices
on the driver track, and mutation slices on the same track so index
maintenance shows up inline with the traffic it stalls.

Timestamps are microseconds on the monotonic clock, so host spans line
up with each other exactly; when the front also runs under
``profile_dir=`` it wraps each engine call in a
``jax.profiler.TraceAnnotation`` named after the dispatch, so the
device-side profile carries the same dispatch names and the two
timelines can be read side by side.

``validate_trace`` is the schema check CI and tests use — no Perfetto
binary needed.
"""

from __future__ import annotations

import json
import math
import threading
from collections import deque
from pathlib import Path

from repro_torch.obs.spans import STAGES, Span

__all__ = [
    "TraceBuffer",
    "complete_event",
    "instant_event",
    "load_trace",
    "metadata_event",
    "span_events",
    "validate_trace",
    "write_trace",
]

_DEFAULT_CAPACITY = 65536
_US = 1e6  # trace-event timestamps are microseconds

# what the request was doing during each consecutive stage interval —
# same naming as Span.durations()
_STAGE_NAMES = {
    ("admit", "batch"): "queue",
    ("batch", "dispatch"): "batch",
    ("dispatch", "engine"): "engine",
    ("engine", "demux"): "demux",
}


def complete_event(name: str, start_s: float, dur_s: float, *, tid: int,
                   pid: int = 1, cat: str = "serving",
                   args: dict | None = None) -> dict:
    """A ``ph="X"`` complete event (a slice with a duration)."""
    ev = {
        "name": str(name),
        "ph": "X",
        "cat": cat,
        "ts": float(start_s) * _US,
        "dur": max(float(dur_s), 0.0) * _US,
        "pid": int(pid),
        "tid": int(tid),
    }
    if args:
        ev["args"] = dict(args)
    return ev


def instant_event(name: str, t_s: float, *, tid: int, pid: int = 1,
                  cat: str = "serving", args: dict | None = None) -> dict:
    """A ``ph="i"`` instant event (a point-in-time marker)."""
    ev = {
        "name": str(name),
        "ph": "i",
        "s": "t",  # thread-scoped marker
        "cat": cat,
        "ts": float(t_s) * _US,
        "pid": int(pid),
        "tid": int(tid),
    }
    if args:
        ev["args"] = dict(args)
    return ev


def metadata_event(kind: str, value: str, *, tid: int = 0,
                   pid: int = 1) -> dict:
    """A ``ph="M"`` metadata event naming a process or thread track."""
    if kind not in ("process_name", "thread_name"):
        raise ValueError(f"unknown metadata kind {kind!r}")
    return {
        "name": kind,
        "ph": "M",
        "pid": int(pid),
        "tid": int(tid),
        "args": {"name": str(value)},
    }


def span_events(span: Span, *, tid: int, pid: int = 1,
                args: dict | None = None) -> list:
    """One complete event per consecutive recorded stage interval of
    ``span`` (queue/batch/engine/demux), plus a thread-name metadata
    event so the request's track is labelled with its trace id."""
    seen = [s for s in STAGES if s in span.marks]
    out = [metadata_event("thread_name", span.trace_id, tid=tid, pid=pid)]
    base = dict(args or {})
    base["trace_id"] = span.trace_id
    for a, b in zip(seen, seen[1:]):
        name = _STAGE_NAMES.get((a, b), f"{a}_to_{b}")
        out.append(complete_event(
            name, span.marks[a], span.marks[b] - span.marks[a],
            tid=tid, pid=pid, cat="request", args=base,
        ))
    return out


class TraceBuffer:
    """Bounded, thread-safe ring of trace events.

    The front appends from its driver thread and from mutating callers;
    ``export_trace`` snapshots under the same lock.  Capacity bounds
    memory on a long-running front the same way the explain ring does —
    oldest events fall off first.
    """

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._events: deque[dict] = deque(maxlen=self.capacity)

    def add(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)

    def extend(self, events) -> None:
        with self._lock:
            self._events.extend(events)

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


def write_trace(path, events, *, extra: dict | None = None) -> Path:
    """Write ``events`` as Chrome trace-event JSON to ``path``.

    Metadata events sort first (Perfetto applies track names on first
    sight); everything else keeps buffer order, which is already
    chronological per track.
    """
    path = Path(path)
    events = sorted(events, key=lambda e: e.get("ph") != "M")
    payload: dict = {"traceEvents": events, "displayTimeUnit": "ms"}
    if extra:
        payload["otherData"] = dict(extra)
    path.write_text(json.dumps(payload) + "\n")
    return path


def load_trace(path) -> dict:
    return json.loads(Path(path).read_text())


def validate_trace(payload) -> list:
    """Schema-check a trace-event payload; returns problem strings
    (empty = valid).  Covers the subset of the trace-event format we
    emit: ``X`` (must have finite ``ts``/``dur`` >= 0), ``i`` and ``M``
    phases, every event carrying ``name``/``pid``/``tid``."""
    problems: list[str] = []
    if not isinstance(payload, dict) or "traceEvents" not in payload:
        return ["payload is not a dict with a 'traceEvents' key"]
    events = payload["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not a dict")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            problems.append(f"{where}: unknown phase {ph!r}")
            continue
        for k in ("name", "pid", "tid"):
            if k not in ev:
                problems.append(f"{where}: missing {k!r}")
        if ph in ("X", "i"):
            ts = ev.get("ts")
            if (not isinstance(ts, (int, float))
                    or not math.isfinite(ts) or ts < 0):
                problems.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if (not isinstance(dur, (int, float))
                    or not math.isfinite(dur) or dur < 0):
                problems.append(f"{where}: bad dur {dur!r}")
        if ph == "M":
            if ev.get("name") not in ("process_name", "thread_name"):
                problems.append(
                    f"{where}: unknown metadata {ev.get('name')!r}"
                )
            elif not isinstance(ev.get("args", {}).get("name"), str):
                problems.append(f"{where}: metadata missing args.name")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"{where}: args is not a dict")
    return problems
