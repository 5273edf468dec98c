"""Spans and the host-read counter inside the port's engines, on only while
a ``torch.profiler`` session records.

``span(name, **args)`` marks one phase of a call.  While a profiler
records it

* opens ``torch.profiler.record_function(name)``, so the phase lands in
  the profiler's own trace, on the clock of the device's kernels and
  copies;
* appends one :class:`SpanRecord` to a bounded in-memory ring when it
  closes: its name, call id, parent span's name, start and end on the
  serving clock (``time.perf_counter``, which ``repro_torch.serve.queue.now``
  also is) and self time;
* with ``device=`` a CUDA device, records a CUDA event pair on that
  device's current stream around the phase.  The pair is resolved to
  device ms only when the ring is read (``spans()``), so no span waits
  for the card.  Where the work runs on no card the span has no device ms.

While no profiler records, ``span`` is one flag check and a shared null
context: it records nothing.

A span opened while none is open on its thread is a root.  It takes a
call id from ``obs.spans.new_trace_id``, the id space of the front's
requests.  The spans opened inside it on the same thread carry that id and
their parent's name.

``to_host(t)`` is the engines' read of a device tensor to the host
(``t.cpu().numpy()``).  While a profiler records it adds one to the
enclosing root span's ``reads``; that count rides on the root's record.
It is not an engine stats key: the stats dict is the same with the
profiler on or off.

The ring keeps the last ``RING_SPANS`` records until ``clear()``; the
serving front clears it when its own ``profile_dir=`` profiler closes,
whose trace file holds the same spans.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from repro_torch.obs.spans import new_trace_id

__all__ = ["RING_SPANS", "Ring", "SpanRecord", "clear", "dropped", "span", "spans",
           "to_host"]

# a 51 s window of 512-query kNN calls (49 spans each, ~660 calls) at
# twice that rate is ~65,000 spans
RING_SPANS = 1 << 18

_NULL = contextlib.nullcontext()
_local = threading.local()
_now = time.perf_counter  # the serving clock


@dataclasses.dataclass(slots=True)
class SpanRecord:
    """One closed span.  ``t0`` / ``t1`` are seconds on the serving clock;
    ``self_s`` is the span's time less its children's on the same thread;
    ``reads`` is the call's ``to_host`` count (root spans only);
    ``device_ms`` is set for a ``device=`` span on a card once ``spans()``
    reads it."""

    name: str
    call: str
    parent: str | None
    t0: float
    t1: float
    self_s: float
    args: dict | None = None
    reads: int | None = None
    device_ms: float | None = None
    events: tuple | None = None


class Ring:
    """The last ``capacity`` span records; those it drops it counts."""

    def __init__(self, capacity: int = RING_SPANS):
        self._buf = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._buf)

    def append(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(rec)

    def read(self) -> list:
        """The records, oldest first, each event pair resolved to device
        ms (waiting for the pair's end where the card has not reached it)."""
        with self._lock:
            recs = list(self._buf)
        for r in recs:
            if r.events is not None:
                start, end = r.events
                end.synchronize()
                r.device_ms, r.events = start.elapsed_time(end), None
        return recs

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0


RING = Ring()


def spans() -> list:
    """The ring's records (``SpanRecord``), oldest first."""
    return RING.read()


def clear() -> None:
    """Empty the ring and zero its drop count."""
    RING.clear()


def dropped() -> int:
    """Records the ring dropped since it was last cleared."""
    return RING.dropped


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """An open span: its frame on the thread's stack while it runs."""

    __slots__ = ("name", "device", "args", "call", "parent", "t0", "child_s",
                 "reads", "fn", "stream", "events")

    def __init__(self, name: str, device, args: dict | None):
        self.name, self.device, self.args = name, device, args or None

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.call = up.call if up is not None else new_trace_id()
        self.parent = up.name if up is not None else None
        self.reads = None if up is not None else 0
        self.child_s = 0.0
        text = (" ".join(f"{k}={v}" for k, v in self.args.items())
                if self.args else None)
        self.fn = torch.profiler.record_function(self.name, text)
        self.fn.__enter__()
        self.events = None
        if self.device is not None and self.device.type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        stack.append(self)
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        t1 = _now()
        if self.events is not None:
            self.events[1].record(self.stream)
        self.fn.__exit__(*exc)
        stack = _stack()
        stack.pop()
        took = t1 - self.t0
        if stack:
            stack[-1].child_s += took
        RING.append(SpanRecord(
            self.name, self.call, self.parent, self.t0, t1, took - self.child_s,
            self.args, self.reads, None, self.events,
        ))
        return False


def span(name: str, device: torch.device | None = None, **args):
    """A context manager that marks ``name`` while a profiler records (the
    module's docstring) and does nothing otherwise.  ``args`` go with the
    record and into the profiler's event."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, device, args)


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` read to the host as a numpy array; while a profiler records,
    one read more on the enclosing call's count."""
    if _autograd_profiler._is_profiler_enabled:
        stack = getattr(_local, "stack", None)
        if stack:
            stack[0].reads += 1
    return t.cpu().numpy()
