"""The traced run: ``torch.profiler`` over the whole window, spans around
the calls into each layer, and what the trace says.

Spans come from the benchmark's own files: the harness opens
``serve.search`` around each call, and ``layer_spans`` wraps the engine's
entry points (where the program has them) for the traced window only.
``read`` turns the trace into the device's busy seconds (the union of its
operations' intervals: kernels, copies and sets; the device-side copies of
the spans are left out), the window's seconds (first call's start to last
call's end), the device operations that took most time, and the longest
idle gaps of the device grouped by what the host was doing (the innermost
host event, span or operator, running at the gap's midpoint).
"""

from __future__ import annotations

import contextlib
import functools
import heapq
import importlib
import re

CALL_SPAN = "serve.search"
# (module, attribute, span): the engine's layers as the program names them
LAYER_SPANS = (
    ("repro_torch.core.flat_index", "bss_knn_batched", "flat_index.knn"),
    ("repro_torch.core.flat_index", "bss_query_batched", "flat_index.range"),
    ("repro_torch.core.flat_index", "_fused_lower_bounds", "flat_index.bound"),
    ("repro_torch.core.flat_index", "_knn_round", "flat_index.knn_round"),
    ("repro_torch.core.flat_index", "_top_k_smallest", "flat_index.top_k"),
)
TOP = 10


@contextlib.contextmanager
def layer_spans():
    """Wrap each of ``LAYER_SPANS`` that the program has in a
    ``record_function`` of its span's name; unwrap on exit."""
    import torch

    saved = []
    for mod_name, attr, span in LAYER_SPANS:
        try:
            mod = importlib.import_module(mod_name)
        except ImportError:
            continue
        fn = getattr(mod, attr, None)
        if fn is None:
            continue

        def wrapped(*a, _fn=fn, _span=span, **kw):
            with torch.profiler.record_function(_span):
                return _fn(*a, **kw)

        functools.update_wrapper(wrapped, fn)
        setattr(mod, attr, wrapped)
        saved.append((mod, attr, fn))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def kernel_name(name: str) -> str:
    """A device operation's name without its return type, namespaces and
    arguments."""
    name = re.sub(r"^void |\(anonymous namespace\)::|at::native::", "", name)
    name = name.split("(")[0]
    return name if len(name) <= 60 else name.split("<")[0][:60]


def union_seconds(intervals: list) -> float:
    """Length of the union of ``(start, end)`` intervals, in their unit."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals: list, lo: float, hi: float) -> list:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, cursor = [], lo
    for s, e in sorted(intervals):
        if s > cursor:
            out.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]


def innermost(host: list, points: list) -> list:
    """For each of the ascending ``points``, the name of the shortest host
    event ``(start, end, name)`` that covers it ("client loop" where none
    does): one sweep, the open events in a heap by length."""
    events = sorted(host)
    heap, out, i = [], [], 0
    for at in points:
        while i < len(events) and events[i][0] <= at:
            s, e, name = events[i]
            heapq.heappush(heap, (e - s, e, name))
            i += 1
        while heap and heap[0][1] < at:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "client loop")
    return out


def summarise(device: list, host: list) -> dict:
    """``device``: ``(start, end, name)`` of the device's operations;
    ``host``: the same of host events; times in microseconds.  The window
    runs from the first to the last ``CALL_SPAN``."""
    calls = [(s, e) for s, e, n in host if n == CALL_SPAN]
    if not calls:
        return {}
    lo, hi = min(s for s, _ in calls), max(e for _, e in calls)
    inside = [(max(s, lo), min(e, hi), n) for s, e, n in device if e > lo and s < hi]
    by_op: dict = {}
    for s, e, n in inside:
        k = kernel_name(n)
        by_op[k] = by_op.get(k, 0.0) + (e - s) / 1e6
    idle: dict = {}
    holes = gaps([(s, e) for s, e, _ in inside], lo, hi)
    for (a, b), k in zip(holes, innermost(host, [(a + b) / 2 for a, b in holes])):
        idle[k] = idle.get(k, 0.0) + (b - a) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "busy_s": union_seconds([(s, e) for s, e, _ in inside]) / 1e6,
        "window_s": (hi - lo) / 1e6,
        "device_ops": top(by_op),
        "idle_gaps": top(idle),
        "spans_s": spans_seconds(host),
    }


def spans_seconds(host: list) -> dict:
    """Seconds in each of the benchmark's spans, summed over the window."""
    names = {CALL_SPAN} | {span for _, _, span in LAYER_SPANS}
    out: dict = {}
    for s, e, n in host:
        if n in names:
            out[n] = out.get(n, 0.0) + (e - s) / 1e6
    return out


def read(prof) -> dict:
    """``summarise`` over a finished ``torch.profiler.profile``, from its raw
    events (the profiler's own event tree takes minutes to build for a
    window of a million events)."""
    from torch.autograd import DeviceType

    spans = {CALL_SPAN} | {span for _, _, span in LAYER_SPANS}
    results = prof.profiler.kineto_results
    origin = results.trace_start_ns()  # microseconds from here keep their digits
    device, host = [], []
    for e in results.events():
        start = (e.start_ns() - origin) / 1e3
        row = (start, start + e.duration_ns() / 1e3, e.name())
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            # the device's copy of a host span covers the span, not work
            if not getattr(e, "is_user_annotation", lambda: False)() and row[2] not in spans:
                device.append(row)
        elif kind == DeviceType.CPU:
            host.append(row)
    return summarise(device, host)
