# Copy of src/repro/obs/spans.py, kept so the port imports nothing of the JAX
# package; tests/test_torch_copies.py pins it to the original.
"""Per-request serving spans.

A request through the ServingFront passes admit -> queue -> batch ->
dispatch -> engine -> demux; a :class:`Span` carries one monotonic
timestamp per stage (the serving stack's clock, ``repro_torch.serve.queue.now``
— R1 forbids ``time.time`` anywhere in src).  ``durations()`` turns the
marks into per-stage intervals, which the front records into
``serve/span_s{stage=...}`` histograms and returns on each
``ServeResult`` for the per-request "explain" trace.

Trace ids are process-unique monotonically increasing ints (cheap,
lock-free via ``itertools.count``) rendered as ``t000042`` strings so
they sort lexicographically in logs.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from repro_torch.serve.queue import now

__all__ = ["STAGES", "Span", "new_trace_id"]

# stage marks in causal order: `admit` is stamped on submit(); the rest
# are stamped by the driver thread as the batch moves through dispatch
STAGES = ("admit", "batch", "dispatch", "engine", "demux")

_ids = itertools.count(1)


def new_trace_id() -> str:
    return f"t{next(_ids):06d}"


@dataclass
class Span:
    """Monotonic stage timestamps for one request."""

    trace_id: str = field(default_factory=new_trace_id)
    marks: dict = field(default_factory=dict)

    def mark(self, stage: str, t: float | None = None) -> float:
        """Stamp ``stage`` at monotonic time ``t`` (default: now)."""
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage!r}, expected {STAGES}")
        t = now() if t is None else float(t)
        self.marks[stage] = t
        return t

    def durations(self) -> dict:
        """Intervals between consecutive *recorded* marks, in seconds.

        Keys are named for what the request was doing during the
        interval: ``queue`` (admit->batch), ``batch`` (batch->dispatch,
        padding/assembly), ``engine`` (dispatch->engine, the jitted
        call), ``demux`` (engine->demux, per-request slicing), plus
        ``total`` (first mark -> last mark).  Stages never marked are
        simply absent.
        """
        names = {
            ("admit", "batch"): "queue",
            ("batch", "dispatch"): "batch",
            ("dispatch", "engine"): "engine",
            ("engine", "demux"): "demux",
        }
        seen = [s for s in STAGES if s in self.marks]
        out: dict = {}
        for a, b in zip(seen, seen[1:]):
            out[names.get((a, b), f"{a}_to_{b}")] = (
                self.marks[b] - self.marks[a]
            )
        if len(seen) >= 2:
            out["total"] = self.marks[seen[-1]] - self.marks[seen[0]]
        return out
