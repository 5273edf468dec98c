# Copy of src/repro/serve/queue.py, kept so the port imports nothing of the JAX
# package; tests/test_torch_copies.py pins it to the original.
"""Request plumbing for the async serving front: the bounded admission
queue, the request record, and the shared monotonic clock.

The front's unit of work is a REQUEST STREAM — single queries arriving one
at a time — so this module provides what a pre-assembled-batch engine never
needed: a thread-safe bounded queue whose consumer side pops *groups* of
engine-compatible requests (same dispatch signature) and whose producer
side enforces admission (block until space, or shed immediately).

Everything here is host-side by design: the driver thread, the deadline
arithmetic and the queue never touch jax.  ``now`` is the one clock the
whole serving stack (and, via ``benchmarks.paper_common``, the benchmark
suite) times with — ``time.perf_counter``, monotonic and high-resolution,
instead of wall-clock ``time.time`` which steps under NTP adjustments.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from concurrent.futures import Future

import numpy as np

__all__ = ["now", "nearest_rank", "Request", "ShedError",
           "BoundedRequestQueue"]

# the shared monotonic clock: every queue-wait, deadline, and benchmark
# timing in the repo reads this, never time.time()
now = time.perf_counter


def nearest_rank(xs, p: float) -> float:
    """Nearest-rank percentile (p in [0, 1]) of an UNSORTED sequence —
    ``xs[ceil(p*N) - 1]`` of the sorted values, the definition that makes
    p=0.99 of 10 samples the maximum rather than an interior sample — the
    one latency statistic the front's telemetry and the serving benchmarks
    both report; 0.0 on an empty sequence."""
    xs = sorted(xs)
    if not xs:
        return 0.0
    return float(xs[min(len(xs), max(1, math.ceil(p * len(xs)))) - 1])


class ShedError(RuntimeError):
    """Admission control rejected the request (queue full under the shed
    policy, or the front is closed)."""


@dataclasses.dataclass
class Request:
    """One submitted query, from admission to future resolution.

    ``group`` is the dispatch-compatibility key: requests sharing it can
    ride the same engine call (same kind; kNN also same (k, r0, max_rounds)
    since those shape the radius schedule; forest range also same t since
    the walker takes a scalar threshold).  ``t`` is carried per-request for
    the BSS range path, which accepts per-query radii — mixed thresholds
    batch together there."""

    query: np.ndarray          # (dim,) float32, finite (validated at submit)
    kind: str                  # "range" | "knn"
    group: tuple               # dispatch-compatibility key
    future: Future
    t_submit: float            # now() at admission
    t: float | None = None     # range radius (per-request)
    k: int | None = None       # kNN width
    cache_key: bytes | None = None
    precision: str = "fp32"    # engine exact-phase precision ("fp32"|"bf16")
    # observability: process-unique trace id + the request's Span (stage
    # timestamps on THIS clock; see repro_torch.obs.spans — kept untyped here so
    # the queue layer stays jax- and obs-free)
    trace_id: str = ""
    span: object | None = None


class BoundedRequestQueue:
    """Thread-safe bounded FIFO with group-aware batch pops.

    Producers ``put`` under an admission policy; the single consumer (the
    front's driver thread) calls ``next_group``, which takes the HEAD
    request's group key, waits until either that group can fill ``max_n``
    requests or the head's deadline passes, then pops every queued request
    of that group (FIFO order preserved within the group; other groups
    keep their positions — the head's age, not a straggler group's, drives
    the deadline, so no group can starve another)."""

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._q: list[Request] = []
        self._cond = threading.Condition()
        self._closed = False

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    @property
    def closed(self) -> bool:
        return self._closed

    def put(self, req: Request, *, policy: str = "block",
            timeout: float | None = None) -> None:
        """Admit a request.  ``policy="block"`` waits for space (up to
        ``timeout`` seconds, None = forever); ``"shed"`` raises
        :class:`ShedError` immediately when full.  Either policy raises
        ``ShedError`` once the queue is closed."""
        if policy not in ("block", "shed"):
            raise ValueError(f"policy must be block|shed, got {policy!r}")
        deadline = None if timeout is None else now() + timeout
        with self._cond:
            while True:
                if self._closed:
                    raise ShedError("serving front is closed")
                if len(self._q) < self.maxsize:
                    self._q.append(req)
                    self._cond.notify_all()
                    return
                if policy == "shed":
                    raise ShedError(
                        f"queue full ({self.maxsize}); request shed"
                    )
                rem = None if deadline is None else deadline - now()
                if rem is not None and rem <= 0:
                    raise ShedError(
                        f"queue full ({self.maxsize}); admission timed "
                        f"out after {timeout}s"
                    )
                self._cond.wait(rem if rem is not None else 0.1)

    def next_group(self, max_n: int, max_delay: float,
                   poll: float = 0.05) -> list[Request]:
        """Pop the next dispatchable micro-batch (see class docstring).
        Returns [] only when the queue is closed AND drained — the driver's
        exit condition.  A closed-but-nonempty queue drains without waiting
        out deadlines (shutdown flushes, it does not stall)."""
        with self._cond:
            while not self._q:
                if self._closed:
                    return []
                self._cond.wait(poll)
            head = self._q[0]
            deadline = head.t_submit + max_delay
            while not self._closed:
                n_match = sum(1 for r in self._q if r.group == head.group)
                rem = deadline - now()
                if n_match >= max_n or rem <= 0:
                    break
                self._cond.wait(min(rem, poll))
            out: list[Request] = []
            i = 0
            while i < len(self._q) and len(out) < max_n:
                if self._q[i].group == head.group:
                    out.append(self._q.pop(i))
                else:
                    i += 1
            self._cond.notify_all()  # space freed: wake blocked producers
            return out

    def close(self) -> None:
        """Stop admitting; wake everyone.  Producers blocked in ``put``
        raise ``ShedError``; the driver drains what is queued and exits."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
