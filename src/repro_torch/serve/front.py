"""Async serving front of the port: deadline micro-batching and
shape-bucketed dispatch over the PyTorch/CUDA engines — the port of
``repro.serve.front`` for a :class:`~repro_torch.core.flat_index.BSSIndex`.

The engines (``bss_query_batched`` / ``bss_knn_batched``) only earn their
keep on BATCHES; a stream of single queries each paying a full engine call
wastes them.  This front assembles those batches from live traffic:

* ``submit(query, kind="range"|"knn", ...)`` admits one request and
  returns a ``concurrent.futures.Future`` immediately (driver-threaded —
  no asyncio anywhere near the engine path);
* a single driver thread collects compatible requests into micro-batches
  under a deadline / max-batch policy: the batch dispatches when the
  OLDEST queued request has waited ``max_delay_s``, or earlier the moment
  the batch is full;
* every batch is padded up to a fixed ladder of shape buckets
  (``repro_torch.core.backends.DEFAULT_BUCKETS``), so the engines see at
  most ``len(buckets)`` distinct batch shapes per (kind, metric);
* results demux back to the per-request futures, each carrying its own
  engine accounting (``ServeResult``).

The driver thread launches the kernels on the index's device (each wrapper
enters that device and takes its current stream); the kernel libraries are
loaded once per process under ``repro_torch.kernels._build``'s lock, so a
client thread that calls the engines directly meanwhile is safe.  An
exception in the driver (a kernel that fails to build or launch) is set on
every future of its batch: nothing falls back to the CPU or to a plain
version.

Exactness is inherited, not re-proven: the front never post-processes
engine output beyond row demuxing.  Range batches mix PER-REQUEST
thresholds through the engine's per-query radii; padding rows ride with
radius -1, which the planar bound (>= 0) can never meet — padded rows
survive no block, evaluate no distance and hit nothing.  kNN batches group
on their scalar engine parameters (k / r0 / max_rounds), and their padding
rows duplicate the batch's first query — per-query rows of the engine are
independent, so real rows are untouched and the duplicate's cost is
bounded by the bucket rounding (reported as ``padding_waste``).

Admission is a bounded queue with a load-shed policy (block until space,
or fail fast with ``ShedError``), plus an optional exact-hit LRU result
cache keyed on the request's quantized (float32) query bytes and its
dispatch parameters.  Input hygiene happens ONCE at admission: the query
is canonicalised to float32 there (the engines and the cache key both see
the same bytes) and non-finite queries — including float64 values that
overflow the float32 cast — are rejected with ``ValueError`` before they
can poison a micro-batch or become an unmatchable NaN cache entry.  The
cache key is a canonical fixed-order typed tuple (kind, engine, precision,
generation, t, k, r0, max_rounds, dim).

``submit(..., precision="bf16")`` routes the request through the engines'
bf16 exact phase (bit-identical results).  Precision is part of the
dispatch group — fp32 and bf16 requests never share a micro-batch — and of
the cache key, and the re-check volume rides the telemetry (``bf16_rows``,
``recheck_points`` counters, per-request ``ServeResult.n_recheck``).

``stats()`` snapshots the whole pipeline: queue wait, batch sizes, padding
waste, engine time, shed/cache counters.  It is total: an empty telemetry
window yields zeros, never a raise.

Living corpus: ``front.append(rows)`` / ``front.delete(ids)`` /
``front.compact()`` build a NEW index snapshot (``repro_torch.index``) and
swap ``self.index`` between micro-batches — ``_dispatch`` captures the
index reference once per batch, so queries in flight finish on the old
snapshot.  Every mutation bumps the index ``generation``, which is a typed
field of the exact-hit cache key and rides every ``ServeResult``.

Engine knobs ride one frozen :class:`~repro_torch.core.backends.EngineOpts`
(``opts=``); the per-request ``precision`` is overlaid per dispatch.
Without ``opts=`` the front runs ``EngineOpts(realisation="dense")``.
``profile_dir=`` wraps every dispatch in
a ``torch.profiler`` trace (CPU and, on the card, CUDA activities) written
there as Chrome trace JSON, with the engine call inside a
``record_function`` named after the dispatch.

The forest walker is not ported yet (ROADMAP Queue 1 item 4): the front
takes a ``BSSIndex`` only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import threading
from collections import OrderedDict, deque
from concurrent.futures import Future
from pathlib import Path

import numpy as np

from repro_torch.core import flat_index
from repro_torch.core.backends import (
    DEFAULT_BUCKETS,
    EngineOpts,
    bucket_for,
    resolve_engine_opts,
)
from repro_torch.index import maintain as index_maintain
from repro_torch.kernels import _build
from repro_torch.obs.fold import (
    fold_engine_stats,
    fold_mutation,
    poll_compile,
    shard_imbalance as _shard_imbalance,
)
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.spans import Span
from repro_torch.obs.trace import (
    TraceBuffer,
    complete_event,
    metadata_event,
    span_events,
    write_trace,
)
from repro_torch.serve.queue import (
    BoundedRequestQueue,
    Request,
    ShedError,
    nearest_rank,
    now,
)
from repro_torch.serve.retrieval import FOREST_NOT_PORTED

__all__ = ["ServingFront", "ServeResult", "ShedError"]


@dataclasses.dataclass
class ServeResult:
    """What a request's future resolves to: the engine result rows for this
    request plus its slice of the batch telemetry."""

    hits: list[int] | None = None        # range: original corpus indices
    indices: np.ndarray | None = None    # knn: (k,) original ids, -1 padded
    distances: np.ndarray | None = None  # knn: (k,) ascending
    n_dists: int = 0                     # this query's own distance charge
    n_recheck: int = 0                   # bf16 band points re-run in fp32
    queue_wait_s: float = 0.0            # admission -> dispatch
    engine_s: float = 0.0                # the batch's engine wall time
    batch_size: int = 0                  # real requests in the batch
    padded_to: int = 0                   # bucket the batch dispatched at
    cache_hit: bool = False
    generation: int = 0                  # index snapshot this was served on
    trace_id: str = ""                   # obs trace id (front.explain(...))
    spans: dict | None = None            # per-stage durations (obs spans)


def _copy_result(res: ServeResult) -> ServeResult:
    """Fresh hits list / result arrays: cache entries and client results
    must never alias (a client sorting its hit list in place must not
    corrupt what the next cache hit is served)."""
    return dataclasses.replace(
        res,
        hits=None if res.hits is None else list(res.hits),
        indices=None if res.indices is None else res.indices.copy(),
        distances=None if res.distances is None else res.distances.copy(),
    )


def _cache_key(
    kind: str,
    engine: str,
    precision: str,
    generation: int,
    t: float | None,
    k: int | None,
    r0: float | None,
    max_rounds: int | None,
    q: np.ndarray,
) -> bytes:
    """Canonical cache key: a FIXED-ORDER, explicitly-typed header tuple
    followed by the float32 query bytes.

    Properties the old ``repr(params) + q.tobytes()`` scheme lacked:

    * injective — the header is NUL-free ASCII and the key splits at the
      first NUL, so a (header, query) pair can never masquerade as a
      different one by shifting bytes across the boundary (query bytes are
      arbitrary and routinely contain printable ASCII);
    * typed — every field is coerced (float/int/None) before formatting,
      so ``t=1`` and ``t=1.0`` are one entry, not two;
    * total — every dispatch parameter of BOTH kinds appears in its fixed
      slot (None where the kind doesn't use it), so a stray parameter of
      the other kind can neither split nor merge entries.

    ``generation`` (v3) keys the entry to ONE index snapshot: a mutation
    bumps the live generation, so every pre-mutation entry stops matching
    — the cache needs no flush hook, stale results are unreachable by
    construction (generations are monotonic, an old value never returns).
    """
    head = (
        "v3", kind, engine, precision, int(generation),
        None if t is None else float(t),
        None if k is None else int(k),
        None if r0 is None else float(r0),
        None if max_rounds is None else int(max_rounds),
        int(q.shape[0]),
    )
    return repr(head).encode("ascii") + b"\x00" + q.tobytes()


class _LRU:
    """Exact-hit result cache: quantized query bytes + dispatch params ->
    finished ServeResult.  Plain OrderedDict LRU under the front's lock;
    entries are defensively copied on both sides (see ``_copy_result``)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: OrderedDict[bytes, ServeResult] = OrderedDict()

    def get(self, key: bytes) -> ServeResult | None:
        res = self._d.get(key)
        if res is None:
            return None
        self._d.move_to_end(key)
        return _copy_result(res)

    def put(self, key: bytes, res: ServeResult) -> None:
        self._d[key] = _copy_result(res)
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)


class ServingFront:
    """Deadline-based micro-batching front over a built
    :class:`~repro_torch.core.flat_index.BSSIndex` (range + kNN).

    ``prep`` optionally maps raw query batches into the index's engine
    space; the BSS engines do their own prep, so fronts normally leave it
    None and feed the engines exactly what a direct call would —
    bit-identity preserved.

    Without ``opts`` the front pins the ``"torch"`` backend's exact phase
    to the dense realisation, as the reference's front pins its jnp
    backend: the adaptive path gathers a data-dependent number of cells,
    and the bucket ladder exists to keep each batch's shapes fixed.
    ``"cuda"`` runs the masked kernel whatever it says.
    """

    def __init__(
        self,
        index,
        *,
        buckets: tuple = DEFAULT_BUCKETS,
        max_delay_s: float = 0.002,
        max_queue: int = 1024,
        admission: str = "block",
        cache_size: int = 0,
        opts: EngineOpts | None = None,
        prep=None,
        start: bool = True,
        metrics: bool = True,
        profile_dir: str | None = None,
    ):
        if not isinstance(index, flat_index.BSSIndex):
            raise TypeError(
                f"index must be a BSSIndex, got {type(index).__name__} "
                f"({FOREST_NOT_PORTED})"
            )
        self._engine = "bss"
        if not buckets or list(buckets) != sorted(set(int(b) for b in buckets)):
            raise ValueError(
                f"buckets must be a strictly ascending ladder, got {buckets!r}"
            )
        if admission not in ("block", "shed"):
            raise ValueError(
                f"admission must be block|shed, got {admission!r}"
            )
        self.index = index
        self.buckets = tuple(int(b) for b in buckets)
        self.max_delay_s = float(max_delay_s)
        self.admission = admission
        # the front's realisation default is "dense", not the engine's
        # "adaptive" (see class doc)
        self.opts = (EngineOpts(realisation="dense") if opts is None
                     else resolve_engine_opts(opts))
        self.prep = prep
        self._queue = BoundedRequestQueue(max_queue)
        self._cache = _LRU(cache_size) if cache_size > 0 else None
        self._lock = threading.Lock()  # telemetry + cache
        self._mutate_lock = threading.Lock()  # serialises index mutations
        # telemetry: scalar tallies + a bounded window for percentiles
        self._n = dict(
            submitted=0, completed=0, shed=0, cache_hits=0, errors=0,
            batches=0, rows=0, padded_rows=0, dispatches=0,
            bf16_rows=0, recheck_points=0,
        )
        self._per_bucket: dict[int, int] = {}
        self._waits: deque[float] = deque(maxlen=4096)
        self._engine_s_total = 0.0
        # observability: registry folding + explain ring are gated on
        # `metrics`; trace ids and span timestamps always ride the requests
        # (they are part of ServeResult).  `profile_dir` opts into a
        # torch.profiler trace around each engine dispatch.
        self.metrics_enabled = bool(metrics)
        self.profile_dir = profile_dir
        self._metrics = MetricsRegistry()
        self._trace = TraceBuffer()
        self._explain: deque[dict] = deque(maxlen=256)
        self._compile_last: dict[str, int] = {}
        self._profiles = itertools.count()
        # the counterpart of the reference's jit caches: how many times each
        # CUDA source's library was built or loaded in this process
        self._compile_watch = {
            name: functools.partial(_build.load_count, name)
            for name in _build.SOURCES
        }
        if self.metrics_enabled:
            # the bucket-ladder recompile contract, visible at runtime:
            # compile/recompiles growth should stay within this ladder
            self._metrics.gauge("compile/ladder_buckets").set(
                len(self.buckets)
            )
            # the living-corpus gauges exist from birth (a fresh front
            # reports its snapshot, not an absent series)
            self._metrics.gauge("index/generation").set(
                int(index.generation)
            )
            self._metrics.gauge("index/tombstone_frac").set(
                float(index.tombstone_frac)
            )
        self._thread: threading.Thread | None = None
        if start:
            self.start()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._drive, name="serving-front-driver", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        """Stop admitting, drain the queue (every pending future resolves),
        and join the driver.  Idempotent."""
        self._queue.close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "ServingFront":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- admission

    def submit(
        self,
        query: np.ndarray,
        kind: str = "range",
        *,
        t: float | None = None,
        k: int | None = None,
        r0: float | None = None,
        max_rounds: int = 8,
        timeout: float | None = None,
        precision: str = "fp32",
    ) -> Future:
        """Admit one query; returns a Future resolving to ``ServeResult``.

        ``kind="range"`` needs ``t`` (a metric distance; per-request — BSS
        batches mix thresholds); ``kind="knn"`` needs ``k`` (requests
        sharing (k, r0, max_rounds) batch together).  ``precision`` selects
        the engine exact phase ("fp32" | "bf16" — same results either way;
        part of the dispatch group, so precisions never share a batch).
        Admission follows the front's policy: "block" waits for queue space
        (up to ``timeout``), "shed" fails fast — either way a rejected
        request raises :class:`ShedError` out of ``submit`` itself, never a
        half-admitted future.

        The query is canonicalised to float32 HERE, once — engines, padding
        rows and the cache key all see the same bytes — and must be finite
        after that cast: NaN/Inf inputs (or float64 values overflowing
        float32) raise ``ValueError`` at admission instead of riding into a
        shared micro-batch."""
        # out-of-range float64 inputs overflow to Inf here ON PURPOSE — the
        # finiteness check below turns them into a clean admission error,
        # so the cast itself must not warn
        with np.errstate(over="ignore"):
            q = np.asarray(query, np.float32)
        if q.ndim != 1:
            raise ValueError(
                f"submit takes ONE query vector (the front does the "
                f"batching), got shape {q.shape}"
            )
        if not np.all(np.isfinite(q)):
            raise ValueError(
                "query must be finite after the float32 cast (no NaN/Inf; "
                "float64 values beyond float32 range overflow to Inf)"
            )
        # canonicalise -0.0 -> +0.0: distances cannot tell them apart, so
        # the cache key must not either
        q = q + np.float32(0.0)
        if precision not in ("fp32", "bf16"):
            raise ValueError(f"precision must be fp32|bf16, got {precision!r}")
        if kind == "range":
            if t is None:
                raise ValueError("range requests need t=")
            t = float(t)
            if t < 0:
                raise ValueError(
                    f"t must be >= 0 (negative radii are the engine's "
                    f"padding sentinel), got {t}"
                )
            group = ("range", precision)
        elif kind == "knn":
            if k is None or int(k) <= 0:
                raise ValueError(f"knn requests need a positive k, got {k}")
            k = int(k)
            group = ("knn", k, None if r0 is None else float(r0),
                     int(max_rounds), precision)
        else:
            raise ValueError(f"kind must be range|knn, got {kind!r}")

        fut: Future = Future()
        span = Span()
        span.mark("admit")
        key = None
        if self._cache is not None:
            # the kind's FULL dispatch signature in fixed typed slots (None
            # where the kind doesn't use a slot): the BSS range group key
            # omits t (mixed-threshold batching), so t joins the key here;
            # a stray parameter of the OTHER kind can neither split nor
            # merge logically identical requests
            # generation is read HERE, at admission: a hit must reflect the
            # index the caller can observe right now.  If a mutation lands
            # between admission and dispatch, the computed result is stored
            # under this (now unreachable) key — generations are monotonic,
            # so a mislabelled entry can never be served, only evicted.
            key = _cache_key(
                kind, self._engine, precision,
                int(getattr(self.index, "generation", 0)),
                t if kind == "range" else None,
                k if kind == "knn" else None,
                (None if r0 is None else float(r0)) if kind == "knn" else None,
                int(max_rounds) if kind == "knn" else None,
                q,
            )
            with self._lock:
                hit = self._cache.get(key)
            if hit is not None:
                with self._lock:
                    self._n["submitted"] += 1
                    self._n["cache_hits"] += 1
                    self._n["completed"] += 1
                if self.metrics_enabled:
                    self._metrics.counter("serve/cache_hits").inc()
                fut.set_result(dataclasses.replace(
                    hit, cache_hit=True, trace_id=span.trace_id,
                    spans=span.durations(),
                ))
                return fut
        req = Request(
            query=q, kind=kind, group=group, future=fut, t_submit=now(),
            t=t, k=k, cache_key=key, precision=precision,
            trace_id=span.trace_id, span=span,
        )
        try:
            self._queue.put(req, policy=self.admission, timeout=timeout)
        except ShedError:
            with self._lock:
                self._n["submitted"] += 1
                self._n["shed"] += 1
            raise
        with self._lock:
            self._n["submitted"] += 1
        return fut

    def submit_many(self, queries: np.ndarray, kind: str = "range",
                    **kw) -> list[Future]:
        """Convenience fan-in: one ``submit`` per row (shared params)."""
        return [self.submit(q, kind, **kw) for q in np.asarray(queries)]

    # -------------------------------------------------------------- driver

    def _drive(self) -> None:
        while True:
            group = self._queue.next_group(self.buckets[-1], self.max_delay_s)
            if not group:
                return  # closed and drained
            try:
                self._dispatch(group)
            except Exception as e:  # noqa: BLE001 — resolve, never wedge
                with self._lock:
                    self._n["errors"] += 1
                for r in group:
                    try:
                        # a client cancel can race the done() check; an
                        # InvalidStateError here must not kill the driver
                        if not r.future.done():
                            r.future.set_exception(e)
                    except Exception:  # noqa: BLE001
                        pass

    @staticmethod
    def _resolve(fut: Future, res: ServeResult) -> bool:
        """Set a result, tolerating client-side cancellation (a cancelled
        future must never poison the rest of its micro-batch)."""
        if fut.cancelled():
            return False
        try:
            fut.set_result(res)
            return True
        except Exception:  # noqa: BLE001 — cancel racing the set
            return False

    @contextlib.contextmanager
    def _profiler(self, device):
        """Opt-in ``torch.profiler`` trace around one dispatch (a no-op
        unless the front was built with ``profile_dir=``): CPU activities,
        and CUDA ones for an index on the card, written to ``profile_dir``
        as one Chrome trace file per dispatch.  Host-side only — it wraps
        the engine call and changes nothing in it."""
        if self.profile_dir is None:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            yield
        out = Path(self.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(
            str(out / f"dispatch-{next(self._profiles):06d}.json")
        )

    def _annotate(self, name: str):
        """Opt-in ``torch.profiler.record_function`` around the engine call.

        The name carries the dispatch's span timestamp on the serving
        clock, so the device-side profile and the host trace
        (``export_trace``) can be lined up on one timeline even though the
        profiler keeps its own epoch."""
        if self.profile_dir is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def _dispatch(self, group: list[Request]) -> None:
        """One engine call for one compatible micro-batch: pad to the
        bucket, run the fused path, demux rows to futures."""
        # ONE index snapshot per batch, captured before any engine work: a
        # concurrent mutation swaps self.index between batches, and this
        # whole batch finishes on whichever snapshot it started with — no
        # torn reads, and every row's ServeResult.generation names it
        index = self.index
        generation = int(getattr(index, "generation", 0))
        # clients may have cancelled queued futures (the standard timeout
        # move); drop them before spending engine time
        group = [r for r in group if not r.future.cancelled()]
        if not group:
            return
        t_batch = now()
        for r in group:
            if r.span is not None:
                r.span.mark("batch", t_batch)
        n = len(group)
        bucket = bucket_for(n, self.buckets)
        pad = bucket - n
        qs = np.stack([r.query for r in group])
        if pad:
            # duplicate the first row: always a valid engine input (zeros
            # are not, for the probability-space metrics); BSS range pads
            # are additionally killed by their -1 radius below
            qs = np.concatenate([qs, np.repeat(qs[:1], pad, axis=0)])
        if self.prep is not None:
            qs = self.prep(qs)
        head = group[0]
        t_wait = now()
        for r in group:
            if r.span is not None:
                r.span.mark("dispatch", t_wait)
        # one EngineOpts per dispatch: the front's base knobs with this
        # group's precision overlaid (precisions never share a batch)
        eng_opts = dataclasses.replace(self.opts, precision=head.precision)
        ann = (
            f"serve/engine kind={head.kind} bucket={bucket} "
            f"gen={generation} t_dispatch={t_wait:.6f}"
        )
        with self._profiler(index.torch_device), self._annotate(ann):
            if head.kind == "range":
                t_vec = np.array(
                    [r.t for r in group] + [-1.0] * pad, np.float32
                )
                hits, stats = flat_index.bss_query_batched(
                    index, qs, t_vec, opts=eng_opts,
                )
            else:  # knn
                _, k, r0, max_rounds, _ = head.group
                idx, dist, stats = flat_index.bss_knn_batched(
                    index, qs, k, r0=r0, max_rounds=max_rounds,
                    opts=eng_opts,
                )
        t_engine = now()
        engine_s = t_engine - t_wait
        for r in group:
            if r.span is not None:
                r.span.mark("engine", t_engine)
        per_q = np.asarray(stats["per_query_dists"])
        excluded = {
            m: np.asarray(v) for m, v in stats.get("excluded", {}).items()
        }
        recheck = None
        if head.precision == "bf16":
            recheck = np.asarray(
                stats.get("per_query_recheck", np.zeros(bucket, np.int64))
            )

        if self.metrics_enabled:
            reg = self._metrics
            # fold REAL rows only — padding rows are a bucket artefact,
            # not query traffic (same convention as the bf16 accounting)
            folded = dict(stats)
            folded["n_queries"] = n
            folded["per_query_dists"] = per_q[:n]
            folded["excluded"] = {m: v[:n] for m, v in excluded.items()}
            if recheck is not None:
                folded["per_query_recheck"] = recheck[:n]
            fold_engine_stats(reg, folded)
            reg.histogram("serve/batch_size", kind=head.kind).observe(n)
            reg.histogram("serve/engine_s", kind=head.kind).observe(engine_s)
            if pad:
                reg.counter("serve/padded_rows").inc(pad)
            with self._lock:
                poll_compile(reg, self._compile_watch, self._compile_last)

        with self._lock:
            self._n["batches"] += 1
            self._n["rows"] += bucket
            self._n["padded_rows"] += pad
            self._per_bucket[bucket] = self._per_bucket.get(bucket, 0) + 1
            self._engine_s_total += engine_s
            if recheck is not None:
                # re-check volume over REAL rows only — padding rows are a
                # bucket artefact, not precision cost
                self._n["bf16_rows"] += n
                self._n["recheck_points"] += int(recheck[:n].sum())
        trace_evs: list[dict] = []
        for i, r in enumerate(group):
            wait = t_wait - r.t_submit
            durs = None
            if r.span is not None:
                r.span.mark("demux")
                durs = r.span.durations()
                if self.metrics_enabled:
                    trace_evs.extend(span_events(
                        r.span, tid=int(r.trace_id[1:]),
                        args={"kind": r.kind, "generation": generation},
                    ))
            res = ServeResult(
                n_dists=int(per_q[i]),
                n_recheck=0 if recheck is None else int(recheck[i]),
                queue_wait_s=wait,
                engine_s=engine_s, batch_size=n, padded_to=bucket,
                generation=generation, trace_id=r.trace_id, spans=durs,
            )
            if r.kind == "range":
                res.hits = hits[i]
            else:
                res.indices = idx[i]
                res.distances = dist[i]
            if self.metrics_enabled:
                if durs:
                    for stage, v in durs.items():
                        self._metrics.histogram(
                            "serve/span_s", stage=stage
                        ).observe(v)
                # per-request "explain" record: this row's slice of the
                # batch accounting + attribution, dumpable via explain()
                rec = {
                    "trace_id": r.trace_id,
                    "kind": r.kind,
                    "precision": head.precision,
                    "engine": stats.get("engine", self._engine),
                    "backend": stats.get("backend", self.opts.backend),
                    "generation": generation,
                    "batch_size": n,
                    "padded_to": bucket,
                    "n_dists": int(per_q[i]),
                    "n_recheck": 0 if recheck is None else int(recheck[i]),
                    "excluded": {m: int(v[i]) for m, v in excluded.items()},
                    "spans": durs,
                }
                if "shard_dists" in stats:
                    # the sharded engine's per-shard split of the batch's
                    # exact-phase work — batch-level, same for every row
                    sd = np.asarray(stats["shard_dists"], np.int64)
                    rec["shard_dists"] = sd.tolist()
                    rec["shard_blocks"] = np.asarray(
                        stats["shard_blocks"], np.int64
                    ).tolist()
                    rec["shard_imbalance"] = _shard_imbalance(sd)
                with self._lock:
                    self._explain.append(rec)
            if not self._resolve(r.future, res):
                continue
            with self._lock:
                self._n["completed"] += 1
                self._waits.append(wait)
                if self._cache is not None and r.cache_key is not None:
                    self._cache.put(r.cache_key, res)
        if self.metrics_enabled:
            # one clock for everything: the dispatch's engine-phase slices
            # land on the driver track (tid 0), each request's stage slices
            # on its own per-request track — all stamped by `now()`
            args = {
                "kind": head.kind, "batch_size": n, "padded_to": bucket,
                "generation": generation,
                "engine": str(stats.get("engine", self._engine)),
                "n_dists": int(per_q[:n].sum()),
            }
            trace_evs.extend([
                complete_event("dispatch/assemble", t_batch,
                               t_wait - t_batch, tid=0, cat="dispatch",
                               args=args),
                complete_event("dispatch/engine", t_wait, engine_s, tid=0,
                               cat="dispatch", args=args),
                complete_event("dispatch/demux", t_engine, now() - t_engine,
                               tid=0, cat="dispatch", args=args),
            ])
            self._trace.extend(trace_evs)

    # ------------------------------------------------------------ mutations

    def _mutate(self, fn):
        """Run one functional mutation and swap the live index.

        The mutation builds a NEW index (``repro_torch.index.maintain`` never
        touches the old one), then the swap is a single reference
        assignment — atomic to the driver thread, so a micro-batch either
        dispatches wholly on the old snapshot or wholly on the new one.
        ``_mutate_lock`` only serialises concurrent MUTATORS (so two
        appends compose instead of one clobbering the other); it is never
        held by the query path.
        """
        t0 = now()
        with self._mutate_lock:
            new_index, mstats = fn(self.index)
            self.index = new_index
        if mstats is not None and self.metrics_enabled:
            t1 = now()
            fold_mutation(self._metrics, mstats, seconds=t1 - t0)
            # mutations share the driver track (tid 0): index maintenance
            # shows up inline with the dispatches it interleaves with
            self._trace.add(complete_event(
                f"mutation/{mstats.op}", t0, t1 - t0, tid=0, cat="mutation",
                args={
                    "op": str(mstats.op),
                    "rows": int(mstats.rows),
                    "generation": int(mstats.generation),
                    "n_blocks": int(mstats.n_blocks),
                    "tombstone_frac": float(mstats.tombstone_frac),
                },
            ))
        return mstats

    def append(self, rows):
        """Add ``rows`` (raw metric space, same dim) to the served corpus:
        fresh blocks against the existing pivot tables, generation bumped,
        cache entries of the old generation orphaned by key.  Returns the
        :class:`~repro_torch.index.maintain.MutationStats`; queries admitted
        after this call see the new rows."""
        return self._mutate(lambda idx: index_maintain.append(idx, rows))

    def delete(self, ids):
        """Tombstone live corpus ids: they stop matching range/kNN from
        the next micro-batch on (in-flight batches finish on the old
        snapshot).  Returns the mutation's ``MutationStats``."""
        return self._mutate(lambda idx: index_maintain.delete(idx, ids))

    def compact(self, *, refresh_pivots: bool = True):
        """Re-permute the live rows into dense blocks (drops tombstones;
        ``refresh_pivots=True`` also rebuilds the pivot tables from the
        surviving corpus — bit-identical to a fresh ``build_bss`` over the
        live rows).  Returns the mutation's ``MutationStats``."""
        return self._mutate(
            lambda idx: index_maintain.compact(
                idx, refresh_pivots=refresh_pivots
            )
        )

    def maybe_compact(self, *, max_tombstone_frac: float = 0.25,
                      max_block_growth: float = 2.0,
                      refresh_pivots: bool | None = None):
        """Compact only when degraded (tombstone fraction / block growth
        thresholds — see :func:`repro_torch.index.maintain.maybe_compact`).
        With metrics on, the front feeds its own OBSERVED
        ``engine/block_exclusion_rate`` gauge into the pivot-refresh
        decision: measured exclusion decay is what triggers a pivot
        refresh, exactly as the maintenance doc prescribes.  Returns the
        ``MutationStats`` when a compaction ran, else None."""
        rate = None
        if self.metrics_enabled and refresh_pivots is None:
            vals = [
                s.value for s in self._metrics.series()
                if s.kind == "gauge"
                and s.name == "engine/block_exclusion_rate"
            ]
            if vals:
                rate = min(vals)
        return self._mutate(
            lambda idx: index_maintain.maybe_compact(
                idx, max_tombstone_frac=max_tombstone_frac,
                max_block_growth=max_block_growth,
                block_exclusion_rate=rate, refresh_pivots=refresh_pivots,
            )
        )

    # ------------------------------------------------------------ telemetry

    def metrics(self) -> MetricsRegistry:
        """The front's metrics registry (always constructed; populated only
        while ``metrics=True``).  ``front.metrics().render()`` is the
        one-screen dashboard; ``.snapshot()`` / ``.to_prometheus()`` export
        it."""
        return self._metrics

    def explain(self, trace_id: str | None = None) -> dict | None:
        """The per-request explain record for ``trace_id`` (most recent
        request when None): span durations, batch shape, this row's
        distance charge, per-mechanism exclusion attribution and — on the
        sharded engine — the batch's per-shard work split.

        Records live in a bounded ring of the last 256 dispatched
        requests.  Asking for a specific ``trace_id`` that is not in the
        ring raises ``KeyError`` naming the capacity — the id either aged
        out, was served from the exact-hit cache (cache hits never
        dispatch), or the front runs with metrics off.  ``explain()``
        with no id returns the most recent record, or None when the ring
        is empty."""
        with self._lock:
            recs = list(self._explain)
        if trace_id is None:
            return recs[-1] if recs else None
        for rec in reversed(recs):
            if rec["trace_id"] == trace_id:
                return rec
        raise KeyError(
            f"no explain record for trace id {trace_id!r}: the ring keeps "
            f"the last {self._explain.maxlen} dispatched requests, and "
            f"cache hits / metrics-off requests never enter it"
        )

    def export_trace(self, path, *, extra: dict | None = None):
        """Write everything the trace buffer holds (request stage slices,
        per-dispatch engine phases, mutation slices — one monotonic clock)
        as Chrome trace-event JSON to ``path``; returns the path.  Load it
        in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``."""
        meta = [
            metadata_event("process_name", "repro-serving"),
            metadata_event("thread_name", "driver", tid=0),
        ]
        other = {
            "engine": self._engine,
            "backend": self.opts.backend,
            "clock": "repro_torch.serve.queue.now (monotonic, seconds*1e6)",
        }
        if extra:
            other.update(extra)
        return write_trace(path, meta + self._trace.events(), extra=other)

    def stats(self) -> dict:
        """Snapshot of the pipeline telemetry (host-side counters only —
        never blocks on the engine).  Total on an empty window: a fresh
        front with zero completions reports zeros everywhere, it never
        raises (regression-tested — percentiles, means and ratios all
        guard their denominators)."""
        with self._lock:
            waits = list(self._waits)
            n = dict(self._n)
            per_bucket = dict(self._per_bucket)
            engine_s = self._engine_s_total

        def pct(p: float) -> float:
            # nearest_rank is 0.0 on an empty window by contract; the guard
            # here keeps stats() total even if that contract ever changes
            return nearest_rank(waits, p) if waits else 0.0

        rows = n["rows"]
        return {
            **n,
            "queue_depth": len(self._queue),
            "per_bucket_batches": per_bucket,
            "batch_size_mean": (
                (rows - n["padded_rows"]) / n["batches"] if n["batches"] else 0.0
            ),
            "padding_waste": n["padded_rows"] / rows if rows else 0.0,
            "queue_wait_s": {
                "mean": sum(waits) / len(waits) if waits else 0.0,
                "p50": pct(0.50), "p95": pct(0.95), "max": pct(1.0),
            },
            "engine_s_total": engine_s,
            "engine_s_per_batch": engine_s / n["batches"] if n["batches"] else 0.0,
        }
