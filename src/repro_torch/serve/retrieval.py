"""Retrieval serving of the port — ``repro.serve.retrieval`` over the
PyTorch/CUDA engines.

Pipeline: an embedded corpus (a trained item tower, topic histograms, …)
-> the Blocked Supermetric Scan index (exact search, four-point pruning)
-> queries served in batches through ``bss_query_batched`` /
``bss_knn_batched``, whose distance tiles and planar bound are the port's
Hopper kernels on the card.

The server is parametrised by METRIC — any four-point metric in the
registry is served exactly:

* ``metric="cosine"`` (default) — the dot-product specialisation: scoring a
  dot product on l2-normalised towers is order-equivalent to Euclidean
  distance (``d^2 = 2 - 2<u,i>``), so the index serves EXACT top-k /
  min-score retrieval for the model's own similarity.  The score↔distance
  mapping (``score_to_distance``) lives only in this specialisation; the
  engine itself serves cosine as l2 on the unit sphere.
* ``metric="jsd"`` / ``"triangular"`` — probability-vector corpora:
  thresholds are distances, use ``range_by_distance``; ``top_k`` works
  unchanged.
* ``metric="l2"`` (or a registered power transform) — plain metric serving.

The server runs on the CUDA device unless the caller passes ``device=``
(``"cpu"`` runs the plain ``"torch"`` backend); ``device=None`` raises
where there is no card.  ``mesh=`` (a ``repro_torch.parallel.ShardMesh``)
shards the BSS corpus blocks over the mesh's devices: every call then runs
one pass per shard with the merge on the lead device
(``repro_torch.parallel.shard_index``), results identical to
single-device serving.  BSS only: the forest is not sharded.

Index backends
--------------
``index="bss"`` (default) serves through the Blocked Supermetric Scan;
``index="forest"`` builds one of the paper's partition trees
(``forest_variant``, default the paper's best ``hpt_fft_log``), encodes it
for the server's device with ``repro_torch.forest`` and serves range
queries through the batched tree walk (``forest_mechanism``, default
Hilbert) — the same exactness contract, tree-shaped pruning.  kNN serving
stays a BSS capability, so ``top_k`` and ``search(kind="knn")`` on a
forest server raise ``FOREST_KNN_ERROR``, and the encoded forest is
immutable: mutations raise.

Unified search API
------------------
``server.search(queries, kind="range"|"knn", *, t=..., k=..., opts=...)``
is THE entry point: both kinds, one typed :class:`SearchResult` (hits /
indices / distances / engine stats / index generation), engine knobs as
one frozen :class:`~repro_torch.core.backends.EngineOpts`.  The per-kind
methods (``range_query`` / ``range_by_distance`` / ``top_k``) remain as
thin delegates.

Living corpus
-------------
``server.append(embeddings)`` / ``server.delete(ids)`` /
``server.compact()`` swap ``self.index`` for the next snapshot
(``repro_torch.index``; queries always see one consistent generation) and
keep ``self.corpus`` — the scoring/oracle mirror — consistent: appends
extend it with the SAME engine-space rows the index ingests, deletes mark
a live mask that ``top_k_oracle`` honours.  Mutations fold into
``server.metrics`` (``index/generation``, ``index/tombstone_frac``,
per-op latency).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import flat_index, tree
from repro_torch.core.backends import EngineOpts, resolve_engine_opts
from repro_torch.core.exclusion import HILBERT
from repro_torch.core.npdist import pairwise_np
from repro_torch.forest import encode_tree, forest_range_search
from repro_torch.index import maintain as index_maintain
from repro_torch.obs.fold import fold_engine_stats, fold_mutation
from repro_torch.obs.record import span
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serve.queue import now

__all__ = ["RetrievalServer", "SearchResult", "ServeStats", "score_to_distance",
           "distance_to_score", "FOREST_KNN_ERROR", "FOREST_IMMUTABLE"]

# The one message every forest-kNN refusal raises (RetrievalServer and the
# async front alike), the reference's words.
FOREST_KNN_ERROR = (
    "top_k serving runs on the BSS engine — rebuild with index='bss'; the "
    "forest walker is a range engine, and its radius-deepening kNN "
    "reduction (like bss_knn_batched's) is the open 'forest kNN' ROADMAP "
    "item"
)

# What a mutation of a forest server raises (the reference's words).
FOREST_IMMUTABLE = (
    "living-corpus mutations run on the BSS engine; the encoded forest is "
    "immutable — rebuild the server (incremental tree maintenance is "
    "ROADMAP work)"
)


def score_to_distance(score: np.ndarray) -> np.ndarray:
    """dot-product score (normalised towers) -> Euclidean distance."""
    return np.sqrt(np.maximum(2.0 - 2.0 * score, 0.0))


def distance_to_score(dist: np.ndarray) -> np.ndarray:
    return 1.0 - 0.5 * dist * dist


@dataclasses.dataclass
class SearchResult:
    """What :meth:`RetrievalServer.search` returns — one typed shape for
    both kinds.  Range fills ``hits``; kNN fills ``indices``/``distances``;
    both carry the engine's stats dict and the index generation the call
    was served on (bumped by every mutation)."""

    kind: str                            # "range" | "knn"
    hits: list | None = None             # range: per-query corpus-id lists
    indices: np.ndarray | None = None    # knn: (Q, k) ids, -1 padded
    distances: np.ndarray | None = None  # knn: (Q, k) ascending
    stats: dict | None = None            # the engine-call stats dict
    generation: int = 0


@dataclasses.dataclass
class ServeStats:
    n_queries: int = 0
    total_dists: float = 0.0
    total_seconds: float = 0.0
    exhaustive_dists: float = 0.0

    @property
    def dists_per_query(self) -> float:
        return self.total_dists / max(self.n_queries, 1)

    @property
    def saving(self) -> float:
        return 1.0 - self.total_dists / max(self.exhaustive_dists, 1.0)


class RetrievalServer:
    """Batched exact retrieval over an embedded corpus (the BSS engine or the
    forest walk on the index's device), parametrised by any four-point
    metric in the registry."""

    def __init__(self, corpus_embeddings: np.ndarray, *, metric: str = "cosine",
                 n_pivots: int = 16, n_pairs: int = 24, block: int = 128,
                 seed: int = 0, opts: EngineOpts | None = None,
                 index: str = "bss", forest_variant: str = "hpt_fft_log",
                 forest_mechanism: str = HILBERT, mesh=None,
                 device=None, built=None):
        """``device`` is where the index lives (``None``: the CUDA device,
        raising without one; ``"cpu"`` for the plain backend; with ``mesh``
        the mesh's lead device).  ``mesh`` shards the BSS index (module
        docstring).  ``built``: a ``BSSIndex`` the caller already built over
        ``corpus_embeddings`` with these settings, served as it is instead
        of a second build."""
        if index not in ("bss", "forest"):
            raise ValueError(f"index must be bss|forest, got {index!r}")
        if built is not None and (index != "bss" or mesh is not None or metric == "cosine"):
            # a cosine server builds over its normalised copy of the corpus
            raise ValueError("built= takes a single-device BSS index of a metric the "
                             "server does not renormalise (not cosine)")
        if mesh is not None and index != "bss":
            raise ValueError(
                "mesh= shards the BSS engine; forest serving is single-device"
                " (ROADMAP work)"
            )
        corpus = np.array(corpus_embeddings, np.float32, copy=True)
        self.metric = metric
        if metric == "cosine":
            # kept normalised server-side so dot-product scoring against
            # self.corpus matches the index geometry exactly; the engine's
            # own floor is reused so both normalisations agree bit-for-bit
            corpus = flat_index._engine_queries("cosine", corpus)
        self.corpus = corpus
        # every live row of self.corpus; deletes flip entries False so the
        # brute-force oracle stays aligned with the served index
        self._live = np.ones(len(corpus), dtype=bool)
        self.opts = EngineOpts() if opts is None else resolve_engine_opts(opts)
        self.index_kind = index
        if index == "forest":
            # cosine rides the l2 geometry on the normalised corpus, as in
            # the BSS engine; other metrics build natively
            self.forest_mechanism = forest_mechanism
            self.tree = tree.build_tree(
                forest_variant, flat_index._engine_metric(metric), corpus,
                seed=seed,
            )
            self.index = encode_tree(self.tree, device=device)
        elif built is not None:
            if built.metric_name != metric or built.n_valid != len(corpus):
                raise ValueError(f"the built index ({built.metric_name}, {built.n_valid} "
                                 f"rows) is not over this {metric} corpus of {len(corpus)}")
            self.index = built
        else:
            self.index = flat_index.build_bss(
                metric, corpus, n_pivots=n_pivots, n_pairs=n_pairs,
                block=block, seed=seed, device=device, mesh=mesh,
            )
        self.stats = ServeStats()
        # engine-call metrics (same registry/fold machinery as the async
        # front); synchronous serving folds once per batched call
        self.metrics = MetricsRegistry()

    def _prep(self, user_embeddings: np.ndarray) -> np.ndarray:
        q = np.asarray(user_embeddings, np.float32)
        if self.metric == "cosine":
            q = flat_index._engine_queries("cosine", q)
        return q

    def _account(self, nq: int, engine_stats: dict, t0: float) -> None:
        self.stats.n_queries += nq
        self.stats.total_dists += engine_stats["dists_per_query"] * nq
        # the exhaustive comparator scans the LIVE corpus (tombstoned rows
        # cost a brute-force scan nothing either)
        self.stats.exhaustive_dists += nq * int(self._live.sum())
        self.stats.total_seconds += now() - t0
        fold_engine_stats(self.metrics, engine_stats)
        self.metrics.histogram("serve/call_s").observe(now() - t0)

    def search(self, queries: np.ndarray, kind: str = "range", *,
               t: float | None = None, k: int | None = None,
               opts: EngineOpts | None = None,
               r0: float | None = None,
               max_rounds: int = 8) -> SearchResult:
        """The unified entry point: both query kinds, one typed result.

        ``kind="range"`` needs ``t`` (a METRIC distance — the cosine
        specialisation's min-score maps through ``score_to_distance``, or
        use the ``range_query`` delegate); ``kind="knn"`` needs a positive
        ``k`` (``r0`` / ``max_rounds`` tune its radius schedule).  ``opts``
        overrides the server's engine knobs for this call only.  The
        result carries the engine stats dict and the index ``generation``
        it was served on — after a mutation, results from the old snapshot
        are distinguishable by that field alone.  While a profiler records,
        the call is the root span ``retrieval.search`` of the engine's spans
        (``repro_torch.obs.record``)."""
        with span("retrieval.search", kind=kind, n=len(queries)):
            eng = self.opts if opts is None else resolve_engine_opts(opts)
            # the BSS engines map cosine queries onto the unit sphere themselves
            # (mapping them here too would round them twice, and a front, which
            # feeds the engines raw rows, would differ from this call); the
            # forest walks a tree built on the normalised corpus, so its
            # queries are mapped here
            q = (self._prep(queries) if self.index_kind == "forest"
                 else np.asarray(queries, np.float32))
            if kind == "range":
                if t is None:
                    raise ValueError("range search needs t= (a metric distance)")
                t0 = now()
                if self.index_kind == "forest":
                    hits, s = forest_range_search(
                        self.index, q, float(t), self.forest_mechanism, opts=eng,
                    )
                else:
                    hits, s = flat_index.bss_query_batched(
                        self.index, q, float(t), opts=eng,
                    )
                self._account(len(q), s, t0)
                return SearchResult(
                    kind="range", hits=hits, stats=s,
                    generation=int(s.get("generation", 0)),
                )
            if kind == "knn":
                if k is None or int(k) <= 0:
                    raise ValueError(f"knn search needs a positive k, got {k}")
                if self.index_kind == "forest":
                    raise NotImplementedError(FOREST_KNN_ERROR)
                t0 = now()
                idx, dists, s = flat_index.bss_knn_batched(
                    self.index, q, int(k), r0=r0, max_rounds=max_rounds,
                    opts=eng,
                )
                self._account(len(q), s, t0)
                return SearchResult(
                    kind="knn", indices=idx, distances=dists, stats=s,
                    generation=int(s.get("generation", 0)),
                )
            raise ValueError(f"kind must be range|knn, got {kind!r}")

    def range_query(self, user_embeddings: np.ndarray, min_score: float):
        """All items with dot-score >= min_score — exact, one fused pass.
        Cosine (dot-product) serving only; other metrics threshold on
        distance, use ``range_by_distance``.

        Compatibility delegate: prefer
        ``search(q, "range", t=score_to_distance(min_score))``."""
        if self.metric != "cosine":
            raise ValueError(
                f"min-score retrieval is the cosine specialisation; the "
                f"{self.metric!r} server thresholds on distance — use "
                f"range_by_distance"
            )
        t = float(score_to_distance(np.asarray(min_score)))
        return self.range_by_distance(user_embeddings, t)

    def range_by_distance(self, user_embeddings: np.ndarray, t: float):
        """All items within metric distance t — exact, one batched pass
        (the BSS masked scan or the forest walk, per ``index=``).

        Compatibility delegate: prefer ``search(q, "range", t=t)``, which
        also returns the engine stats and index generation."""
        return self.search(user_embeddings, "range", t=t).hits

    def top_k(self, user_embeddings: np.ndarray, k: int,
              t0_guess: float | None = None, max_rounds: int = 8):
        """Exact top-k via the batched radius-deepening engine: every round
        is one pass over ALL pending queries, each query's
        kth-nearest-so-far distance tightening its pruning radius (see
        ``bss_knn_batched``).  ``t0_guess`` optionally seeds the radius
        (None = the engine's per-query scale-free estimate).

        Compatibility delegate: prefer ``search(q, "knn", k=k)``, whose
        result also carries the per-query distances, the engine stats and
        the index generation."""
        res = self.search(
            user_embeddings, "knn", k=k, r0=t0_guess, max_rounds=max_rounds,
        )
        return [res.indices[i] for i in range(res.indices.shape[0])]

    # ------------------------------------------------------------ mutations

    def _mutate(self, fn):
        if self.index_kind != "bss":
            raise NotImplementedError(FOREST_IMMUTABLE)
        t0 = now()
        new_index, mstats = fn(self.index)
        self.index = new_index
        if mstats is not None:
            fold_mutation(self.metrics, mstats, seconds=now() - t0)
        return mstats

    def append(self, embeddings: np.ndarray):
        """Add rows to the served corpus (fresh blocks against the existing
        pivot tables — no rebuild; see ``repro_torch.index.maintain.append``).
        ``self.corpus`` extends with the SAME engine-space rows the index
        ingests (cosine pre-normalises exactly as ``__init__`` does), so
        dot-product scoring and ``top_k_oracle`` stay aligned.  Returns the
        mutation's ``MutationStats``."""
        rows = np.array(embeddings, np.float32, copy=True)
        if self.metric == "cosine":
            rows = flat_index._engine_queries("cosine", rows)

        def run(idx):
            out = index_maintain.append(idx, rows)
            # corpus mirror only grows once the mutation validated
            self.corpus = np.concatenate([self.corpus, rows])
            self._live = np.concatenate(
                [self._live, np.ones(len(rows), dtype=bool)]
            )
            return out

        return self._mutate(run)

    def delete(self, ids):
        """Tombstone corpus ids (they stop matching immediately; storage is
        reclaimed by ``compact``).  ``top_k_oracle`` honours the same live
        mask.  Returns the mutation's ``MutationStats``."""

        def run(idx):
            out = index_maintain.delete(idx, ids)
            self._live[np.asarray(list(ids), dtype=np.int64)] = False
            return out

        return self._mutate(run)

    def compact(self, *, refresh_pivots: bool = True):
        """Re-permute live rows into dense blocks (drops tombstones;
        ``refresh_pivots=True`` rebuilds pivot tables — bit-identical to a
        fresh build over the live rows).  Corpus ids are stable across
        compaction.  Returns the mutation's ``MutationStats``."""
        return self._mutate(
            lambda idx: index_maintain.compact(
                idx, refresh_pivots=refresh_pivots
            )
        )

    def maybe_compact(self, **kw):
        """Compact only when degraded — thresholds and the pivot-refresh
        policy pass through to ``repro_torch.index.maintain.maybe_compact``.
        Returns the ``MutationStats`` when a compaction ran, else None."""
        return self._mutate(
            lambda idx: index_maintain.maybe_compact(idx, **kw)
        )

    def async_front(self, **kw):
        """An :class:`~repro_torch.serve.front.ServingFront` over this
        server's index: per-request ``submit(...) -> Future`` with deadline
        micro-batching in front of the same engines.  Thresholds are metric
        DISTANCES (the engine space — use ``score_to_distance`` for the
        cosine/min-score specialisation).  Keyword args pass through to
        ``ServingFront``; the caller owns the front's lifecycle (``with
        server.async_front() as front: ...``).  The front snapshots
        ``self.index`` at construction: mutate a LIVE front through its own
        ``append``/``delete``/``compact`` methods (server-side mutations
        after this call don't reach an already-built front)."""
        from repro_torch.serve.front import ServingFront

        if self.index_kind == "forest":
            kw.setdefault("mechanism", self.forest_mechanism)
            if self.metric == "cosine":
                # the tree was built on the normalised corpus under the l2
                # engine metric, so raw queries need the same mapping
                kw.setdefault("prep", self._prep)
        if "opts" not in kw:
            # inherit the server's engine knobs, but let the front keep its
            # own "dense" realisation default (bucket-ladder contract);
            # an explicit opts= hands full control to the caller
            kw["opts"] = dataclasses.replace(self.opts, realisation="dense")
        return ServingFront(self.index, **kw)

    def top_k_oracle(self, user_embeddings: np.ndarray, k: int) -> list:
        """Brute-force reference (numpy float64) — for tests/benchmarks.
        Chunked over queries: the probability-space metrics broadcast a
        (Q, N, dim) float64 intermediate, which must stay bounded."""
        q = self._prep(user_embeddings)
        dead = ~self._live
        out = []
        for lo in range(0, len(q), 32):
            d = pairwise_np(self.metric, q[lo:lo + 32], self.corpus)
            # tombstoned rows are out of the corpus for the oracle too
            d[:, dead] = np.inf
            out.extend(np.argsort(d[i])[:k] for i in range(d.shape[0]))
        return out
