"""Blocked Supermetric Scan (BSS) — the port of ``repro.core.flat_index``:
fp32 and bf16 range search and kNN for every four-point metric, with the l2,
JSD and Triangular kernels (and cosine, served as l2 on the unit sphere) on
the H100.

build:  ``build_bss`` is the reference's host numpy build, carried over as
        is (FFT pivots, the widest pivot-pair planes, a median-split
        permutation packed into blocks, one bounding box per block and
        plane), so the layout is bit-identical to the JAX package's.  The
        index keeps its arrays on the host and mirrors them once onto its
        torch device (``index.device``).

query:  ``bss_query_batched`` runs one pass per batch on the device:
        query -> pivot distances, the planar lower bound per (query,
        block), tile survival per (query tile, block), and exact distances
        only in the surviving cells.  The hit test, the hits' ends per
        query and the paper's stats are reduced on the device, and one read
        brings them and the hits' positions to the host
        (``_range_epilogue``).
        With ``backend="cuda"`` the three steps are the hand-written
        kernels; with ``"torch"`` the same math in plain torch ops, whose
        exact phase follows ``realisation`` as the reference's jnp backend
        does: "adaptive" gathers only the alive (query, block) cells when
        they are at most ``_DENSE_ALIVE_FRAC`` of all, else runs one dense
        pass; "dense" always runs the dense pass.

knn:    ``bss_knn_batched`` runs the same pieces as radius-deepening rounds
        with a stable top-k, driven by the reference's host radius
        schedule step for step (``realisation`` as for range search).

bf16:   ``precision="bf16"`` streams the index's bfloat16 corpus mirror
        (``device_bf16``) through the exact phase and re-checks the
        boundary band ``|d16 - t| <= eps`` (range) or ``d16 <= kth16 +
        2 eps`` (kNN) against the fp32 corpus, over only the tiles that hold
        a band point; ``eps`` is ``repro_torch.core.precision``'s margin.
        Hits, kNN results and per-query distance counts are bit-identical
        to the fp32 path of the same backend.

``bss_query`` is the reference's numpy oracle (float64 exact phase), kept
as the correctness check both backends are held to.

mesh:   ``build_bss(mesh=...)`` (a ``repro_torch.parallel.ShardMesh``)
        partitions the blocks over the mesh's devices: the batched paths
        and ``bss_lower_bounds`` of such an index serve through the sharded
        engine (``repro_torch.parallel.shard_index``), with the
        single-device results bit for bit.  They never build the unsharded
        mirror; ``index.device`` builds it on the mesh's lead device only
        when a caller reads it.

Device rule: ``build_bss(device=None)`` builds for the CUDA device and
raises when there is none; the CPU is used only when the caller asks for
it.  The living corpus (append, delete, compact) is ``repro_torch.index``.
Power transforms keep the reference's rule: with no tile kernel their
distances run as plain pairwise on either backend.

Spans: while a ``torch.profiler`` session records, the single-device
engine marks its phases with ``repro_torch.obs.record`` spans
(``bss.range.bound``, ``.exact``, ``.copy``, ``.assemble``, ``.stats``;
``bss.knn.bound``, ``.copy``, ``.sort``, ``.round`` with ``.exact``,
``.top_k``, ``.copy``, ``.schedule``) and counts its reads to the host
(``to_host``).  On a card, the range bound phase and the fused pass's
exact phase (``_query_batched``, ``_query_batched_bf16``) and the kNN
rounds' ``.top_k`` also carry a CUDA event pair: their device ms.  With no
profiler recording they cost one flag check each and record nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import projection
from repro_torch.core.backends import (
    EngineOpts,
    resolve_backend,
    resolve_engine_opts,
    tile_survival,
)
from repro_torch.core.distances import Metric, check_ieee_fp32, get_metric, row_dot
from repro_torch.core.npdist import pairwise_np
from repro_torch.core.precision import bf16_margin, bf16_round_np
from repro_torch.core.refpoints import select_fft
from repro_torch.kernels.pairwise_dist import (
    KERNEL_METRICS,
    masked_pairwise_kernel_call,
    pairwise_kernel_call,
)
from repro_torch.kernels.planar_exclusion import planar_lower_bound_pairs_kernel_call
from repro_torch.kernels.tiles import TILE_BQ
from repro_torch.obs import schema as obs_schema
from repro_torch.obs.record import span, to_host

__all__ = [
    "BSSIndex",
    "build_bss",
    "index_from_arrays",
    "bss_query",
    "bss_query_batched",
    "bss_knn_batched",
    "bss_lower_bounds",
    "resolve_device",
]

_DEFAULT_BQ = TILE_BQ

# normalisation floor of the cosine -> l2 mapping (the cosine metric's own)
_MIN_NORM = 1e-12

# the fields ``index_from_arrays`` takes, as the reference BSSIndex names them
INDEX_FIELDS = (
    "metric_name", "data", "perm", "valid", "pivots", "pairs", "deltas",
    "boxes", "block", "seed", "generation", "next_id", "tombstones",
)


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device and raises when there is none (no silent CPU fallback)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass "
                "device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _engine_metric(metric_name: str) -> str:
    """The metric the engine computes with: supermetric cosine IS l2 on the
    unit sphere, so cosine rides the l2 path."""
    return "l2" if metric_name == "cosine" else metric_name


def _engine_queries(metric_name: str, queries: np.ndarray) -> np.ndarray:
    """Queries in the engine's space (unit sphere for cosine)."""
    if metric_name == "cosine":
        norms = np.linalg.norm(queries, axis=-1, keepdims=True)
        queries = queries / np.maximum(norms, _MIN_NORM)
    return np.asarray(queries, np.float32)


class BSSDeviceArrays(NamedTuple):
    """Device mirror of the index, built once per index."""

    data: torch.Tensor    # (n_pad, dim) float32
    pivots: torch.Tensor  # (P, dim) float32
    pairs: torch.Tensor   # (M, 2) int64 (torch gathers take long indices)
    deltas: torch.Tensor  # (M,) float32
    boxes: torch.Tensor   # (n_blocks, M, 4) float32
    valid: torch.Tensor   # (n_pad,) bool


@dataclasses.dataclass
class BSSIndex:
    metric_name: str
    data: np.ndarray          # (n_pad, dim) permuted + padded
    perm: np.ndarray          # (n_pad,) original index, -1 for padding
    valid: np.ndarray         # (n_pad,) bool
    pivots: np.ndarray        # (P, dim)
    pairs: np.ndarray         # (M, 2) pivot indices per plane
    deltas: np.ndarray        # (M,)
    boxes: np.ndarray         # (n_blocks, M, 4) = x_lo, x_hi, y_lo, y_hi
    block: int
    seed: int = 0
    generation: int = 0
    next_id: int = 0
    tombstones: int = 0
    # where the device mirror lives; None resolves to the CUDA device (to
    # the mesh's lead device for a mesh-built index)
    torch_device: torch.device | None = dataclasses.field(
        default=None, compare=False
    )
    # a ShardMesh: the batched paths then serve through the sharded engine
    mesh: object | None = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _device: BSSDeviceArrays | None = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _sharded: object | None = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # bf16 exact-phase mirror (lazy): the corpus rounded to bfloat16, and
    # the comparison margin measured on those very bits.  Pivots, deltas and
    # boxes stay fp32, so survival sets and distance counts are the fp32
    # engine's.  ``repro_torch.index`` keeps both across mutations.
    _bf16: torch.Tensor | None = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _bf16_eps: float | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def __post_init__(self):
        self.torch_device = _mesh_device(self.mesh, self.torch_device)

    @property
    def n_blocks(self) -> int:
        return self.boxes.shape[0]

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())

    @property
    def tombstone_frac(self) -> float:
        """Deleted fraction of the rows the layout still carries — the
        compaction trigger (``repro_torch.index.maybe_compact``)."""
        return self.tombstones / max(self.tombstones + self.n_valid, 1)

    @property
    def metric(self) -> Metric:
        return get_metric(self.metric_name)

    @property
    def device(self) -> BSSDeviceArrays:
        """The index's arrays on ``torch_device``, copied once.  Every pivot
        pair is checked here to lie in [0, P): the planar kernel reads
        ``dqp[q, pairs[m, i]]`` unchecked.  For a mesh-built index this is
        an unsharded copy on the lead device, built only when a caller
        reads it: the engines read ``sharded()``."""
        if self._device is None:
            n_pivots = self.pivots.shape[0]
            if ((self.pairs < 0) | (self.pairs >= n_pivots)).any():
                raise ValueError(f"pivot pairs must index the {n_pivots} pivots")
            dev = self.torch_device
            self._device = BSSDeviceArrays(
                data=torch.as_tensor(self.data, dtype=torch.float32, device=dev),
                pivots=torch.as_tensor(self.pivots, dtype=torch.float32, device=dev),
                pairs=torch.as_tensor(self.pairs, dtype=torch.int64, device=dev),
                deltas=torch.as_tensor(self.deltas, dtype=torch.float32, device=dev),
                boxes=torch.as_tensor(self.boxes, dtype=torch.float32, device=dev),
                valid=torch.as_tensor(self.valid, dtype=torch.bool, device=dev),
            )
        return self._device

    @property
    def device_bf16(self) -> torch.Tensor:
        """(n_pad, dim) bfloat16 corpus mirror on ``torch_device``, built
        once.  The rounding happens on the host (``bf16_round_np``), so the
        mirror holds exactly the bits ``bf16_margin`` measured; the device
        cast of those bf16-representable float32 values is exact."""
        if self._bf16 is None:
            self._bf16 = torch.as_tensor(
                bf16_round_np(self.data), device=self.torch_device
            ).to(torch.bfloat16)
        return self._bf16

    def bf16_margin(self) -> float:
        """Threshold margin of the bf16 phase (``repro_torch.core.
        precision``), measured in the ENGINE metric over the engine-space
        valid rows, once per index."""
        if self._bf16_eps is None:
            self._bf16_eps = bf16_margin(
                _engine_metric(self.metric_name), self.data, self.valid
            )
        return self._bf16_eps

    def sharded(self, mesh=None):
        """The :class:`~repro_torch.parallel.shard_index.ShardedBSSIndex` view
        of this index over ``mesh`` (default: the mesh given at build time),
        cached per mesh."""
        mesh = mesh if mesh is not None else self.mesh
        if mesh is None:
            raise ValueError(
                "no mesh: pass one here or build with build_bss(mesh=...)"
            )
        if self._sharded is None or self._sharded.mesh != mesh:
            from repro_torch.parallel.shard_index import ShardedBSSIndex

            self._sharded = ShardedBSSIndex(self, mesh)
        return self._sharded


def _mesh_device(mesh, device) -> torch.device:
    """The index's device: ``device`` (``resolve_device``), or with a mesh
    its lead device, which a ``device`` given too must be."""
    if mesh is None:
        return resolve_device(device)
    from repro_torch.parallel.sharding import check_mesh

    check_mesh(mesh)
    if device is not None and _indexed(device) != _indexed(mesh.lead):
        raise ValueError(f"device {device} is not the mesh's lead device {mesh.lead}")
    return mesh.lead


def _indexed(device) -> torch.device:
    """``device`` with the current CUDA device's index where it names none
    ("cuda" is "cuda:0" on a one-card host)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


# ---------------------------------------------------------------------------
# Build (host numpy, the reference's code)
# ---------------------------------------------------------------------------


def _project_all(dp: np.ndarray, pairs: np.ndarray, deltas: np.ndarray):
    """dp: (n, P) pivot distances -> (n, M) x and (n, M) y planar coords,
    through the same projection body as the query side."""
    return projection.project(
        dp[:, pairs[:, 0]], dp[:, pairs[:, 1]], deltas[None, :], xp=np
    )


def _split_perm(feats: np.ndarray, block: int) -> np.ndarray:
    """Locality-preserving permutation of ``len(feats)`` rows: recursive
    max-variance median split of the margin space down to block-sized
    leaves."""
    out: list[np.ndarray] = []

    def split(idx: np.ndarray):
        if len(idx) <= block:
            out.append(idx)
            return
        sub = feats[idx]
        dimm = int(np.argmax(sub.var(axis=0)))
        order = np.argsort(sub[:, dimm], kind="stable")
        half = len(idx) // 2
        split(idx[order[:half]])
        split(idx[order[half:]])

    split(np.arange(len(feats), dtype=np.int64))
    return np.concatenate(out)


def _pack_blocks(
    data_rows: np.ndarray, x: np.ndarray, y: np.ndarray, block: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad permuted engine-space rows to whole blocks and compute the per
    (block x plane) bounding boxes.  Returns ``(data_pad, valid, boxes)``."""
    n, m = x.shape
    n_blocks = math.ceil(n / block)
    pad = n_blocks * block - n
    valid = np.concatenate(
        [np.ones(n, dtype=bool), np.zeros(pad, dtype=bool)]
    )
    data_pad = np.concatenate(
        [data_rows, np.zeros((pad, data_rows.shape[1]), np.float32)]
    )
    xs = np.concatenate([x, np.zeros((pad, m), np.float32)])
    ys = np.concatenate([y, np.zeros((pad, m), np.float32)])
    xs = xs.reshape(n_blocks, block, m)
    ys = ys.reshape(n_blocks, block, m)
    vmask = valid.reshape(n_blocks, block, 1)
    big = np.float32(3.4e38)
    boxes = np.stack(
        [
            np.where(vmask, xs, big).min(axis=1),
            np.where(vmask, xs, -big).max(axis=1),
            np.where(vmask, ys, big).min(axis=1),
            np.where(vmask, ys, -big).max(axis=1),
        ],
        axis=-1,
    ).astype(np.float32)  # (n_blocks, M, 4)
    return data_pad, valid, boxes


def build_bss(
    metric_name: str,
    data: np.ndarray,
    n_pivots: int = 16,
    n_pairs: int = 24,
    block: int = 128,
    seed: int = 0,
    *,
    device=None,
    mesh=None,
) -> BSSIndex:
    """Build the blocked index (module docstring) for ``device`` (default:
    the CUDA device; raises without one unless ``device="cpu"``).  With
    ``mesh`` (a ``ShardMesh``) the index lives on the mesh's lead device
    and the batched paths serve through the sharded engine; the host
    arrays and the numpy oracle are unaffected."""
    device = _mesh_device(mesh, device)
    metric = get_metric(metric_name)  # validates; registers power names
    if not metric.four_point:
        raise ValueError(
            f"{metric_name!r} lacks the four-point property — planar "
            f"exclusion would be unsound.  Use a supermetric, or its "
            f"power transform (e.g. {metric_name}^0.5, paper §2.2)."
        )
    data = np.asarray(data, np.float32)
    if metric_name == "cosine":
        # corpus onto the unit sphere once: cosine distance IS l2 there
        norms = np.linalg.norm(data, axis=1, keepdims=True)
        data = data / np.maximum(norms, _MIN_NORM)
    index = _build_engine_index(
        metric_name, data, n_pivots=n_pivots, n_pairs=n_pairs, block=block,
        seed=seed, device=device,
    )
    index.mesh = mesh
    return index


def _build_engine_index(
    metric_name: str,
    data: np.ndarray,
    *,
    n_pivots: int,
    n_pairs: int,
    block: int,
    seed: int,
    device: torch.device,
) -> BSSIndex:
    """``build_bss`` body over engine-space rows (float32, on the unit
    sphere for cosine)."""
    rng = np.random.default_rng(seed)
    build_metric = _engine_metric(metric_name)
    n = data.shape[0]
    piv_idx = select_fft(build_metric, data, n_pivots, rng)
    pivots = data[piv_idx]

    # all pivot pairs, keep the M most separated (wide baselines give the
    # best-conditioned planes)
    pd = pairwise_np(build_metric, pivots, pivots)
    cand = [(pd[i, j], i, j) for i in range(n_pivots) for j in range(i + 1, n_pivots)]
    cand.sort(reverse=True)
    m = min(n_pairs, len(cand))
    pairs = np.array([[i, j] for _, i, j in cand[:m]], dtype=np.int32)
    deltas = np.array([d for d, _, _ in cand[:m]], dtype=np.float32)

    dp = pairwise_np(build_metric, data, pivots).astype(np.float32)  # (n, P)
    x, y = _project_all(dp, pairs, deltas)  # (n, M) each
    feats = np.concatenate([x, y], axis=1)  # (n, 2M) margin space

    perm = _split_perm(feats, block)
    dsorted, valid, boxes = _pack_blocks(data[perm], x[perm], y[perm], block)
    pad = valid.shape[0] - n
    perm_pad = np.concatenate([perm, np.full(pad, -1, dtype=np.int64)])

    return BSSIndex(
        metric_name=metric_name,
        data=dsorted,
        perm=perm_pad,
        valid=valid,
        pivots=np.asarray(pivots, np.float32),
        pairs=pairs,
        deltas=deltas,
        boxes=boxes,
        block=block,
        seed=seed,
        next_id=n,
        torch_device=device,
    )


def index_from_arrays(fields: dict, *, device=None, mesh=None) -> BSSIndex:
    """A ``BSSIndex`` from the reference index's fields as numpy arrays and
    ints (``INDEX_FIELDS``) — the port queries the very index the JAX
    package built.  ``device`` and ``mesh`` as in ``build_bss``."""
    missing = [f for f in INDEX_FIELDS if f not in fields]
    if missing:
        raise KeyError(f"index fields missing: {missing}")
    return BSSIndex(
        metric_name=str(fields["metric_name"]),
        data=np.asarray(fields["data"], np.float32),
        perm=np.asarray(fields["perm"], np.int64),
        valid=np.asarray(fields["valid"], bool),
        pivots=np.asarray(fields["pivots"], np.float32),
        pairs=np.asarray(fields["pairs"], np.int32),
        deltas=np.asarray(fields["deltas"], np.float32),
        boxes=np.asarray(fields["boxes"], np.float32),
        block=int(fields["block"]),
        seed=int(fields["seed"]),
        generation=int(fields["generation"]),
        next_id=int(fields["next_id"]),
        tombstones=int(fields["tombstones"]),
        torch_device=_mesh_device(mesh, device),
        mesh=mesh,
    )


# ---------------------------------------------------------------------------
# Lower bounds, the numpy oracle and the distance accounting
# ---------------------------------------------------------------------------


def bss_lower_bounds(index: BSSIndex, queries: np.ndarray) -> np.ndarray:
    """(Q, n_blocks) planar lower bounds, in plain torch on the index's
    device (the reference computes them with its jnp backend); shard by
    shard for a mesh-built index."""
    if index.mesh is not None:
        from repro_torch.parallel.shard_index import sharded_lower_bounds

        return sharded_lower_bounds(index.sharded(), queries)
    queries = _engine_queries(index.metric_name, np.asarray(queries, np.float32))
    dev = index.device
    lb = _fused_lower_bounds(
        _engine_metric(index.metric_name),
        torch.as_tensor(queries, device=index.torch_device),
        dev.pivots, dev.pairs, dev.deltas, dev.boxes,
        backend="torch",
    )
    return lb.cpu().numpy()


def _valid_per_block(index: BSSIndex) -> np.ndarray:
    """(n_blocks,) number of REAL corpus points per block."""
    return index.valid.reshape(index.n_blocks, index.block).sum(axis=1)


def _exact_counts(index: BSSIndex, alive: np.ndarray) -> np.ndarray:
    """(Q,) exact distance evaluations implied by a (Q, n_blocks) survival
    matrix — per-block VALID counts, padding never counted."""
    return alive.astype(np.int64) @ _valid_per_block(index)


def _per_query_t(t, nq: int) -> np.ndarray:
    """Range thresholds as a (Q,) float32 vector: a scalar broadcasts; a
    vector carries per-query radii (a negative radius — the serving
    front's padding rows — survives no block and hits nothing)."""
    t_arr = np.asarray(t, np.float32)
    if t_arr.ndim == 0:
        return np.full(nq, float(t_arr), np.float32)
    if t_arr.shape != (nq,):
        raise ValueError(
            f"per-query t must have shape ({nq},), got {t_arr.shape}"
        )
    return t_arr


def bss_query(
    index: BSSIndex, queries: np.ndarray, t
) -> tuple[list[list[int]], dict]:
    """Exact range search — the NUMPY ORACLE: the shared lower bound, then
    a float64 exact phase per surviving block.  ``t`` is a scalar or a (Q,)
    vector.  Returns per-query hit lists (original indices) and stats."""
    queries = np.asarray(queries, np.float32)
    nq = queries.shape[0]
    t_vec = _per_query_t(t, nq)
    lb = bss_lower_bounds(index, queries)  # (Q, B)
    alive = lb <= t_vec[:, None]
    results: list[list[int]] = [[] for _ in range(nq)]
    bsz = index.block
    data = index.data
    for b in np.nonzero(alive.any(axis=0))[0]:
        qrows = np.nonzero(alive[:, b])[0]
        blk = data[b * bsz : (b + 1) * bsz]
        d = pairwise_np(index.metric_name, queries[qrows], blk)
        hits = d <= t_vec[qrows][:, None]
        for r, qi in enumerate(qrows):
            for off in np.nonzero(hits[r])[0]:
                orig = index.perm[b * bsz + off]
                if orig >= 0:
                    results[int(qi)].append(int(orig))
    n_pivots = index.pivots.shape[0]
    exact = _exact_counts(index, alive)
    stats = {
        "pivot_dists_per_query": float(n_pivots),
        "exact_dists_per_query": float(exact.mean()),
        "dists_per_query": float(n_pivots + exact.mean()),
        "per_query_dists": n_pivots + exact,
        "block_exclusion_rate": float(1.0 - alive.mean()),
        "n_blocks": int(index.n_blocks),
        "generation": int(index.generation),
    }
    return results, stats


# ---------------------------------------------------------------------------
# Batched engine
# ---------------------------------------------------------------------------


def _fused_lower_bounds(
    metric_name: str,
    queries: torch.Tensor,
    dev_pivots: torch.Tensor,
    dev_pairs: torch.Tensor,
    dev_deltas: torch.Tensor,
    dev_boxes: torch.Tensor,
    *,
    backend: str,
) -> torch.Tensor:
    """(Q, B) planar lower bounds through the kernels (``"cuda"``) or plain
    torch.  ``metric_name`` is the ENGINE metric; metrics without a tile
    kernel compute their query -> pivot distances as plain pairwise."""
    if backend == "cuda" and metric_name in KERNEL_METRICS:
        dqp = pairwise_kernel_call(metric_name, queries, dev_pivots)
    else:
        dqp = get_metric(metric_name).pairwise(queries, dev_pivots)  # (Q, P)
    if backend == "cuda":  # the kernel reads each plane's two columns itself
        return planar_lower_bound_pairs_kernel_call(dqp, dev_pairs, dev_deltas, dev_boxes)
    d1 = torch.index_select(dqp, 1, dev_pairs[:, 0])
    d2 = torch.index_select(dqp, 1, dev_pairs[:, 1])
    qx, qy = projection.project(d1, d2, dev_deltas[None, :])  # (Q, M)
    # (Q, 1, M) vs boxes (1, B, M, 4) -> per-plane bound, max over planes
    lb = projection.point_to_box(qx[:, None, :], qy[:, None, :], dev_boxes[None])
    return torch.amax(lb, dim=-1)  # (Q, B)


def _masked_exact_dists(
    metric_name: str,
    queries: torch.Tensor,
    dev_data: torch.Tensor,
    dev_valid: torch.Tensor,
    tile_mask: torch.Tensor,
    *,
    backend: str,
    block: int,
    bq: int,
) -> torch.Tensor:
    """(Q, n_pad) exact distances for surviving (query-tile x block) cells;
    +inf wherever the mask or padding excluded.  On the cuda backend dead
    tiles are never computed; the plain branch computes every distance and
    masks (the reference's jnp semantics)."""
    if backend == "cuda" and metric_name in KERNEL_METRICS:
        dist = masked_pairwise_kernel_call(
            metric_name, queries, dev_data, tile_mask, bm=bq, bn=block,
        )
    else:
        dense = get_metric(metric_name).pairwise(queries, dev_data)  # (Q, n_pad)
        mrep = tile_mask.repeat_interleave(bq, dim=0)[: queries.shape[0]]
        mrep = mrep.repeat_interleave(block, dim=1)[:, : dev_data.shape[0]]
        dist = torch.where(mrep, dense, torch.inf)
    # in place: ``dist`` is this call's own fresh tensor in both branches
    return dist.masked_fill_(~dev_valid[None, :], torch.inf)


# Above this alive-cell share the "torch" backend's adaptive realisation
# runs the dense exact phase; below it, only the surviving (query, block)
# cells are gathered (the reference's threshold; either branch is exact).
_DENSE_ALIVE_FRAC = 0.08

# cells a gathered batch evaluates at once: every cell goes through a batch
# of this one shape (the last is padded), so a cell's distances do not
# depend on how many cells were gathered with it -- the bf16 re-check
# gathers fewer cells than the fp32 pass whose bits it must reproduce
_CELL_CHUNK = 256


def _next_pow2(x: int, lo: int = 16) -> int:
    return max(lo, 1 << (max(x, 1) - 1).bit_length())


def _padded_cells(qidx: np.ndarray, bidx: np.ndarray, device):
    """Host cell lists padded to ``_next_pow2`` cells (the reference's
    shapes), as device tensors: (qidx, bidx, cell_valid)."""
    c = len(qidx)
    c_pad = _next_pow2(c)

    def padded(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.pad(a, (0, c_pad - c)), dtype=torch.int64, device=device)

    return padded(qidx), padded(bidx), torch.arange(c_pad, device=device) < c


def _gather_cell_dists(
    metric_name: str,
    queries: torch.Tensor,
    data: torch.Tensor,
    valid: torch.Tensor,
    qidx: torch.Tensor,
    bidx: torch.Tensor,
    block: int,
):
    """The metric over the C gathered (query, block) cells only: (d (C,
    block), pvalid (C, block)) — the cell-gather distance block of the
    sparse range and kNN realisations.  ``data`` may be the bf16 mirror:
    each metric upcasts on entry."""
    dim = data.shape[-1]
    blocks = data.reshape(-1, block, dim)
    pairwise = get_metric(metric_name).pairwise
    per_cell = torch.func.vmap(lambda a, b: pairwise(a[None], b)[0])
    c = qidx.shape[0]
    d = torch.empty((c, block), dtype=torch.float32, device=data.device)
    for s in range(0, c, _CELL_CHUNK):
        q_chunk = qidx[s:s + _CELL_CHUNK]
        b_chunk = bidx[s:s + _CELL_CHUNK]
        n = q_chunk.shape[0]
        if n < _CELL_CHUNK:  # the one shape every cell is evaluated in
            q_chunk = torch.cat([q_chunk, q_chunk.new_zeros(_CELL_CHUNK - n)])
            b_chunk = torch.cat([b_chunk, b_chunk.new_zeros(_CELL_CHUNK - n)])
        d[s:s + n] = per_cell(queries[q_chunk], blocks[b_chunk])[:n]
    pvalid = valid.reshape(-1, block)[bidx]
    return d, pvalid


def _cells_exact(
    metric_name: str,
    queries: torch.Tensor,
    data: torch.Tensor,
    valid: torch.Tensor,
    qidx: torch.Tensor,
    bidx: torch.Tensor,
    cell_valid: torch.Tensor,
    t: torch.Tensor,
    *,
    block: int,
):
    """The exact phase over an explicit alive-cell list (the reference's
    ``_cells_exact_jit``): the (C, block) hit mask of the gathered cells,
    each against its own query's radius ``t[q]``.  The caller lists the hits
    off it (``_cell_hits``), as it reads the reference's fixed-capacity hit
    list: nothing in here waits for the host."""
    d, pvalid = _gather_cell_dists(metric_name, queries, data, valid, qidx, bidx, block)
    return (d <= t[qidx][:, None]) & pvalid & cell_valid[:, None]


def _cell_hits(hit: torch.Tensor, qidx: torch.Tensor, bidx: torch.Tensor,
               block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hit_q, hit_pos) of a (C, block) cell hit mask, on its device,
    row-major over (cell, offset) with cells sorted by (query, block), so a
    query's hits come in ascending position.  ``nonzero`` reads its size
    from the device: the copy span holds that wait."""
    with span("bss.range.copy"):
        pos = torch.nonzero(hit.reshape(-1)).squeeze(1)
    cell = pos // block
    return qidx[cell], bidx[cell] * block + pos % block


def _cells_exact_bf16(
    metric_name: str,
    queries: torch.Tensor,
    data16: torch.Tensor,
    valid: torch.Tensor,
    qidx: torch.Tensor,
    bidx: torch.Tensor,
    cell_valid: torch.Tensor,
    t: torch.Tensor,
    eps: torch.Tensor,
    *,
    block: int,
):
    """The sparse bf16 range phase (the reference's
    ``_cells_exact_bf16_jit``): the sure hits (``d16 <= t - eps``) of the
    cells that hold no band point (``t - eps < d16 <= t + eps``), the band
    flag of every cell, and the band points per query.  The caller re-checks
    the band cells through the fp32 ``_cells_exact``, whose values and hit
    masks are the fp32 realisation's.  Returns (the (C, block) sure-hit mask
    of the cells without a band point, band_cell (C,), band_counts (Q,)
    int32)."""
    d, pvalid = _gather_cell_dists(metric_name, queries, data16, valid, qidx, bidx, block)
    ok = pvalid & cell_valid[:, None]
    tq = t[qidx][:, None]
    sure = (d <= tq - eps) & ok
    band = (d <= tq + eps) & ok & ~sure
    band_cell = band.any(dim=1)
    band_counts = torch.zeros(queries.shape[0], dtype=torch.int32, device=d.device)
    band_counts.index_add_(0, qidx, band.sum(dim=1, dtype=torch.int32))
    return sure & ~band_cell[:, None], band_cell, band_counts


def _dense_hit_mask(
    metric_name: str,
    queries: torch.Tensor,
    data: torch.Tensor,
    valid: torch.Tensor,
    alive: torch.Tensor,
    t: torch.Tensor,
    *,
    block: int,
) -> torch.Tensor:
    """The dense exact pass of the "torch" backend's fp32 range search (the
    reference's ``_dense_hit_mask_jit``): the (Q, n_pad) hit mask, masked by
    each query's own surviving blocks and the valid rows.  l2 tests in the
    squared domain, ``|p|^2 - 2 q.p <= t^2 - |q|^2`` (no sqrt), with a
    negative radius sent to -inf so that it hits nothing."""
    nq = queries.shape[0]
    if metric_name == "l2":
        qf, df = queries.float(), data.float()
        check_ieee_fp32(qf)
        s = -2.0 * row_dot(qf, df) + torch.sum(df * df, dim=-1)[None, :]
        thresh = torch.where(t >= 0, t * t - torch.sum(qf * qf, dim=-1), -torch.inf)
        raw_hit = s <= thresh[:, None]
    else:
        raw_hit = get_metric(metric_name).pairwise(queries, data) <= t[:, None]
    hit = raw_hit.reshape(nq, -1, block) & alive[:, :, None] & valid.reshape(1, -1, block)
    return hit.reshape(nq, -1)


def _query_batched(
    metric_name: str,
    queries: torch.Tensor,
    t: torch.Tensor,
    dev: BSSDeviceArrays,
    *,
    block: int,
    bq: int,
    backend: str,
):
    """One fused range-search pass.  Returns (dist (Q, n_pad), alive (Q, B),
    tile_mask (Qtiles, B)).  A tile survives when ANY of its queries has
    lb <= its own t, so no true hit of any query is pruned; per-query hits
    are re-filtered by d <= t afterwards."""
    with span("bss.range.bound", device=queries.device):
        lb = _fused_lower_bounds(
            metric_name, queries, dev.pivots, dev.pairs, dev.deltas, dev.boxes,
            backend=backend,
        )  # (Q, B)
        alive = lb <= t[:, None]
        tile_mask = tile_survival(alive, bq)  # (Qtiles, B)
    with span("bss.range.exact", device=queries.device):
        dist = _masked_exact_dists(
            metric_name, queries, dev.data, dev.valid, tile_mask,
            backend=backend, block=block, bq=bq,
        )
    return dist, alive, tile_mask


def _query_batched_bf16(
    metric_name: str,
    queries: torch.Tensor,
    t: torch.Tensor,
    dev: BSSDeviceArrays,
    data16: torch.Tensor,
    eps: torch.Tensor,
    *,
    block: int,
    bq: int,
    backend: str,
):
    """One bf16 range pass with the fp32 re-check of the boundary band (the
    reference's dense ``_query_batched_bf16_jit``).

    The bound phase is the fp32 one, so ``alive`` and ``tile_mask`` are the
    fp32 pass's.  The exact phase runs over the bf16 mirror and splits each
    distance ``d16`` by the margin ``eps``:

    * ``d16 <= t - eps``: a sure hit;
    * ``t - eps < d16 <= t + eps``: the band, re-checked in fp32 over only
      the tiles that hold a band point, through the same masked kernel, so
      each re-checked value is the very value the fp32 pass computes (a
      live tile is computed alike whatever its neighbours are);
    * anything else: a sure miss.

    Returns (hit (Q, n_pad) bool, alive (Q, B), tile_mask, recheck_tiles
    (0-d), band_counts (Q,) int32)."""
    with span("bss.range.bound", device=queries.device):
        lb = _fused_lower_bounds(
            metric_name, queries, dev.pivots, dev.pairs, dev.deltas, dev.boxes,
            backend=backend,
        )
        alive = lb <= t[:, None]
        tile_mask = tile_survival(alive, bq)
    with span("bss.range.exact", device=queries.device):
        d16 = _masked_exact_dists(
            metric_name, queries, data16, dev.valid, tile_mask,
            backend=backend, block=block, bq=bq,
        )
        t_col = t[:, None]
        sure = d16 <= t_col - eps
        band = (d16 <= t_col + eps) & ~sure
        del d16  # the (Q, n_pad) block is freed before the re-check allocates its own
        band_blocks = band.reshape(queries.shape[0], -1, block).any(dim=2)
        recheck_mask = tile_survival(band_blocks, bq) & tile_mask
        d32 = _masked_exact_dists(
            metric_name, queries, dev.data, dev.valid, recheck_mask,
            backend=backend, block=block, bq=bq,
        )
        hit = sure | (band & (d32 <= t_col))
    return (
        hit, alive, tile_mask, recheck_mask.sum(),
        band.sum(dim=1, dtype=torch.int32),
    )


def _range_epilogue(
    index: BSSIndex,
    hits,
    alive: torch.Tensor,
    tile_mask: torch.Tensor,
    *,
    perm: np.ndarray,
    vpb: torch.Tensor,
    backend: str,
    eps: float | None = None,
    recheck_tiles: torch.Tensor | None = None,
    band_counts: torch.Tensor | None = None,
    extra: dict | None = None,
    engine: str = "bss",
) -> tuple[list[list[int]], dict]:
    """Everything of a range call between the exact phase and the returned
    (hit lists, stats), for every realisation, precision and the sharded
    engine.

    Where ``alive`` lives (the card, or the CPU), the paper's figure of
    merit is reduced to a few integer vectors: each query's exact
    distances (its own surviving blocks weighted by their VALID rows,
    ``vpb``) and excluded blocks, the sums of ``alive`` and ``tile_mask``,
    bf16's re-checked tiles and band points, and the ``extra`` (name ->
    (n,) integer tensor) stats keys.  They and the hits' (query, position)
    pairs come to the host in one read (``nonzero`` of a mask reads its
    size first: it cannot know it otherwise).  The host maps positions to
    original ids through ``perm``, cuts each query's list out of one flat
    list where the query column steps, and builds the stats dict from the
    sums: integer sums are exact, so every key equals the numpy reduction
    of the host masks.

    ``hits`` is the (Q, n_pad) hit mask, whose ``nonzero`` is row-major, so
    positions ascend within each query (the oracle's order), or a gathered
    pass's (hit_q, hit_pos) in that order already.  ``eps`` marks a bf16
    call."""
    nq, nb = alive.shape
    with span("bss.range.exact"):
        alive_q = alive.sum(dim=1)
        parts = {
            "exact": (alive * vpb).sum(dim=1),
            "excluded": nb - alive_q,
            "alive": alive_q.sum(),
            "tiles": tile_mask.sum(),
        }
        if eps is not None:
            parts["recheck_tiles"], parts["band"] = recheck_tiles, band_counts
        parts.update(extra or {})
        flat = [p.reshape(-1).to(torch.int64) for p in parts.values()]
    with span("bss.range.copy"):
        # the (N, 2) (query, position) pairs; nothing is launched between
        # nonzero's wait for its size and the read but the concatenation
        pairs = (torch.nonzero(hits) if isinstance(hits, torch.Tensor)
                 else torch.stack(hits, dim=1))
        buf = to_host(torch.cat(flat + [pairs.reshape(-1)]))
    *values, pairs = np.split(buf, np.cumsum([p.numel() for p in flat]))
    host = dict(zip(parts, values))
    with span("bss.range.assemble"):
        hit_q, pos = pairs.reshape(-1, 2).T
        ends = np.searchsorted(hit_q, np.arange(1, nq + 1)).tolist()
        ids = perm[pos].tolist()
        results = [ids[a:b] for a, b in zip([0] + ends[:-1], ends)]
    with span("bss.range.stats"):
        n_pivots = index.pivots.shape[0]
        exact = host["exact"]
        mean_exact = float(exact.mean()) if nq else 0.0
        # ``x.mean()`` of a bool array is its float64 sum over its size
        stats = {
            "pivot_dists_per_query": float(n_pivots),
            "exact_dists_per_query": mean_exact,
            "dists_per_query": float(n_pivots) + mean_exact,
            "per_query_dists": n_pivots + exact,
            "block_exclusion_rate": (
                float(1.0 - host["alive"][0] / alive.numel()) if alive.numel() else 1.0
            ),
            "tiles_computed": int(host["tiles"][0]),
            "tile_exclusion_rate": (
                float(1.0 - host["tiles"][0] / tile_mask.numel())
                if tile_mask.numel() else 1.0
            ),
            "n_blocks": int(index.n_blocks),
            "generation": int(index.generation),
            # every block BSS excludes is excluded by the planar four-point
            # bound — the Hilbert mechanism
            "excluded": {"hilbert": host["excluded"]},
            "precision": "fp32",
        }
        if eps is not None:
            _bf16_stats(stats, eps, int(host["recheck_tiles"][0]), host["band"])
        stats.update((name, host[name]) for name in extra or {})
        stats = _finish_stats(stats, kind="range", backend=backend, engine=engine)
    return results, stats


def _bf16_stats(stats: dict, eps: float, recheck_tiles: int,
                per_query_recheck: np.ndarray) -> dict:
    """Add the bf16 re-check telemetry to an engine stats dict.  The other
    keys (the paper's figure of merit too) are the fp32 pass's; the
    re-checked points are reported apart, never counted twice."""
    stats["precision"] = "bf16"
    stats["band_eps"] = float(eps)
    stats["recheck_tiles"] = int(recheck_tiles)
    stats["per_query_recheck"] = np.asarray(per_query_recheck, np.int64)
    stats["recheck_points_per_query"] = (
        float(stats["per_query_recheck"].mean())
        if stats["per_query_recheck"].size else 0.0
    )
    return stats


def _finish_stats(stats: dict, *, kind: str, backend: str,
                  engine: str = "bss") -> dict:
    """Stamp the shared observability schema onto an engine stats dict."""
    return obs_schema.normalise_stats(
        stats, engine=engine, kind=kind, backend=backend,
        n_queries=int(np.asarray(stats["per_query_dists"]).shape[0]),
        excluded=stats.get("excluded"),
    )


def bss_query_batched(
    index: BSSIndex,
    queries: np.ndarray,
    t,
    *,
    opts: EngineOpts | None = None,
    bq: int | None = None,
    backend: str | None = None,
    realisation: str | None = None,
    precision: str | None = None,
) -> tuple[list[list[int]], dict]:
    """Exact range search through the batched engine on the index's device.

    ``t`` is a scalar threshold or a (Q,) vector of per-query radii (a
    negative radius excludes its row from everything).  Options travel as
    ``opts=EngineOpts(...)``; the per-knob kwargs are the legacy spelling.

    Returns per-query hit lists (original ids, ascending corpus position
    within a query — the oracle's order) and the stats dict of
    ``repro_torch.obs.schema``.  Bit-equal to ``bss_query``'s hit lists
    whenever float32 and float64 agree on ``d <= t``; batches of up to 512
    queries keep the (Q, n_pad) distance block of the exact phase on the
    card (~208 MB at the paper's colors size).

    ``precision="bf16"`` runs the exact phase over the bf16 corpus mirror
    and re-checks the band in fp32 (``_query_batched_bf16``): hits and
    stats are the fp32 pass's bit for bit, and the stats gain
    ``band_eps``, ``recheck_tiles``, ``per_query_recheck`` and
    ``recheck_points_per_query``.

    ``realisation`` picks the ``"torch"`` backend's exact phase, as it
    picks the reference's jnp one: with ``"adaptive"`` (the default) a
    batch whose alive (query, block) cells are at most
    ``_DENSE_ALIVE_FRAC`` of all evaluates only those cells
    (``_query_cells``; bf16: the sure hits of the cells without a band
    point, the band cells re-checked in fp32, ``recheck_tiles`` 0), and
    any other batch runs the dense pass: fp32 one hit mask over the whole
    block (``_dense_hit_mask``), bf16 the masked scheme above.  ``"dense"``
    always runs the dense pass.  Either is exact; hits and stats are the
    same.  ``"cuda"`` runs the masked kernel whatever ``realisation``
    says, as the reference's Pallas backend does.

    A mesh-built index serves through the sharded engine
    (``sharded_query_batched``: one pass per shard, the hit masks
    concatenated in corpus order), with the same results and stats bit for
    bit and ``n_shards``, ``shard_dists`` and ``shard_blocks`` added."""
    opts = resolve_engine_opts(
        opts, bq=bq, backend=backend, realisation=realisation,
        precision=precision,
    )
    if index.mesh is not None:
        from repro_torch.parallel.shard_index import sharded_query_batched

        return sharded_query_batched(index.sharded(), queries, t, opts=opts)
    precision = opts.precision
    bq = opts.bq if opts.bq is not None else _DEFAULT_BQ
    backend = resolve_backend(opts.backend, index.torch_device)
    metric_eng = _engine_metric(index.metric_name)
    queries = _engine_queries(index.metric_name, np.asarray(queries, np.float32))
    nq = queries.shape[0]
    eps = index.bf16_margin() if precision == "bf16" else None
    if nq == 0:  # nothing for the device: the epilogue over empty host tensors
        none = torch.zeros(0, dtype=torch.int64)
        empty = torch.zeros((0, index.n_blocks), dtype=torch.bool)
        vpb = torch.from_numpy(index.valid).reshape(index.n_blocks, index.block).sum(dim=1)
        return _range_epilogue(
            index, (none, none), empty, empty, perm=index.perm, vpb=vpb, backend=backend,
            eps=eps, recheck_tiles=none.sum(), band_counts=none,
        )
    t_vec = _per_query_t(t, nq)
    dev = index.device
    t_dev = torch.as_tensor(t_vec, device=index.torch_device)
    q_dev = torch.as_tensor(queries, device=index.torch_device)
    recheck_tiles = band_counts = None
    sparse = False
    if backend == "torch" and (precision == "fp32" or opts.realisation != "dense"):
        # the reference's jnp branch: the bound phase first, then the
        # realisation by the alive share, which reads only the fp32 bounds,
        # so both precisions take the same branch
        with span("bss.range.bound", device=q_dev.device):
            lb = _fused_lower_bounds(
                metric_eng, q_dev, dev.pivots, dev.pairs, dev.deltas, dev.boxes,
                backend=backend,
            )
            alive = lb <= t_dev[:, None]
        if opts.realisation != "dense":
            with span("bss.range.copy"):
                alive_np = to_host(alive)
            sparse = alive_np.mean() <= _DENSE_ALIVE_FRAC
    if sparse:
        with span("bss.range.exact"):
            hits, band_counts = _query_cells(index, metric_eng, q_dev, t_dev, alive_np, eps)
            tile_mask = tile_survival(alive, bq)
            recheck_tiles = alive.new_zeros((), dtype=torch.int64)
    elif precision == "bf16":  # the bound and exact spans are inside
        hits, alive, tile_mask, recheck_tiles, band_counts = _query_batched_bf16(
            metric_eng, q_dev, t_dev, dev, index.device_bf16,
            torch.tensor(eps, dtype=torch.float32, device=index.torch_device),
            block=index.block, bq=bq, backend=backend,
        )
    elif backend == "torch":
        with span("bss.range.exact"):
            hits = _dense_hit_mask(metric_eng, q_dev, dev.data, dev.valid, alive, t_dev,
                                   block=index.block)
            tile_mask = tile_survival(alive, bq)
    else:  # the bound and exact spans are inside
        dist, alive, tile_mask = _query_batched(
            metric_eng, q_dev, t_dev, dev, block=index.block, bq=bq,
            backend=backend,
        )
        hits = dist <= t_dev[:, None]
    return _range_epilogue(
        index, hits, alive, tile_mask, perm=index.perm,
        vpb=dev.valid.reshape(index.n_blocks, index.block).sum(dim=1), backend=backend,
        eps=eps, recheck_tiles=recheck_tiles, band_counts=band_counts,
    )


def _query_cells(index: BSSIndex, metric_name: str, queries: torch.Tensor,
                 t: torch.Tensor, alive: np.ndarray, eps: float | None):
    """The sparse realisation of the "torch" backend's range search (the
    reference's host code around ``_cells_exact_jit`` and, with ``eps``,
    ``_cells_exact_bf16_jit``): only the alive (query, block) cells are
    evaluated.  bf16: the sure hits of the cells without a band point, then
    every band cell re-checked through the fp32 ``_cells_exact``.  Returns
    the ``_range_epilogue`` hits (hit_q, hit_pos) on the device in (query,
    position) order, and the band points per query (bf16; None for
    fp32)."""
    dev, device, block = index.device, index.torch_device, index.block
    qidx, bidx, cell_valid = _padded_cells(*np.nonzero(alive), device)
    if eps is None:
        hit = _cells_exact(metric_name, queries, dev.data, dev.valid, qidx, bidx,
                           cell_valid, t, block=block)
        return _cell_hits(hit, qidx, bidx, block), None
    sure, band_cell, band_counts = _cells_exact_bf16(
        metric_name, queries, index.device_bf16, dev.valid, qidx, bidx, cell_valid, t,
        torch.tensor(eps, dtype=torch.float32, device=device), block=block)
    hit_q, hit_pos = _cell_hits(sure, qidx, bidx, block)
    sel = torch.nonzero(band_cell).squeeze(1)
    if sel.numel():
        with span("bss.range.copy"):
            q_sel, b_sel = to_host(torch.stack([qidx[sel], bidx[sel]]))
        q2, b2, v2 = _padded_cells(q_sel, b_sel, device)
        hit = _cells_exact(metric_name, queries, dev.data, dev.valid, q2, b2, v2, t,
                           block=block)
        rq, rp = _cell_hits(hit, q2, b2, block)
        hit_q, hit_pos = torch.cat([hit_q, rq]), torch.cat([hit_pos, rp])
        order = torch.argsort(hit_q * dev.data.shape[0] + hit_pos)  # keys are distinct
        hit_q, hit_pos = hit_q[order], hit_pos[order]
    return (hit_q, hit_pos), band_counts


# ---------------------------------------------------------------------------
# kNN
# ---------------------------------------------------------------------------


def _knn_round(
    metric_name: str,
    queries: torch.Tensor,
    radii: torch.Tensor,
    lb: torch.Tensor,
    dev: BSSDeviceArrays,
    *,
    k: int,
    block: int,
    bq: int,
    backend: str,
):
    """One radius-deepening round over all queries (the reference's dense
    ``_knn_round_jit``).  ``lb`` is the radius-independent (Q, B) bound
    matrix.  Returns (cand_idx (Q, k) positions in the permuted layout,
    cand_dist (Q, k) ascending, kth (Q,), done (Q,), alive (Q, B)).

    The top-k is ``_top_k_smallest``: on equal distances the lowest
    position comes first, as ``jax.lax.top_k`` gives it (``torch.topk``
    alone promises no order).  ``done`` is sound: if the kth computed
    distance is <= the query's radius, every unevaluated point lies in a
    block whose bound exceeds the radius; if every block was alive, nothing
    is unevaluated."""
    alive = lb <= radii[:, None]
    tile_mask = tile_survival(alive, bq)
    dist = _masked_exact_dists(
        metric_name, queries, dev.data, dev.valid, tile_mask,
        backend=backend, block=block, bq=bq,
    )  # (Q, n_pad), +inf where pruned or padding
    return (*_round_top_k(dist, radii, alive, k), alive)


def _total_order_keys(dist: torch.Tensor) -> torch.Tensor:
    """(Q, n) int64 keys of a float32 (Q, n) block, unique per row and in
    the order a stable ascending sort gives: the high 32 bits hold the IEEE
    total-order image of the float's bits (on the signed view, negative
    values flip their 31 magnitude bits, so -0.0 < +0.0 and +inf ranks
    above every finite value), the low 32 bits the column position."""
    bits = dist.contiguous().view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    pos = torch.arange(dist.shape[1], dtype=torch.int64, device=dist.device)
    return (ordered.to(torch.int64) << 32) | pos


def _top_k_smallest(dist: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx, values) of each row's k smallest entries, ascending, ties by
    lowest position, and -0.0 ahead of +0.0: ``jax.lax.top_k(-dist, k)``'s
    selection and order (the reference's round top-k).  The keys are
    unique, so any top-k over them selects exactly a stable sort's first k.
    The k are put in order by their ranks (the count of smaller keys among
    them), which needs no sort kernel."""
    keys, idx = torch.topk(_total_order_keys(dist), k, dim=1, largest=False, sorted=False)
    rank = (keys[:, None, :] < keys[:, :, None]).sum(dim=2)
    idx = torch.empty_like(idx).scatter_(1, rank, idx)
    return idx, torch.gather(dist, 1, idx)


def _round_top_k(dist: torch.Tensor, radii: torch.Tensor, alive: torch.Tensor,
                 k: int):
    """A round's top-k of ``dist`` (``_top_k_smallest``) and its ``done``
    test: (cand_idx, cand_dist, kth, done).  Both precisions select through
    it, so ties fall alike."""
    with span("bss.knn.top_k", device=dist.device):
        cand_idx, cand_dist = _top_k_smallest(dist, k)
    kth = cand_dist[:, -1]
    done = torch.isfinite(kth) & ((kth <= radii) | alive.all(dim=1))
    return cand_idx, cand_dist, kth, done


def _knn_round_bf16(
    metric_name: str,
    queries: torch.Tensor,
    radii: torch.Tensor,
    lb: torch.Tensor,
    dev: BSSDeviceArrays,
    data16: torch.Tensor,
    eps: torch.Tensor,
    *,
    k: int,
    block: int,
    bq: int,
    backend: str,
):
    """One bf16 radius-deepening round with the fp32 re-check (the
    reference's ``_knn_round_bf16_jit``).  Returns ``_knn_round``'s outputs
    bit for bit, then recheck_tiles (0-d) and band_counts (Q,) int32.

    The bf16 scan's kth distance ``kth16`` lies within ``eps`` of the fp32
    kth, so every member of the fp32 top-k has ``d16 <= kth16 + 2 eps``.
    That band is re-checked in fp32 and the top-k taken over the fp32
    values (+inf outside the band) with ``_round_top_k``: every
    excluded point lies strictly beyond the fp32 kth, so the selection and
    its tie order are the fp32 round's.  When fewer than k cells were
    computed, ``kth16`` is +inf and the band is every computed cell."""
    alive = lb <= radii[:, None]
    tile_mask = tile_survival(alive, bq)
    d16 = _masked_exact_dists(
        metric_name, queries, data16, dev.valid, tile_mask,
        backend=backend, block=block, bq=bq,
    )
    # only the kth value is needed, so any top-k does
    kth16 = torch.topk(d16, k, dim=1, largest=False, sorted=False).values.amax(dim=1)
    bthr = torch.where(torch.isfinite(kth16), kth16 + 2.0 * eps, torch.inf)
    band = (d16 <= bthr[:, None]) & torch.isfinite(d16)
    del d16  # freed before the re-check allocates its own block
    band_blocks = band.reshape(queries.shape[0], -1, block).any(dim=2)
    recheck_mask = tile_survival(band_blocks, bq) & tile_mask
    d32 = _masked_exact_dists(
        metric_name, queries, dev.data, dev.valid, recheck_mask,
        backend=backend, block=block, bq=bq,
    )
    # in place: ``d32`` is the fresh tensor _masked_exact_dists made for this call
    dist = d32.masked_fill_(~band, torch.inf)
    return (
        *_round_top_k(dist, radii, alive, k), alive, recheck_mask.sum(),
        band.sum(dim=1, dtype=torch.int32),
    )


def _scatter_cells(d: torch.Tensor, qidx: torch.Tensor, bidx: torch.Tensor, nq: int,
                   n_blocks: int) -> torch.Tensor:
    """(Q, n_pad) +inf block with each gathered cell's (block,) distances
    min-scattered into its (query, block) place (``.at[q, b].min``)."""
    dense = torch.full((nq * n_blocks, d.shape[1]), torch.inf, dtype=torch.float32,
                       device=d.device)
    rows = (qidx * n_blocks + bidx)[:, None].expand(-1, d.shape[1])
    return dense.scatter_reduce_(0, rows, d, reduce="amin").reshape(nq, -1)


def _knn_round_cells(
    metric_name: str,
    queries: torch.Tensor,
    data: torch.Tensor,
    valid: torch.Tensor,
    qidx: torch.Tensor,
    bidx: torch.Tensor,
    cell_valid: torch.Tensor,
    *,
    k: int,
    block: int,
):
    """A sparse kNN round (the reference's ``_knn_round_cells_jit``): the
    distances of the gathered alive cells only, min-scattered into a (Q,
    n_pad) +inf block (padded cells carry +inf, a no-op), then the round's
    top-k.  Returns (cand_idx (Q, k) positions, cand_dist (Q, k))."""
    d, pvalid = _gather_cell_dists(metric_name, queries, data, valid, qidx, bidx, block)
    d = torch.where(pvalid & cell_valid[:, None], d, torch.inf)
    dense = _scatter_cells(d, qidx, bidx, queries.shape[0], data.shape[0] // block)
    with span("bss.knn.top_k", device=dense.device):
        return _top_k_smallest(dense, k)


def _knn_round_cells_bf16(
    metric_name: str,
    queries: torch.Tensor,
    data16: torch.Tensor,
    valid: torch.Tensor,
    qidx: torch.Tensor,
    bidx: torch.Tensor,
    cell_valid: torch.Tensor,
    eps: torch.Tensor,
    *,
    k: int,
    block: int,
):
    """The bf16 half of a sparse kNN round (the reference's
    ``_knn_round_cells_bf16_jit``): the alive cells over the bf16 mirror,
    each query's bf16 kth, and the cells that hold a point of the band
    ``d16 <= kth16 + 2 eps`` (``_knn_round_bf16``'s containment argument).
    The caller runs the fp32 ``_knn_round_cells`` over just those cells.
    Returns (band_cell (C,) bool, band_counts (Q,) int32)."""
    d, pvalid = _gather_cell_dists(metric_name, queries, data16, valid, qidx, bidx, block)
    d = torch.where(pvalid & cell_valid[:, None], d, torch.inf)
    nq = queries.shape[0]
    dense16 = _scatter_cells(d, qidx, bidx, nq, data16.shape[0] // block)
    kth16 = torch.topk(dense16, k, dim=1, largest=False, sorted=False).values.amax(dim=1)
    bthr = torch.where(torch.isfinite(kth16), kth16 + 2.0 * eps, torch.inf)
    band = (d <= bthr[qidx][:, None]) & torch.isfinite(d)
    band_counts = torch.zeros(nq, dtype=torch.int32, device=d.device)
    band_counts.index_add_(0, qidx, band.sum(dim=1, dtype=torch.int32))
    return band.any(dim=1), band_counts


def _tiles_computed(alive: np.ndarray, bq: int) -> int:
    """Live (query tile x block) cells of a (Q, B) survival matrix, on the
    host (``tile_survival``'s rule)."""
    nq, nb = alive.shape
    qtiles = -(-nq // bq)
    pad = np.zeros((qtiles * bq - nq, nb), bool)
    return int(np.concatenate([alive, pad]).reshape(qtiles, bq, nb).any(axis=1).sum())


def _knn_empty_stats(index: BSSIndex, nq: int, precision: str,
                     backend: str, engine: str = "bss") -> dict:
    """Stats of the kNN early returns (no queries, or no valid corpus
    point): zero rounds, zero work."""
    stats = {
        "rounds": 0, "pivot_dists_per_query": 0.0,
        "exact_dists_per_query": 0.0, "dists_per_query": 0.0,
        "per_query_dists": np.zeros(nq, np.int64),
        "tiles_computed": 0, "n_blocks": int(index.n_blocks),
        "generation": int(index.generation),
        "precision": precision,
        "excluded": {"hilbert": np.zeros(nq, np.int64)},
    }
    if precision == "bf16":
        _bf16_stats(stats, index.bf16_margin(), 0, np.zeros(nq, np.int64))
    return _finish_stats(stats, kind="knn", backend=backend, engine=engine)


def bss_knn_batched(
    index: BSSIndex,
    queries: np.ndarray,
    k: int,
    *,
    r0: float | None = None,
    growth: float = 2.0,
    max_rounds: int = 8,
    opts: EngineOpts | None = None,
    bq: int | None = None,
    backend: str | None = None,
    realisation: str | None = None,
    precision: str | None = None,
) -> tuple[np.ndarray, np.ndarray, dict]:
    """Exact batched kNN: the range-search reduction run as
    radius-deepening rounds over all queries at once, on the index's
    device.  Options travel as in ``bss_query_batched``; ``r0`` /
    ``growth`` / ``max_rounds`` are the radius schedule.

    The host driver follows the reference (``repro.core.flat_index.
    bss_knn_batched``) step for step, so radii, rounds and per-query
    distance counts match it:

    * the (Q, B) bounds are computed once through the backend; the sorted
      host copy sets each query's initial radius, the ceil(2k/block)-th
      smallest bound (or ``r0``), and the widening schedule;
    * each round keeps the blocks with bound <= radius, computes their
      exact distances and takes a stable top-k; a query is finished when
      its kth distance is finite and within its radius (or every block was
      alive) — its result is then frozen and its radius set to -1;
    * an unfinished query tightens to its kth so far and widens to the
      radius that at least doubles its surviving blocks (``growth`` x the
      radius at least); one with more than half the blocks alive, and every
      query left after ``max_rounds``, runs one exhaustive round.

    A round on ``"cuda"``, or on ``"torch"`` with ``realisation="dense"``,
    runs the dense masked exact phase; on ``"torch"`` with ``"adaptive"``
    (the default) a round whose alive cells are at most
    ``_DENSE_ALIVE_FRAC`` of all evaluates only those cells
    (``_knn_round_cells``; bf16 first finds the band cells,
    ``_knn_round_cells_bf16``).  Both are exact and give the same ids; a
    distance may differ in its last ulp between them, which can move the
    radius schedule and so the per-query counts, never the results
    (the reference's contract).  Only the (Q, k) candidates, ``kth``,
    ``done`` and ``alive`` come back to the host.

    ``precision="bf16"`` runs every round over the bf16 corpus mirror with
    the fp32 re-check of the band ``d16 <= kth16 + 2 eps``
    (``_knn_round_bf16``): ids, distances, the radius schedule and the
    per-query counts are the fp32 run's bit for bit; the stats gain the
    re-check telemetry (``band_eps``, ``recheck_tiles``,
    ``per_query_recheck``).

    Returns (ids (Q, k) original ids by ascending distance, -1 where the
    corpus holds fewer than k valid points; dists (Q, k) float32, +inf
    there; stats with ``kind="knn"``).

    A mesh-built index serves through the sharded engine
    (``sharded_knn_batched``: per-shard rounds merged by a second top-k
    under the same radius schedule), with the same results bit for bit."""
    opts = resolve_engine_opts(
        opts, bq=bq, backend=backend, realisation=realisation,
        precision=precision,
    )
    if index.mesh is not None:
        from repro_torch.parallel.shard_index import sharded_knn_batched

        return sharded_knn_batched(
            index.sharded(), queries, k, r0=r0, growth=growth,
            max_rounds=max_rounds, opts=opts,
        )
    precision = opts.precision
    bq = opts.bq if opts.bq is not None else _DEFAULT_BQ
    backend = resolve_backend(opts.backend, index.torch_device)
    metric_eng = _engine_metric(index.metric_name)
    queries = _engine_queries(index.metric_name, np.asarray(queries, np.float32))
    nq = queries.shape[0]
    k = int(k)
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    if nq == 0:
        return (
            np.zeros((0, k), np.int64),
            np.zeros((0, k), np.float32),
            _knn_empty_stats(index, 0, precision, backend),
        )
    # clamp to the VALID corpus size: with k_run > n_valid the kth distance
    # would stay inf and no round could finish early
    k_run = min(k, index.n_valid)
    if k_run == 0:
        return (
            np.full((nq, k), -1, np.int64),
            np.full((nq, k), np.inf, np.float32),
            _knn_empty_stats(index, nq, precision, backend),
        )
    dev = index.device
    q_dev = torch.as_tensor(queries, device=index.torch_device)
    bf16 = precision == "bf16"
    if bf16:
        eps = index.bf16_margin()
        data16 = index.device_bf16
        eps_dev = torch.tensor(eps, dtype=torch.float32, device=index.torch_device)
    recheck_pq = np.zeros(nq, np.int64)
    recheck_tiles_total = 0
    with span("bss.knn.bound"):
        lb_dev = _fused_lower_bounds(
            metric_eng, q_dev, dev.pivots, dev.pairs, dev.deltas, dev.boxes,
            backend=backend,
        )
    with span("bss.knn.copy"):
        lb_np = to_host(lb_dev)
    with span("bss.knn.sort"):
        lb_sorted = np.sort(lb_np, axis=1)
        n_blocks = index.n_blocks
        if r0 is None:
            j0 = min(n_blocks - 1, max(0, math.ceil(2 * k / index.block) - 1))
            radii = lb_sorted[:, j0].astype(np.float32)
        else:
            radii = np.full(nq, float(r0), np.float32)

    valid_pb = _valid_per_block(index)
    total_exact = np.zeros(nq, np.int64)
    excl_pq = np.zeros(nq, np.int64)
    tiles_total = 0
    done = np.zeros(nq, bool)
    cand_idx = np.full((nq, k_run), 0, np.int64)
    cand_dist = np.full((nq, k_run), np.inf, np.float32)
    rounds = 0
    for rounds in range(1, max_rounds + 2):
        with span("bss.knn.round", round=rounds):
            if rounds == max_rounds + 1:
                # exhaustive fallback for stragglers: radius inf computes every
                # block, so this round is final for them
                radii = np.where(done, radii, np.inf).astype(np.float32)
            radii_dev = torch.as_tensor(radii, device=index.torch_device)
            alive_host = lb_np <= radii[:, None]  # the device test's cells
            if (backend == "torch" and opts.realisation != "dense"
                    and alive_host.mean() <= _DENSE_ALIVE_FRAC):
                # a sparse round: the alive cells only (the branch reads only
                # the fp32 bounds, so both precisions take it alike); bf16 picks
                # the band cells and the fp32 round runs over just those
                qidx, bidx, cell_valid = _padded_cells(*np.nonzero(alive_host),
                                                       index.torch_device)
                if bf16:
                    with span("bss.knn.exact"):
                        band_cell, band_counts = _knn_round_cells_bf16(
                            metric_eng, q_dev, data16, dev.valid, qidx, bidx, cell_valid,
                            eps_dev, k=k_run, block=index.block,
                        )
                    with span("bss.knn.copy"):
                        recheck_pq += np.where(~done, to_host(band_counts), 0)
                        sel = torch.nonzero(band_cell).squeeze(1)
                        q_sel, b_sel = to_host(qidx[sel]), to_host(bidx[sel])
                    qidx, bidx, cell_valid = _padded_cells(q_sel, b_sel, index.torch_device)
                with span("bss.knn.exact"):
                    out = _knn_round_cells(
                        metric_eng, q_dev, dev.data, dev.valid, qidx, bidx, cell_valid,
                        k=k_run, block=index.block,
                    )
                with span("bss.knn.copy"):
                    ci, cd = (to_host(a) for a in out)
                kth = cd[:, -1]
                dn = np.isfinite(kth) & ((kth <= radii) | alive_host.all(axis=1))
                alive = alive_host
            elif bf16:
                with span("bss.knn.exact"):
                    out = _knn_round_bf16(
                        metric_eng, q_dev, radii_dev, lb_dev, dev, data16, eps_dev,
                        k=k_run, block=index.block, bq=bq, backend=backend,
                    )
                with span("bss.knn.copy"):
                    ci, cd, kth, dn, alive, rtiles, band_counts = (to_host(a) for a in out)
                recheck_tiles_total += int(rtiles)
                recheck_pq += np.where(~done, band_counts, 0)
            else:
                with span("bss.knn.exact"):
                    out = _knn_round(
                        metric_eng, q_dev, radii_dev, lb_dev, dev,
                        k=k_run, block=index.block, bq=bq, backend=backend,
                    )
                with span("bss.knn.copy"):
                    ci, cd, kth, dn, alive = (to_host(a) for a in out)
            with span("bss.knn.schedule"):
                upd = ~done  # finished queries are frozen
                cand_idx[upd] = ci[upd]
                cand_dist[upd] = cd[upd]
                total_exact[upd] += alive[upd].astype(np.int64) @ valid_pb
                excl_pq[upd] += n_blocks - alive[upd].sum(axis=1)
                tiles_total += _tiles_computed(alive, bq)
                done = done | dn
                if done.all():
                    break
                # widen to the radius that at least doubles the surviving blocks,
                # tighten to the kth so far where k candidates are held
                n_alive = alive.sum(axis=1)
                j_next = np.minimum(
                    n_blocks - 1,
                    np.maximum(np.maximum(2 * n_alive, n_alive + 1), 1),
                )
                widened = np.maximum(lb_sorted[np.arange(nq), j_next], radii * growth)
                # finished queries get a negative radius: lb >= 0, so their rows
                # leave the remaining rounds
                radii = np.where(
                    done, np.float32(-1.0),
                    np.where(np.isfinite(kth), np.minimum(kth, widened), widened),
                ).astype(np.float32)
                # most blocks already alive: finish exhaustively
                radii = np.where(
                    ~done & (n_alive > n_blocks // 2), np.float32(np.inf), radii
                )

    n_pivots = index.pivots.shape[0]
    stats = {
        "rounds": rounds,
        "pivot_dists_per_query": float(n_pivots),
        "exact_dists_per_query": float(total_exact.mean()),
        "dists_per_query": float(n_pivots + total_exact.mean()),
        "per_query_dists": n_pivots + total_exact,
        "tiles_computed": tiles_total,
        "n_blocks": int(index.n_blocks),
        "generation": int(index.generation),
        "precision": precision,
        # rounds x blocks the Hilbert bound pruned from the exact phase,
        # per query over its unfinished rounds only
        "excluded": {"hilbert": excl_pq},
    }
    if bf16:
        _bf16_stats(stats, eps, recheck_tiles_total, recheck_pq)
    stats = _finish_stats(stats, kind="knn", backend=backend)
    orig = np.where(np.isfinite(cand_dist), index.perm[cand_idx], -1)
    if k_run < k:  # corpus smaller than k: pad out to the requested width
        orig = np.pad(orig, ((0, 0), (0, k - k_run)), constant_values=-1)
        cand_dist = np.pad(
            cand_dist, ((0, 0), (0, k - k_run)), constant_values=np.inf
        )
    return orig, cand_dist, stats
