"""Blocked Supermetric Scan (BSS) — the port of ``repro.core.flat_index``:
fp32 range search for every four-point metric, with the l2 kernels (and
cosine, served as l2 on the unit sphere) on the H100.

build:  ``build_bss`` is the reference's host numpy build, carried over as
        is (FFT pivots, the widest pivot-pair planes, a median-split
        permutation packed into blocks, one bounding box per block and
        plane), so the layout is bit-identical to the JAX package's.  The
        index keeps its arrays on the host and mirrors them once onto its
        torch device (``index.device``).

query:  ``bss_query_batched`` runs one pass per batch on the device:
        query -> pivot distances, the planar lower bound per (query,
        block), tile survival per (query tile, block), and exact distances
        only in the surviving cells.  The hit test runs on the device and
        only the (query, position) pairs of the hits come back to the host.
        With ``backend="cuda"`` the three steps are the hand-written
        kernels; with ``"torch"`` the same math in plain torch ops.

``bss_query`` is the reference's numpy oracle (float64 exact phase), kept
as the correctness check both backends are held to.

Device rule: ``build_bss(device=None)`` builds for the CUDA device and
raises when there is none; the CPU is used only when the caller asks for
it.  Not in this slice (ROADMAP.md): kNN, sharding (``mesh``), the bf16
exact phase, the maintenance path, and CUDA kernels for jsd/triangular.
Power transforms keep the reference's rule: with no tile kernel their
distances run as plain pairwise on either backend.
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
from repro_torch.core.distances import Metric, get_metric
from repro_torch.core.npdist import pairwise_np
from repro_torch.core.refpoints import select_fft
from repro_torch.kernels.pairwise_dist import (
    KERNEL_METRICS,
    masked_pairwise_kernel_call,
    pairwise_kernel_call,
)
from repro_torch.kernels.planar_exclusion import planar_lower_bound_kernel_call
from repro_torch.kernels.tiles import TILE_BQ
from repro_torch.obs import schema as obs_schema

__all__ = [
    "BSSIndex",
    "build_bss",
    "index_from_arrays",
    "bss_query",
    "bss_query_batched",
    "bss_lower_bounds",
    "resolve_device",
]

_DEFAULT_BQ = TILE_BQ

# normalisation floor of the cosine -> l2 mapping (the cosine metric's own)
_MIN_NORM = 1e-12

# metrics whose reference engine runs a tile kernel this slice has not
# ported: on the cuda backend they raise instead of running plain
_UNPORTED_KERNEL_METRICS = ("jsd", "triangular")

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
    # where the device mirror lives; None resolves to the CUDA device
    torch_device: torch.device | None = dataclasses.field(
        default=None, compare=False
    )
    _device: BSSDeviceArrays | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def __post_init__(self):
        self.torch_device = resolve_device(self.torch_device)

    @property
    def n_blocks(self) -> int:
        return self.boxes.shape[0]

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())

    @property
    def metric(self) -> Metric:
        return get_metric(self.metric_name)

    @property
    def device(self) -> BSSDeviceArrays:
        """The index's arrays on ``torch_device``, copied once."""
        if self._device is None:
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
    the CUDA device; raises without one unless ``device="cpu"``)."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded BSS is not ported yet: ROADMAP Queue 1 item 10"
        )
    device = resolve_device(device)
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
    return _build_engine_index(
        metric_name, data, n_pivots=n_pivots, n_pairs=n_pairs, block=block,
        seed=seed, device=device,
    )


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


def index_from_arrays(fields: dict, *, device=None) -> BSSIndex:
    """A ``BSSIndex`` from the reference index's fields as numpy arrays and
    ints (``INDEX_FIELDS``) — the port queries the very index the JAX
    package built.  ``device`` as in ``build_bss``."""
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
        torch_device=resolve_device(device),
    )


# ---------------------------------------------------------------------------
# Lower bounds, the numpy oracle and the distance accounting
# ---------------------------------------------------------------------------


def bss_lower_bounds(index: BSSIndex, queries: np.ndarray) -> np.ndarray:
    """(Q, n_blocks) planar lower bounds, in plain torch on the index's
    device (the reference computes them with its jnp backend)."""
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
    d1 = torch.index_select(dqp, 1, dev_pairs[:, 0])
    d2 = torch.index_select(dqp, 1, dev_pairs[:, 1])
    if backend == "cuda":
        return planar_lower_bound_kernel_call(d1, d2, dev_deltas, dev_boxes)
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
    lb = _fused_lower_bounds(
        metric_name, queries, dev.pivots, dev.pairs, dev.deltas, dev.boxes,
        backend=backend,
    )  # (Q, B)
    alive = lb <= t[:, None]
    tile_mask = tile_survival(alive, bq)  # (Qtiles, B)
    dist = _masked_exact_dists(
        metric_name, queries, dev.data, dev.valid, tile_mask,
        backend=backend, block=block, bq=bq,
    )
    return dist, alive, tile_mask


def _batched_stats(index: BSSIndex, alive: np.ndarray, tile_mask: np.ndarray) -> dict:
    """The paper's figure of merit for a fused pass: each query's own
    surviving blocks weighted by their VALID point counts;
    ``tiles_computed`` counts the tiles the exact phase ran."""
    n_pivots = index.pivots.shape[0]
    exact = _exact_counts(index, alive)
    mean_exact = float(exact.mean()) if exact.size else 0.0
    return {
        "pivot_dists_per_query": float(n_pivots),
        "exact_dists_per_query": mean_exact,
        "dists_per_query": float(n_pivots) + mean_exact,
        "per_query_dists": n_pivots + exact,
        "block_exclusion_rate": float(1.0 - alive.mean()) if alive.size else 1.0,
        "tiles_computed": int(tile_mask.sum()),
        "tile_exclusion_rate": (
            float(1.0 - tile_mask.mean()) if tile_mask.size else 1.0
        ),
        "n_blocks": int(index.n_blocks),
        "generation": int(index.generation),
        # every block BSS excludes is excluded by the planar four-point
        # bound — the Hilbert mechanism
        "excluded": {
            "hilbert": (index.n_blocks - alive.sum(axis=1)).astype(np.int64),
        },
    }


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
    card (~208 MB at the paper's colors size)."""
    opts = resolve_engine_opts(
        opts, bq=bq, backend=backend, realisation=realisation,
        precision=precision,
    )
    if opts.precision == "bf16":
        raise NotImplementedError(
            "the bf16 exact phase is not ported yet: ROADMAP Queue 1 item 5"
        )
    bq = opts.bq if opts.bq is not None else _DEFAULT_BQ
    backend = resolve_backend(opts.backend, index.torch_device)
    metric_eng = _engine_metric(index.metric_name)
    if backend == "cuda" and metric_eng in _UNPORTED_KERNEL_METRICS:
        raise NotImplementedError(
            f"no CUDA kernel for {metric_eng!r} yet (ROADMAP Queue 2 items "
            f"4-5); use backend='torch'"
        )
    queries = _engine_queries(index.metric_name, np.asarray(queries, np.float32))
    nq = queries.shape[0]
    if nq == 0:
        stats = _batched_stats(
            index,
            np.zeros((0, index.n_blocks), bool),
            np.zeros((0, index.n_blocks), bool),
        )
        stats["precision"] = "fp32"
        return [], _finish_stats(stats, kind="range", backend=backend)
    t_vec = _per_query_t(t, nq)
    dev = index.device
    t_dev = torch.as_tensor(t_vec, device=index.torch_device)
    dist, alive, tile_mask = _query_batched(
        metric_eng,
        torch.as_tensor(queries, device=index.torch_device),
        t_dev,
        dev,
        block=index.block,
        bq=bq,
        backend=backend,
    )
    # hit test on the device; nonzero is row-major, so positions ascend
    # within each query — the oracle's order
    pos = torch.nonzero(dist <= t_dev[:, None]).cpu().numpy()
    qidx, pidx = pos[:, 0], pos[:, 1]
    orig = index.perm[pidx]
    counts = np.bincount(qidx, minlength=nq)
    per_query = np.split(orig, np.cumsum(counts)[:-1])
    results = [r.tolist() for r in per_query]
    stats = _batched_stats(index, alive.cpu().numpy(), tile_mask.cpu().numpy())
    stats["precision"] = "fp32"
    return results, _finish_stats(stats, kind="range", backend=backend)
