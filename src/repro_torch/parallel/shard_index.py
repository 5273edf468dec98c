"""Sharded BSS — the port of ``repro.parallel.shard_index``: the fused engine
partitioned over a :class:`~repro_torch.parallel.sharding.ShardMesh`.

``ShardedBSSIndex`` takes a built :class:`~repro_torch.core.flat_index.
BSSIndex` and partitions its corpus BLOCKS over the mesh's data axes in
contiguous chunks, so every shard is itself a blocked corpus (block-aligned
rows, a box per block and plane, a valid bit per slot).  Each shard's
tensors live on its device; queries and the pivot tables are copied once
per distinct device.

One controlling process drives every shard, as one process drives a JAX
mesh under ``shard_map``.  Each query path runs the single-device engine's
own pieces shard by shard, each launch on its shard's device, and merges
on the lead device (``mesh.devices[0]``) what the reference's out-specs
and ``all_gather`` concatenate:

* ``sharded_query_batched`` — range search.  Each shard runs the pass the
  single-device engine runs (``_query_batched``, ``_query_batched_bf16``,
  or on ``"torch"`` the dense hit mask) over its blocks; the per-shard hit
  masks, ``alive`` and tile masks are concatenated in corpus order on the
  lead device, and the single-device epilogue (``_range_epilogue``) reads
  the hits and the stats over the REAL blocks, the shard work beside
  them.
* ``sharded_knn_batched`` — radius-deepening kNN.  Every round each shard
  computes its masked exact distances and a per-shard top-k of
  ``min(k, rows_per_shard)``, positions made global (``+ shard *
  rows_per_shard``); the candidates are concatenated shard-major and
  merged by a second top-k.  The radius stays global (the merged kth), so
  each shard's planar exclusion stays sound, and the host loop follows
  ``bss_knn_batched``'s schedule step for step.  bf16 first merges the
  shards' bf16 candidates into the GLOBAL bf16 kth, then cuts the band.

Tie order: both top-ks are ``flat_index._top_k_smallest``, whose keys
order equal values by column.  The merge's columns are shard-major, each
shard's list in ascending-position order for ties, so on equal distances
the merge picks the smallest global position — the single-device top-k's
choice, and ``jax.lax.top_k``'s in the reference.

Every tile cell's bits are independent of the mask, the block count and the
launch, and the planar bound is elementwise per (query, block), so on the
same backend the sharded engine returns what the single-device engine
returns, bit for bit: hits, ``alive``, counts, kNN ids, distances, rounds.

Block-count padding: when ``n_blocks`` is not a multiple of the shard
count, empty blocks are appended — zero rows, ``valid`` False, ``perm``
-1, and boxes with the empty-box sentinel ``build_bss`` gives an
all-padding block, so their bound is +inf and no finite radius admits
them.  Stats are reported over the real blocks only.

Telemetry: ``stats["shard_dists"]`` (each shard's exact-phase distance
count: the valid rows of its surviving blocks, summed over queries) and
``stats["shard_blocks"]`` (its surviving non-empty blocks), int64, one slot
per shard; ``shard_dists`` sums to the batch's exact-phase work.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.backends import (
    EngineOpts,
    resolve_backend,
    resolve_engine_opts,
    tile_survival,
)
from repro_torch.core.flat_index import (
    _DEFAULT_BQ,
    BSSDeviceArrays,
    BSSIndex,
    _bf16_stats,
    _dense_hit_mask,
    _engine_metric,
    _engine_queries,
    _finish_stats,
    _fused_lower_bounds,
    _knn_empty_stats,
    _masked_exact_dists,
    _per_query_t,
    _query_batched,
    _query_batched_bf16,
    _range_epilogue,
    _tiles_computed,
    _top_k_smallest,
    _valid_per_block,
)
from repro_torch.core.precision import bf16_round_np
from repro_torch.parallel.sharding import ShardMesh, check_mesh, n_shards, shard_devices

__all__ = [
    "ShardedBSSIndex",
    "shard_bss",
    "sharded_lower_bounds",
    "sharded_query_batched",
    "sharded_knn_batched",
]

# the empty-box sentinel build_bss gives all-invalid slots: point_to_box
# against (min=+big, max=-big) overflows to +inf in float32
_BIG = np.float32(3.4e38)


class ShardedBSSIndex:
    """Block-granular partition of a built ``BSSIndex`` over a mesh (module
    docstring).  ``shards[s]`` is shard s's ``BSSDeviceArrays`` on
    ``devices[s]``; ``perm`` maps the padded layout's positions to
    original ids (-1 for padding)."""

    def __init__(self, index: BSSIndex, mesh: ShardMesh):
        check_mesh(mesh)
        n_pivots = index.pivots.shape[0]
        if ((index.pairs < 0) | (index.pairs >= n_pivots)).any():
            raise ValueError(f"pivot pairs must index the {n_pivots} pivots")
        self.index = index
        self.mesh = mesh
        self.n_shards = n_shards(mesh)
        self.devices = shard_devices(mesh)

        block = index.block
        self.n_blocks_pad = -(-index.n_blocks // self.n_shards) * self.n_shards
        pad_b = self.n_blocks_pad - index.n_blocks
        dim = index.data.shape[1]
        m = index.pairs.shape[0]
        data, valid, boxes, perm = index.data, index.valid, index.boxes, index.perm
        if pad_b:
            data = np.concatenate([data, np.zeros((pad_b * block, dim), np.float32)])
            valid = np.concatenate([valid, np.zeros(pad_b * block, bool)])
            empty = np.tile(np.array([_BIG, -_BIG, _BIG, -_BIG], np.float32), (pad_b, m, 1))
            boxes = np.concatenate([boxes, empty])
            perm = np.concatenate([perm, np.full(pad_b * block, -1, np.int64)])
        self.perm = perm
        self.n_pad = self.n_blocks_pad * block
        self.blocks_per_shard = self.n_blocks_pad // self.n_shards
        self.rows_per_shard = self.n_pad // self.n_shards
        self._host_data = data  # the padded layout, for the lazy bf16 mirror
        self._valid = valid

        tables = {
            dev: (
                torch.as_tensor(index.pivots, dtype=torch.float32, device=dev),
                torch.as_tensor(index.pairs, dtype=torch.int64, device=dev),
                torch.as_tensor(index.deltas, dtype=torch.float32, device=dev),
            )
            for dev in dict.fromkeys(self.devices)
        }
        rows, bps = self.rows_per_shard, self.blocks_per_shard
        self.shards = [
            BSSDeviceArrays(
                data=torch.tensor(data[s * rows:(s + 1) * rows], dtype=torch.float32, device=dev),
                pivots=tables[dev][0],
                pairs=tables[dev][1],
                deltas=tables[dev][2],
                boxes=torch.tensor(boxes[s * bps:(s + 1) * bps], dtype=torch.float32,
                                   device=dev),
                valid=torch.tensor(valid[s * rows:(s + 1) * rows], dtype=torch.bool, device=dev),
            )
            for s, dev in enumerate(self.devices)
        ]
        self._data16: list | None = None

    @property
    def data16(self) -> list:
        """Each shard's bfloat16 corpus mirror (lazy: only bf16 queries pay
        for it), rounded on the host as ``BSSIndex.device_bf16`` rounds the
        corpus.  The margin is ``index.bf16_margin()``, measured over the
        valid rows, which the padding never adds to."""
        if self._data16 is None:
            rows = self.rows_per_shard
            self._data16 = [
                torch.as_tensor(bf16_round_np(self._host_data[s * rows:(s + 1) * rows]),
                                device=dev).to(torch.bfloat16)
                for s, dev in enumerate(self.devices)
            ]
        return self._data16

    def valid_per_block(self) -> np.ndarray:
        """(n_blocks_pad,) valid rows per block of the padded layout."""
        return self._valid.reshape(self.n_blocks_pad, self.index.block).sum(axis=1)

    def per_device(self, arr, dtype=None) -> dict:
        """One device copy of a host array per distinct mesh device."""
        return {dev: torch.as_tensor(arr, dtype=dtype, device=dev)
                for dev in dict.fromkeys(self.devices)}

    def merged(self, parts: list) -> torch.Tensor:
        """Per-shard (Q, ...) tensors concatenated along dim 1 on the lead
        device, in shard order (corpus order)."""
        lead = self.mesh.lead
        return torch.cat([p.to(lead) for p in parts], dim=1)

    def shard_work(self, alive_pad: torch.Tensor,
                   vpb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(shard_dists, shard_blocks) int64 of a (Q, n_blocks_pad) survival
        matrix, where it lives: each shard's valid rows over its surviving
        blocks, and its surviving non-empty blocks.  ``vpb`` is
        ``valid_per_block()`` on the same device."""
        nq = alive_pad.shape[0]
        vpb = vpb.reshape(self.n_shards, self.blocks_per_shard)
        alive = alive_pad.reshape(nq, self.n_shards, self.blocks_per_shard)
        sdist = (alive * vpb[None]).sum(dim=(0, 2))
        sblk = (alive & (vpb > 0)[None]).sum(dim=(0, 2))
        return sdist, sblk

    # --------------------------------------------------- living-corpus hooks

    def _clone_for(self, new_index: BSSIndex) -> "ShardedBSSIndex":
        """A shallow clone bound to a mutated index: it shares every shard's
        tensors until a hook gives a shard fresh ones."""
        clone = object.__new__(ShardedBSSIndex)
        clone.__dict__.update(self.__dict__)
        clone.index = new_index
        clone.shards = list(self.shards)
        clone._data16 = None if self._data16 is None else list(self._data16)
        return clone

    def extended(
        self,
        new_index: BSSIndex,
        tail_data: np.ndarray,
        tail_valid: np.ndarray,
        tail_boxes: np.ndarray,
        tail_perm: np.ndarray,
    ) -> "ShardedBSSIndex | None":
        """Put an append's fresh blocks into the empty padding blocks, which
        the contiguous partition parks at the end of the block axis.  When
        they fit, each shard they land on gets fresh tensors (a device-side
        clone with the new rows written in; only those rows cross from the
        host), the others are shared, no tensor changes shape and
        ``rows_per_shard`` stays.  Returns ``None`` when they do not fit:
        the block count must grow, which moves every chunk boundary, so the
        caller re-lays the index out lazily."""
        nb_new = tail_boxes.shape[0]
        start = self.index.n_blocks
        if nb_new > self.n_blocks_pad - start:
            return None
        block, rows, bps = self.index.block, self.rows_per_shard, self.blocks_per_shard
        clone = self._clone_for(new_index)
        r0, r1 = start * block, (start + nb_new) * block
        clone.perm = self.perm.copy()
        clone.perm[r0:r1] = tail_perm
        clone._host_data = self._host_data.copy()
        clone._host_data[r0:r1] = tail_data
        clone._valid = self._valid.copy()
        clone._valid[r0:r1] = tail_valid
        for s in range(start // bps, (start + nb_new - 1) // bps + 1):
            b_lo, b_hi = max(start, s * bps), min(start + nb_new, (s + 1) * bps)
            lo, hi = b_lo * block - s * rows, b_hi * block - s * rows  # shard rows
            t_lo, t_hi = (b_lo - start) * block, (b_hi - start) * block  # tail rows
            old, dev = self.shards[s], self.devices[s]
            data, boxes, valid = old.data.clone(), old.boxes.clone(), old.valid.clone()
            data[lo:hi] = torch.as_tensor(tail_data[t_lo:t_hi], device=dev)
            boxes[b_lo - s * bps:b_hi - s * bps] = torch.as_tensor(
                tail_boxes[b_lo - start:b_hi - start], device=dev)
            valid[lo:hi] = torch.as_tensor(tail_valid[t_lo:t_hi], device=dev)
            clone.shards[s] = old._replace(data=data, boxes=boxes, valid=valid)
            if self._data16 is not None:
                d16 = self._data16[s].clone()
                d16[lo:hi] = torch.as_tensor(bf16_round_np(tail_data[t_lo:t_hi]),
                                             device=dev).to(torch.bfloat16)
                clone._data16[s] = d16
        return clone

    def with_tombstones(self, new_index: BSSIndex, positions: np.ndarray) -> "ShardedBSSIndex":
        """Clear the valid bits of deleted slots: each shard that holds one
        gets a fresh valid mask (data, boxes and the bf16 mirror are shared —
        the engines mask by validity); ``perm`` gets the -1 sentinel."""
        positions = np.asarray(positions, np.int64)
        clone = self._clone_for(new_index)
        clone.perm = self.perm.copy()
        clone.perm[positions] = -1
        clone._valid = self._valid.copy()
        clone._valid[positions] = False
        shard_of = positions // self.rows_per_shard
        for s in np.unique(shard_of).tolist():
            local = positions[shard_of == s] - s * self.rows_per_shard
            old = self.shards[s]
            valid = old.valid.clone()
            valid[torch.as_tensor(local, device=valid.device)] = False
            clone.shards[s] = old._replace(valid=valid)
        return clone


def shard_bss(index: BSSIndex, mesh: ShardMesh) -> ShardedBSSIndex:
    """Partition a built index's blocks over ``mesh`` (the reference's
    ``shard_bss``): the :class:`ShardedBSSIndex` that
    ``sharded_query_batched`` and ``sharded_knn_batched`` serve, the view
    ``index.sharded(mesh)`` caches."""
    return index.sharded(mesh)


def _resolve(sidx: ShardedBSSIndex, opts, **legacy):
    """The options, the query tile and the backend; ``"cuda"`` is checked on
    every device of the mesh."""
    opts = resolve_engine_opts(opts, **legacy)
    bq = opts.bq if opts.bq is not None else _DEFAULT_BQ
    backends = {resolve_backend(opts.backend, dev) for dev in dict.fromkeys(sidx.devices)}
    return opts, bq, backends.pop()


def _shard_bounds(sidx: ShardedBSSIndex, metric: str, q_by: dict, backend: str) -> list:
    """Each shard's (Q, blocks_per_shard) planar bounds, on its device."""
    return [
        _fused_lower_bounds(metric, q_by[dev], sh.pivots, sh.pairs, sh.deltas, sh.boxes,
                            backend=backend)
        for sh, dev in zip(sidx.shards, sidx.devices)
    ]


def sharded_lower_bounds(sidx: ShardedBSSIndex, queries: np.ndarray,
                         backend: str = "torch") -> np.ndarray:
    """(Q, n_blocks) planar lower bounds over the real blocks, shard by
    shard (``bss_lower_bounds`` of a mesh-built index; the plain torch math
    by default, as there)."""
    index = sidx.index
    queries = _engine_queries(index.metric_name, np.asarray(queries, np.float32))
    lbs = _shard_bounds(sidx, _engine_metric(index.metric_name), sidx.per_device(queries),
                        backend)
    return sidx.merged(lbs).cpu().numpy()[:, :index.n_blocks]


# ---------------------------------------------------------------------------
# Range search
# ---------------------------------------------------------------------------


def _range_pass(sidx: ShardedBSSIndex, metric: str, queries: np.ndarray, t_vec: np.ndarray,
                *, bq: int, backend: str, eps: float | None = None):
    """Every shard's range pass, merged.  Each shard runs what the
    single-device engine runs for a dense batch: ``_query_batched`` on
    ``"cuda"``, the bound phase and ``_dense_hit_mask`` on ``"torch"``,
    ``_query_batched_bf16`` for bf16.  Returns, on the lead device, (hit
    (Q, n_pad), alive (Q, n_blocks_pad), tile_mask, and for bf16
    recheck_tiles (0-d) and band_counts (Q,), else None)."""
    block = sidx.index.block
    q_by, t_by = sidx.per_device(queries), sidx.per_device(t_vec)
    eps_by = None if eps is None else sidx.per_device(np.float32(eps))
    hits, alives, tmasks, rtiles, bands = [], [], [], [], []
    for s, (sh, dev) in enumerate(zip(sidx.shards, sidx.devices)):
        q, t = q_by[dev], t_by[dev]
        if eps is not None:
            hit, alive, tmask, rt, band = _query_batched_bf16(
                metric, q, t, sh, sidx.data16[s], eps_by[dev],
                block=block, bq=bq, backend=backend,
            )
            rtiles.append(rt)
            bands.append(band[:, None])
        elif backend == "torch":
            lb = _fused_lower_bounds(metric, q, sh.pivots, sh.pairs, sh.deltas, sh.boxes,
                                     backend=backend)
            alive = lb <= t[:, None]
            hit = _dense_hit_mask(metric, q, sh.data, sh.valid, alive, t, block=block)
            tmask = tile_survival(alive, bq)
        else:
            dist, alive, tmask = _query_batched(metric, q, t, sh, block=block, bq=bq,
                                                backend=backend)
            hit = dist <= t[:, None]
        hits.append(hit)
        alives.append(alive)
        tmasks.append(tmask)
    recheck = band_counts = None
    if eps is not None:
        recheck = sum(r.to(sidx.mesh.lead) for r in rtiles)
        band_counts = sidx.merged(bands).sum(dim=1)
    return (sidx.merged(hits), sidx.merged(alives), sidx.merged(tmasks), recheck,
            band_counts)


def _shard_stats(stats: dict, sidx: ShardedBSSIndex, sdist, sblk) -> dict:
    stats["n_shards"] = sidx.n_shards
    stats["shard_dists"] = np.asarray(sdist, np.int64)
    stats["shard_blocks"] = np.asarray(sblk, np.int64)
    return stats


def sharded_query_batched(
    sidx: ShardedBSSIndex,
    queries: np.ndarray,
    t,
    *,
    opts: EngineOpts | None = None,
    bq: int | None = None,
    backend: str | None = None,
    realisation: str | None = None,
    precision: str | None = None,
) -> tuple[list[list[int]], dict]:
    """Exact range search, one pass per shard (module docstring).

    Options travel as in ``bss_query_batched``; ``realisation`` is ignored
    — every shard runs the dense pass, as in the reference.  ``t`` is a
    scalar or a (Q,) vector of per-query radii (a negative radius, the
    serving front's padding, excludes its row everywhere).

    Hit lists (ids and order), ``alive``, the stats and the distance
    accounting are the single-device engine's on the same backend, bit for
    bit; the stats add ``n_shards``, ``shard_dists`` and ``shard_blocks``.
    ``precision="bf16"`` runs each shard's bf16 scan with its own fp32
    re-check of the band (a band cell's fp32 value lives on the shard that
    owns its block) and adds the re-check telemetry."""
    opts, bq, backend = _resolve(sidx, opts, bq=bq, backend=backend, realisation=realisation,
                                 precision=precision)
    precision = opts.precision
    index = sidx.index
    metric_eng = _engine_metric(index.metric_name)
    queries = _engine_queries(index.metric_name, np.asarray(queries, np.float32))
    nq = queries.shape[0]
    eps = index.bf16_margin() if precision == "bf16" else None
    if nq == 0:  # nothing for the devices: the epilogue over empty host tensors
        none = torch.zeros(0, dtype=torch.int64)
        hit, recheck, band_counts = (none, none), none.sum(), none
        alive = tmask = torch.zeros((0, sidx.n_blocks_pad), dtype=torch.bool)
    else:
        hit, alive, tmask, recheck, band_counts = _range_pass(
            sidx, metric_eng, queries, _per_query_t(t, nq), bq=bq, backend=backend,
            eps=eps)
    vpb = torch.as_tensor(sidx.valid_per_block(), device=alive.device)
    sdist, sblk = sidx.shard_work(alive, vpb)
    # padding columns survive no finite radius; the stats read the real ones
    nb = index.n_blocks
    results, stats = _range_epilogue(
        index, hit, alive[:, :nb], tmask[:, :nb], perm=sidx.perm, vpb=vpb[:nb],
        backend=backend, eps=eps, recheck_tiles=recheck, band_counts=band_counts,
        extra={"shard_dists": sdist, "shard_blocks": sblk}, engine="sharded",
    )
    stats["n_shards"] = sidx.n_shards
    return results, stats


# ---------------------------------------------------------------------------
# kNN
# ---------------------------------------------------------------------------


def _merge_top_k(sidx: ShardedBSSIndex, dists: list, k: int):
    """Each shard's top ``min(k, rows_per_shard)`` of its (Q, rows) block,
    positions made global, concatenated shard-major on the lead device and
    merged by a second top-k: (cand_idx (Q, k) global positions, cand_dist
    (Q, k) ascending)."""
    rows = sidx.rows_per_shard
    k_local = min(k, rows)
    idx, vals = [], []
    for s, dist in enumerate(dists):
        ci, cd = _top_k_smallest(dist, k_local)
        idx.append(ci + s * rows)
        vals.append(cd)
    sel, cand_dist = _top_k_smallest(sidx.merged(vals), k)
    return torch.gather(sidx.merged(idx), 1, sel), cand_dist


def _knn_round(sidx: ShardedBSSIndex, metric: str, q_by: dict, radii_by: dict, lbs: list,
               *, k: int, bq: int, backend: str, eps_by: dict | None = None):
    """One round over every shard (the reference's ``_knn_round_fn``, and
    with ``eps_by`` its ``_knn_round_bf16_fn``).  Returns (cand_idx,
    cand_dist, alive (Q, n_blocks_pad), recheck_tiles (0-d) and band_counts
    (Q,), all on the lead device; the last two None for fp32).  Nothing in
    a round waits for the host.

    bf16: the shards' bf16 candidates are merged into the GLOBAL bf16 kth
    first — a shard whose own kth16 is loose would re-check too little —
    and each shard re-checks the band ``d16 <= kth16 + 2 eps`` in fp32 over
    its own blocks; the fp32 values (+inf outside the band) feed the same
    merge, so the round equals the fp32 round bit for bit
    (``flat_index._knn_round_bf16``'s containment argument)."""
    block = sidx.index.block
    alives, tmasks = [], []
    for lb, dev in zip(lbs, sidx.devices):
        alive = lb <= radii_by[dev][:, None]
        alives.append(alive)
        tmasks.append(tile_survival(alive, bq))
    if eps_by is None:
        dists = [
            _masked_exact_dists(metric, q_by[dev], sh.data, sh.valid, tm, backend=backend,
                                block=block, bq=bq)
            for sh, dev, tm in zip(sidx.shards, sidx.devices, tmasks)
        ]
        return (*_merge_top_k(sidx, dists, k), sidx.merged(alives), None, None)
    d16s = [
        _masked_exact_dists(metric, q_by[dev], d16, sh.valid, tm, backend=backend,
                            block=block, bq=bq)
        for sh, dev, tm, d16 in zip(sidx.shards, sidx.devices, tmasks, sidx.data16)
    ]
    # only the kth value is needed, so any top-k does
    k_local = min(k, sidx.rows_per_shard)
    tops = [torch.topk(d16, k_local, dim=1, largest=False, sorted=False).values for d16 in d16s]
    kth16 = torch.topk(sidx.merged(tops), k, dim=1, largest=False,
                       sorted=False).values.amax(dim=1)
    eps = eps_by[sidx.mesh.lead]
    bthr = torch.where(torch.isfinite(kth16), kth16 + 2.0 * eps, torch.inf)
    dists, rtiles, bands = [], [], []
    for s, (sh, dev, tm) in enumerate(zip(sidx.shards, sidx.devices, tmasks)):
        d16 = d16s[s]
        d16s[s] = None  # freed before this shard's re-check allocates its own block
        band = (d16 <= bthr.to(dev)[:, None]) & torch.isfinite(d16)
        del d16
        band_blocks = band.reshape(band.shape[0], -1, block).any(dim=2)
        rmask = tile_survival(band_blocks, bq) & tm
        d32 = _masked_exact_dists(metric, q_by[dev], sh.data, sh.valid, rmask,
                                  backend=backend, block=block, bq=bq)
        dists.append(d32.masked_fill_(~band, torch.inf))
        rtiles.append(rmask.sum())
        bands.append(band.sum(dim=1, dtype=torch.int32)[:, None])
    cand_idx, cand_dist = _merge_top_k(sidx, dists, k)
    recheck = sum(r.to(sidx.mesh.lead) for r in rtiles)
    return cand_idx, cand_dist, sidx.merged(alives), recheck, sidx.merged(bands).sum(dim=1)


def sharded_knn_batched(
    sidx: ShardedBSSIndex,
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
    """Exact batched kNN over the sharded index (module docstring).

    Options as in ``bss_knn_batched``; ``realisation`` is ignored (every
    round is the dense masked pass).  The host loop follows
    ``bss_knn_batched`` step for step — the initial radius from the sorted
    real-block bounds (or ``r0``), the tighten-and-widen schedule, the
    exhaustive round after ``max_rounds`` — so the alive sets over the real
    blocks, the per-query counts, the ids, the distances and the rounds
    are the single-device engine's bit for bit.  Each round runs every
    shard's masked exact phase and top-k, merged on the lead device.
    ``precision="bf16"`` runs the bf16 round (``_knn_round``) with the same
    results and adds the re-check telemetry.

    Returns (ids (Q, k), dists (Q, k), stats) as ``bss_knn_batched``, the
    stats with ``n_shards``, ``shard_dists`` and ``shard_blocks`` summed
    over the rounds."""
    opts, bq, backend = _resolve(sidx, opts, bq=bq, backend=backend, realisation=realisation,
                                 precision=precision)
    precision = opts.precision
    index = sidx.index
    metric_eng = _engine_metric(index.metric_name)
    queries = _engine_queries(index.metric_name, np.asarray(queries, np.float32))
    nq = queries.shape[0]
    k = int(k)
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    k_run = min(k, index.n_valid)
    if nq == 0 or k_run == 0:
        stats = _knn_empty_stats(index, nq, precision, backend, engine="sharded")
        zero = np.zeros(sidx.n_shards, np.int64)
        _shard_stats(stats, sidx, zero, zero)
        return (np.full((nq, k), -1, np.int64), np.full((nq, k), np.inf, np.float32), stats)
    q_by = sidx.per_device(queries)
    n_blocks = index.n_blocks

    # radius-independent bounds, once, kept on each shard's device; the
    # host copy of the real columns drives the single-device schedule
    lbs = _shard_bounds(sidx, metric_eng, q_by, backend)
    lb_sorted = np.sort(sidx.merged(lbs).cpu().numpy()[:, :n_blocks], axis=1)
    if r0 is None:
        j0 = min(n_blocks - 1, max(0, math.ceil(2 * k / index.block) - 1))
        radii = lb_sorted[:, j0].astype(np.float32)
    else:
        radii = np.full(nq, float(r0), np.float32)

    bf16 = precision == "bf16"
    eps = index.bf16_margin() if bf16 else 0.0
    eps_by = sidx.per_device(np.float32(eps)) if bf16 else None
    valid_pb = _valid_per_block(index)
    total_exact = np.zeros(nq, np.int64)
    excl_pq = np.zeros(nq, np.int64)
    # a finished query's radius is -1 from the next round on, so its rows
    # survive no block and the shard sums agree with the frozen tallies
    shard_dists = np.zeros(sidx.n_shards, np.int64)
    shard_blocks = np.zeros(sidx.n_shards, np.int64)
    vpb_pad = torch.from_numpy(sidx.valid_per_block())
    tiles_total = 0
    recheck_pq = np.zeros(nq, np.int64)
    recheck_tiles_total = 0
    done = np.zeros(nq, bool)
    cand_idx = np.full((nq, k_run), 0, np.int64)
    cand_dist = np.full((nq, k_run), np.inf, np.float32)
    rounds = 0
    for rounds in range(1, max_rounds + 2):
        if rounds == max_rounds + 1:
            radii = np.where(done, radii, np.inf).astype(np.float32)
        ci, cd, alive_dev, rtiles, band_counts = _knn_round(
            sidx, metric_eng, q_by, sidx.per_device(radii), lbs,
            k=k_run, bq=bq, backend=backend, eps_by=eps_by,
        )
        ci, cd, alive_pad = ci.cpu().numpy(), cd.cpu().numpy(), alive_dev.cpu().numpy()
        if bf16:
            recheck_tiles_total += int(rtiles)
            recheck_pq += np.where(~done, band_counts.cpu().numpy(), 0)
        sdist, sblk = sidx.shard_work(torch.from_numpy(alive_pad), vpb_pad)
        shard_dists += sdist.numpy()
        shard_blocks += sblk.numpy()
        # the real columns: the single-device alive set (padding survives
        # only the radius-inf round, and holds no valid row)
        alive = alive_pad[:, :n_blocks]
        kth = cd[:, -1]
        dn = np.isfinite(kth) & ((kth <= radii) | alive.all(axis=1))
        upd = ~done  # finished queries are frozen
        cand_idx[upd] = ci[upd]
        cand_dist[upd] = cd[upd]
        total_exact[upd] += alive[upd].astype(np.int64) @ valid_pb
        excl_pq[upd] += n_blocks - alive[upd].sum(axis=1)
        tiles_total += _tiles_computed(alive, bq)
        done = done | dn
        if done.all():
            break
        # bss_knn_batched's tighten-and-widen schedule
        n_alive = alive.sum(axis=1)
        j_next = np.minimum(
            n_blocks - 1,
            np.maximum(np.maximum(2 * n_alive, n_alive + 1), 1),
        )
        widened = np.maximum(lb_sorted[np.arange(nq), j_next], radii * growth)
        radii = np.where(
            done, np.float32(-1.0),
            np.where(np.isfinite(kth), np.minimum(kth, widened), widened),
        ).astype(np.float32)
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
        "excluded": {"hilbert": excl_pq},
    }
    _shard_stats(stats, sidx, shard_dists, shard_blocks)
    if bf16:
        _bf16_stats(stats, eps, recheck_tiles_total, recheck_pq)
    stats = _finish_stats(stats, kind="knn", backend=backend, engine="sharded")
    orig = np.where(np.isfinite(cand_dist), sidx.perm[cand_idx], -1)
    if k_run < k:  # corpus smaller than k: pad out to the requested width
        orig = np.pad(orig, ((0, 0), (0, k - k_run)), constant_values=-1)
        cand_dist = np.pad(cand_dist, ((0, 0), (0, k - k_run)), constant_values=np.inf)
    return orig, cand_dist, stats
