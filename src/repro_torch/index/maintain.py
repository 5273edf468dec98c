"""Incremental maintenance of the blocked BSS index, a living corpus — the
port of ``repro.index.maintain`` with the same names, accounting and
results.

* :func:`append` packs new rows into FRESH blocks against the EXISTING
  pivots and planes: ``m x P`` pivot distances for ``m`` new rows, never a
  rebuild.  The new rows get their own median-split permutation; existing
  blocks are untouched.  A live device mirror grows by ``torch.cat`` of the
  new blocks only, and so does a live bf16 mirror, from the host-rounded
  tail; the bf16 margin is dropped (new rows can raise the corpus max) and
  measured again on the next bf16 query.
* :func:`delete` tombstones rows: the slot's ``valid`` bit clears and its
  ``perm`` entry becomes -1.  Boxes are left alone (a box over a superset
  of the live rows only loosens the bound, which is sound).  The bf16
  mirror and its margin stay: the data did not change, and a margin over a
  superset of the live rows is still sound.
* :func:`compact` re-permutes the live rows into a fresh layout.  With
  ``refresh_pivots=True`` it reruns the whole build over the live rows in
  ascending-id order with the index's seed: field for field the index a
  fresh ``build_bss`` over those rows gives (ids mapped through the live-id
  table).  Both bf16 fields are dropped.  :func:`maybe_compact` is the
  threshold policy.

Every mutation returns a NEW ``BSSIndex`` and a :class:`MutationStats`,
shares the unchanged arrays and bumps ``generation``.  No mutation writes
into a tensor of the generation it came from, so a query in flight on the
old generation keeps reading its own arrays.  At every generation the fp32,
bf16 and oracle paths agree bit for bit on hits, kNN results and per-query
distance counts.

The sharded branches of the reference have no counterpart yet (ROADMAP
Queue 1 item 6): the port's index carries no mesh (``build_bss`` refuses
one), and ``MutationStats.sharded_in_place`` stays ``False``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from repro_torch.core.flat_index import (
    _MIN_NORM,
    BSSDeviceArrays,
    BSSIndex,
    _build_engine_index,
    _engine_metric,
    _pack_blocks,
    _project_all,
    _split_perm,
)
from repro_torch.core.npdist import pairwise_np
from repro_torch.core.precision import bf16_round_np

__all__ = [
    "MutationStats",
    "append",
    "delete",
    "compact",
    "maybe_compact",
]


@dataclasses.dataclass(frozen=True)
class MutationStats:
    """What one mutation did and what it cost.

    ``table_dists`` counts the host-side reference-table distance
    evaluations: ``rows x n_pivots`` for append (new rows only), 0 for
    delete, the live-corpus projection cost for compact."""

    op: str                    # "append" | "delete" | "compact"
    generation: int            # the NEW index's generation
    rows: int                  # rows appended / deleted / re-packed
    table_dists: int           # host reference-table distance evaluations
    n_blocks: int              # the NEW index's block count
    tombstone_frac: float      # the NEW index's tombstone fraction
    new_blocks: int = 0        # append: blocks added
    sharded_in_place: bool = False  # append: sharded mirror spliced (no sharding yet)
    refreshed_pivots: bool = False  # compact: pivot tables re-derived


def _engine_rows(index: BSSIndex, rows: np.ndarray) -> np.ndarray:
    """Raw input rows in the index's engine space — the ops (and bits) of
    ``build_bss``'s corpus-side mapping."""
    rows = np.asarray(rows, np.float32)
    if rows.ndim != 2 or rows.shape[1] != index.data.shape[1]:
        raise ValueError(
            f"rows must have shape (m, {index.data.shape[1]}), got "
            f"{rows.shape}"
        )
    if index.metric_name == "cosine":
        norms = np.linalg.norm(rows, axis=1, keepdims=True)
        rows = rows / np.maximum(norms, _MIN_NORM)
    return rows


def _layout_rows(
    index: BSSIndex, rows: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Lay engine-space rows out against the index's EXISTING pivots and
    planes with ``build_bss``'s own helpers, over the new rows only.
    Returns ``(perm, data_pad, valid, boxes, table_dists)``: ``perm`` orders
    the INPUT rows, ``table_dists`` is the pivot-distance count."""
    build_metric = _engine_metric(index.metric_name)
    dp = pairwise_np(build_metric, rows, index.pivots).astype(np.float32)
    x, y = _project_all(dp, index.pairs, index.deltas)
    feats = np.concatenate([x, y], axis=1)
    perm = _split_perm(feats, index.block)
    data_pad, valid, boxes = _pack_blocks(
        rows[perm], x[perm], y[perm], index.block
    )
    return perm, data_pad, valid, boxes, int(dp.size)


def append(
    index: BSSIndex, rows: np.ndarray
) -> tuple[BSSIndex, MutationStats]:
    """Append ``rows`` as fresh blocks; returns ``(new_index, stats)``.

    The new rows get original ids ``[index.next_id, index.next_id + m)``,
    are laid out against the existing pivots and follow the current
    blocks.  Live device mirrors are extended by the new blocks, not
    rebuilt; the old generation's tensors are left as they were."""
    rows = _engine_rows(index, rows)
    m = rows.shape[0]
    if m == 0:
        raise ValueError("append needs at least one row")
    perm_new, tail_data, tail_valid, tail_boxes, table_dists = _layout_rows(
        index, rows
    )
    ids = index.next_id + np.arange(m, dtype=np.int64)
    pad = tail_valid.shape[0] - m
    tail_perm = np.concatenate(
        [ids[perm_new], np.full(pad, -1, dtype=np.int64)]
    )

    new = dataclasses.replace(
        index,
        data=np.concatenate([index.data, tail_data]),
        perm=np.concatenate([index.perm, tail_perm]),
        valid=np.concatenate([index.valid, tail_valid]),
        boxes=np.concatenate([index.boxes, tail_boxes]),
        generation=index.generation + 1,
        next_id=index.next_id + m,
        _device=None,
        _bf16=None,
        # the margin is a corpus max and new rows can raise it: measured
        # again on the new generation's first bf16 query
        _bf16_eps=None,
    )

    # only the new blocks cross host -> device; torch.cat makes new tensors
    dev = index.torch_device
    if index._device is not None:
        old = index._device
        new._device = BSSDeviceArrays(
            data=torch.cat([old.data, torch.as_tensor(tail_data, device=dev)]),
            pivots=old.pivots,
            pairs=old.pairs,
            deltas=old.deltas,
            boxes=torch.cat([old.boxes, torch.as_tensor(tail_boxes, device=dev)]),
            valid=torch.cat([old.valid, torch.as_tensor(tail_valid, device=dev)]),
        )
    if index._bf16 is not None:
        # rounded on the host, as ``device_bf16`` rounds the whole corpus
        tail16 = torch.as_tensor(bf16_round_np(tail_data), device=dev)
        new._bf16 = torch.cat([index._bf16, tail16.to(torch.bfloat16)])

    return new, MutationStats(
        op="append",
        generation=new.generation,
        rows=m,
        table_dists=table_dists,
        n_blocks=new.n_blocks,
        tombstone_frac=new.tombstone_frac,
        new_blocks=tail_boxes.shape[0],
    )


def delete(
    index: BSSIndex, ids: Iterable[int]
) -> tuple[BSSIndex, MutationStats]:
    """Tombstone rows by ORIGINAL id; returns ``(new_index, stats)``.

    A deleted slot clears its ``valid`` bit (the masked exact phases, the
    hit test and the per-block distance accounting read it) and its
    ``perm`` entry becomes -1.  Unknown or already-deleted ids raise
    ``ValueError``: a delete asserts a live row, and ignoring a stale id
    would hide a double delete in the caller."""
    want = np.asarray(list(ids), dtype=np.int64)
    if want.size == 0:
        raise ValueError("delete needs at least one id")
    if np.unique(want).size != want.size:
        raise ValueError("duplicate ids in one delete")
    # original id -> slot position (live rows only)
    live_pos = np.nonzero(index.valid)[0]
    live_ids = index.perm[live_pos]
    id2pos = np.full(index.next_id, -1, dtype=np.int64)
    id2pos[live_ids] = live_pos
    bad = (want < 0) | (want >= index.next_id)
    if bad.any():
        raise ValueError(f"unknown ids: {want[bad].tolist()}")
    pos = id2pos[want]
    dead = pos < 0
    if dead.any():
        raise ValueError(
            f"ids not live (unknown or already deleted): "
            f"{want[dead].tolist()}"
        )

    valid = index.valid.copy()
    valid[pos] = False
    perm = index.perm.copy()
    perm[pos] = -1
    new = dataclasses.replace(
        index,
        perm=perm,
        valid=valid,
        generation=index.generation + 1,
        tombstones=index.tombstones + int(want.size),
        _device=None,
        # data is untouched: the bf16 mirror stays valid, and the old
        # margin (a max over a SUPERSET of the live rows) stays sound
        _bf16=index._bf16,
        _bf16_eps=index._bf16_eps,
    )
    if index._device is not None:
        dev_valid = index._device.valid.clone()
        # in place on the clone this call made: the old generation's mask
        # is never written, so a query in flight on it reads its own bits
        dev_valid[torch.as_tensor(pos, device=dev_valid.device)] = False
        new._device = index._device._replace(valid=dev_valid)

    return new, MutationStats(
        op="delete",
        generation=new.generation,
        rows=int(want.size),
        table_dists=0,
        n_blocks=new.n_blocks,
        tombstone_frac=new.tombstone_frac,
    )


def compact(
    index: BSSIndex, *, refresh_pivots: bool = True
) -> tuple[BSSIndex, MutationStats]:
    """Re-permute the live rows into a fresh tight layout; returns
    ``(new_index, stats)``.  Original ids survive (``next_id`` too, so new
    ids never collide with old ones); tombstones reset.

    ``refresh_pivots=True`` reruns the whole build over the live rows in
    ascending-id order with the index's seed — field for field the fresh
    ``build_bss`` over those rows.  ``refresh_pivots=False`` keeps the
    pivots and planes and only re-permutes and re-packs."""
    live_pos = np.nonzero(index.valid)[0]
    m = live_pos.size
    if m == 0:
        raise ValueError("compact needs at least one live row")
    live_ids = index.perm[live_pos]
    order = np.argsort(live_ids)
    ids_sorted = live_ids[order]
    rows = index.data[live_pos[order]]  # engine space, ascending id

    if refresh_pivots:
        built = _build_engine_index(
            index.metric_name, rows,
            n_pivots=index.pivots.shape[0],
            n_pairs=index.pairs.shape[0],
            block=index.block, seed=index.seed, device=index.torch_device,
        )
        perm = built.perm
        data_pad, valid, boxes = built.data, built.valid, built.boxes
        pivots, pairs, deltas = built.pivots, built.pairs, built.deltas
        # FFT selection evaluates O(m P) candidate distances plus the m P
        # projection table: both halves are charged
        table_dists = 2 * m * index.pivots.shape[0]
    else:
        perm_rows, data_pad, valid, boxes, table_dists = _layout_rows(
            index, rows
        )
        pad = valid.shape[0] - m
        perm = np.concatenate(
            [perm_rows, np.full(pad, -1, dtype=np.int64)]
        )
        pivots, pairs, deltas = index.pivots, index.pairs, index.deltas

    # row positions -> original ids
    perm_ids = np.where(perm >= 0, ids_sorted[np.clip(perm, 0, m - 1)], -1)
    new = dataclasses.replace(
        index,
        data=data_pad,
        perm=perm_ids,
        valid=valid,
        pivots=pivots,
        pairs=pairs,
        deltas=deltas,
        boxes=boxes,
        generation=index.generation + 1,
        tombstones=0,
        _device=None,
        _bf16=None,
        _bf16_eps=None,
    )
    return new, MutationStats(
        op="compact",
        generation=new.generation,
        rows=m,
        table_dists=int(table_dists),
        n_blocks=new.n_blocks,
        tombstone_frac=0.0,
        refreshed_pivots=refresh_pivots,
    )


def maybe_compact(
    index: BSSIndex,
    *,
    max_tombstone_frac: float = 0.25,
    max_block_growth: float = 2.0,
    block_exclusion_rate: float | None = None,
    min_block_exclusion_rate: float = 0.5,
    refresh_pivots: bool | None = None,
) -> tuple[BSSIndex, MutationStats | None]:
    """Compact when the layout has degraded; returns ``(index, stats)``
    with ``stats=None`` (and the same index) when it has not.

    Triggers: a tombstone fraction above ``max_tombstone_frac``, or more
    than ``max_block_growth`` times the blocks the live rows need.  The
    pivots are re-derived when the measured ``block_exclusion_rate`` has
    sunk below ``min_block_exclusion_rate``; ``refresh_pivots`` forces the
    choice either way."""
    n_live = index.n_valid
    min_blocks = max(1, -(-n_live // index.block))
    degraded = (
        index.tombstone_frac > max_tombstone_frac
        or index.n_blocks > max_block_growth * min_blocks
    )
    if not degraded:
        return index, None
    if refresh_pivots is None:
        refresh_pivots = (
            block_exclusion_rate is not None
            and block_exclusion_rate < min_block_exclusion_rate
        )
    return compact(index, refresh_pivots=refresh_pivots)
