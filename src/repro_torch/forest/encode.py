"""Flatten host-built partition trees into device-resident level tables —
the port of ``repro.forest.encode``.

The host trees (``core/tree.py``'s 12 variants, ``core/lrt.py``'s monotone
family) are pointer-chasing Python structures.  This module re-encodes a
built tree as structure-of-arrays **level tables**: the nodes of one depth
side by side, padded to the level's widest arity with validity masks, each
child pointing at its (parent position, parent slot) one level up, and one
global leaf-bucket table whose rows, padded to the kernel block, are the
corpus of the leaf phase's masked tile.

The host tables are numpy arrays built by the reference's code, equal array
for array to ``repro.forest.encode_tree`` / ``encode_monotone`` on the same
tree (``tests/test_torch_forest.py``).  The monotone levels also carry
cos(theta) and sin(theta), computed here once in float64 and rounded to
float32, so every device rotates the plane with the same bits.

``.device`` mirrors the tables onto ``torch_device`` once (gather indices as
int64); ``encode_tree(tree, device=None)`` builds for the CUDA device and
raises without one, as ``build_bss`` does.  ``leaf_bf16`` is the bfloat16
leaf mirror of the bf16 leaf phase and ``bf16_eps()`` its comparison margin
(``repro_torch.core.precision``).  ``forest_from_arrays`` rebuilds an
encoding from another encoder's host tables, so the port can walk the very
tree the JAX package encoded.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.flat_index import resolve_device
from repro_torch.core.lrt import MonotoneTree, _MNode
from repro_torch.core.precision import bf16_margin as _bf16_margin
from repro_torch.core.tree import PartitionTree, _Node
from repro_torch.kernels.tiles import TILE_BLOCK

__all__ = [
    "EncodedForest",
    "EncodedMonotone",
    "encode_tree",
    "encode_monotone",
    "forest_from_arrays",
]


# ---------------------------------------------------------------------------
# device mirrors
# ---------------------------------------------------------------------------


class LevelDev(NamedTuple):
    """One depth of an n-ary partition tree on the device."""

    na: int                         # nodes at this level
    kmax: int                       # the level's widest arity
    any_centre: bool                # some node has a centre witness
    ref_valid: torch.Tensor         # (Na, kmax) bool
    n_refs: torch.Tensor            # (Na,) int32 true arity (the distance count)
    ref_dists: torch.Tensor         # (Na, kmax, kmax) f32, 0 at padded slots
    centre_dists: torch.Tensor      # (Na, kmax) f32, NaN where absent
    centre_on: torch.Tensor         # (Na,) bool
    cover_r: torch.Tensor           # (Na, kmax) f32
    parent_pos: torch.Tensor        # (Na,) int64 position in the previous level
    parent_slot: torch.Tensor       # (Na,) int64 ref slot in the parent
    ref_data: torch.Tensor          # (rows_pad, dim) f32 node-major refs
    node_of_row: torch.Tensor       # (rows_pad,) int64 owning node, -1 in the tail
    leaf_parent_pos: torch.Tensor   # (n_leaves_l,) int64
    leaf_parent_slot: torch.Tensor  # (n_leaves_l,) int64


class LeafDev(NamedTuple):
    """The global leaf-bucket table of both walkers (ids root-attached
    first, then level by level: the walk relies on it)."""

    leaf_len: torch.Tensor     # (n_leaves,) int32 true bucket size
    leaf_data: torch.Tensor    # (rows_pad, dim) f32 leaf-major members
    leaf_valid: torch.Tensor   # (rows_pad,) bool
    leaf_of_row: torch.Tensor  # (rows_pad,) int64 owning leaf, -1 in the tail


class ForestDev(NamedTuple):
    levels: tuple  # tuple[LevelDev, ...]
    leaves: LeafDev


class MLevelDev(NamedTuple):
    """One depth of a monotone binary tree (one fresh pivot per node)."""

    na: int
    delta: torch.Tensor       # (Na,) f32 d(p1, p2)
    cos_theta: torch.Tensor   # (Na,) f32
    sin_theta: torch.Tensor   # (Na,) f32
    h: torch.Tensor           # (Na,) f32
    nx: torch.Tensor          # (Na,) f32
    ny: torch.Tensor          # (Na,) f32
    split: torch.Tensor       # (Na,) f32
    parent_pos: torch.Tensor  # (Na,) int64
    parent_right: torch.Tensor  # (Na,) bool
    p2_data: torch.Tensor     # (rows_pad, dim) f32 fresh-pivot vectors
    p2_owner: torch.Tensor    # (rows_pad,) int64 row -> node, -1 in the tail
    leaf_parent_pos: torch.Tensor    # (n_leaves_l,) int64
    leaf_parent_right: torch.Tensor  # (n_leaves_l,) bool


class MonotoneDev(NamedTuple):
    root_p1_data: torch.Tensor  # (1, dim) f32
    levels: tuple  # tuple[MLevelDev, ...]
    leaves: LeafDev


# ---------------------------------------------------------------------------
# host tables (the reference's code)
# ---------------------------------------------------------------------------


def _pad_rows(a: np.ndarray, mult: int) -> np.ndarray:
    rem = a.shape[0] % mult
    if rem == 0:
        return a
    return np.concatenate(
        [a, np.zeros((mult - rem,) + a.shape[1:], a.dtype)], axis=0
    )


def _leaf_pad_width(max_len: int) -> int:
    """Bucket slot width: the next power of two up to the kernel block, then
    whole blocks (the row -> leaf map is per row, so any width is correct;
    powers of two keep the padding low)."""
    if max_len <= 0:
        return 1
    width = 1 << (max_len - 1).bit_length()
    if width > TILE_BLOCK:
        width = -(-max_len // TILE_BLOCK) * TILE_BLOCK
    return width


@dataclasses.dataclass
class _LeafTable:
    """Host leaf tables and the flat member map of result assembly."""

    members: np.ndarray       # (n_leaves, leaf_pad) int64, -1 pad
    lens: np.ndarray          # (n_leaves,) int32
    member_of_row: np.ndarray  # (rows_pad,) int64 original id, -1 pad/tail
    data: np.ndarray          # (rows_pad, dim) f32
    valid: np.ndarray         # (rows_pad,) bool
    leaf_of_row: np.ndarray   # (rows_pad,) int32

    @property
    def n_leaves(self) -> int:
        return self.members.shape[0]


def _build_leaf_table(leaves: list[np.ndarray], data32: np.ndarray) -> _LeafTable:
    dim = data32.shape[1]
    if leaves:
        pad = _leaf_pad_width(max(len(lf) for lf in leaves))
        members = np.full((len(leaves), pad), -1, dtype=np.int64)
        for i, lf in enumerate(leaves):
            members[i, : len(lf)] = lf
    else:
        members = np.zeros((0, 1), dtype=np.int64)
    lens = (members >= 0).sum(axis=1).astype(np.int32)
    flat = members.reshape(-1)
    n_rows = flat.shape[0]
    rows_pad = max(-(-max(n_rows, 1) // TILE_BLOCK) * TILE_BLOCK, TILE_BLOCK)
    member_of_row = np.full(rows_pad, -1, dtype=np.int64)
    member_of_row[:n_rows] = flat
    leaf_of_row = np.full(rows_pad, -1, dtype=np.int32)
    if members.shape[0]:
        leaf_of_row[:n_rows] = np.repeat(
            np.arange(members.shape[0], dtype=np.int32), members.shape[1]
        )
    valid = member_of_row >= 0
    ldata = np.zeros((rows_pad, dim), np.float32)
    ldata[valid] = data32[member_of_row[valid]]
    return _LeafTable(members, lens, member_of_row, ldata, valid, leaf_of_row)


@dataclasses.dataclass
class _Level:
    ref_idx: np.ndarray       # (Na, kmax) int64, -1 pad
    ref_valid: np.ndarray
    n_refs: np.ndarray
    ref_dists: np.ndarray
    centre_dists: np.ndarray
    centre_on: np.ndarray
    cover_r: np.ndarray
    parent_pos: np.ndarray
    parent_slot: np.ndarray
    ref_data: np.ndarray
    node_of_row: np.ndarray
    leaf_parent_pos: np.ndarray
    leaf_parent_slot: np.ndarray


def _tensor(a, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


def _leaf_dev(leaf: _LeafTable, dev: torch.device) -> LeafDev:
    return LeafDev(
        leaf_len=_tensor(leaf.lens, torch.int32, dev),
        leaf_data=_tensor(leaf.data, torch.float32, dev),
        leaf_valid=_tensor(leaf.valid, torch.bool, dev),
        leaf_of_row=_tensor(leaf.leaf_of_row, torch.int64, dev),
    )


class _Mirrors:
    """The device mirror, the bf16 leaf mirror and its margin, each made
    once per encoding on ``torch_device``.

    Only the leaf data gets a bf16 twin: the walk's exclusion predicates and
    their tables stay fp32, so pruning decisions and the analytic distance
    counts do not depend on the precision.  The margin is measured over the
    valid leaf rows only."""

    @property
    def leaf_bf16(self) -> torch.Tensor:
        if self._leaf16 is None:
            self._leaf16 = self.device.leaves.leaf_data.to(torch.bfloat16)
        return self._leaf16

    def bf16_eps(self) -> float:
        if self._bf16_eps is None:
            self._bf16_eps = _bf16_margin(
                self.metric, self.leaf.data, self.leaf.valid
            )
        return self._bf16_eps

    @property
    def device(self):
        if self._device is None:
            self._device = self._mirror(self.torch_device)
        return self._device


@dataclasses.dataclass
class EncodedForest(_Mirrors):
    """Array encoding of a ``PartitionTree`` (any of the 12 variants)."""

    variant: str
    metric: str
    n_points: int
    levels: list[_Level]
    leaf: _LeafTable
    # where the device mirror lives; None resolves to the CUDA device
    torch_device: torch.device | None = dataclasses.field(
        default=None, compare=False
    )
    _device: ForestDev | None = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _leaf16: torch.Tensor | None = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _bf16_eps: float | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def __post_init__(self):
        self.torch_device = resolve_device(self.torch_device)

    @property
    def n_nodes(self) -> int:
        return sum(lv.n_refs.shape[0] for lv in self.levels)

    def _mirror(self, dev: torch.device) -> ForestDev:
        return ForestDev(
            levels=tuple(
                LevelDev(
                    na=int(lv.ref_valid.shape[0]),
                    kmax=int(lv.ref_valid.shape[1]),
                    any_centre=bool(np.any(lv.centre_on)),
                    ref_valid=_tensor(lv.ref_valid, torch.bool, dev),
                    n_refs=_tensor(lv.n_refs, torch.int32, dev),
                    ref_dists=_tensor(lv.ref_dists, torch.float32, dev),
                    centre_dists=_tensor(lv.centre_dists, torch.float32, dev),
                    centre_on=_tensor(lv.centre_on, torch.bool, dev),
                    cover_r=_tensor(lv.cover_r, torch.float32, dev),
                    parent_pos=_tensor(lv.parent_pos, torch.int64, dev),
                    parent_slot=_tensor(lv.parent_slot, torch.int64, dev),
                    ref_data=_tensor(lv.ref_data, torch.float32, dev),
                    node_of_row=_tensor(lv.node_of_row, torch.int64, dev),
                    leaf_parent_pos=_tensor(lv.leaf_parent_pos, torch.int64, dev),
                    leaf_parent_slot=_tensor(lv.leaf_parent_slot, torch.int64, dev),
                )
                for lv in self.levels
            ),
            leaves=_leaf_dev(self.leaf, dev),
        )


def encode_tree(tree: PartitionTree, device=None) -> EncodedForest:
    """Breadth-first flatten of a built ``PartitionTree`` (the reference's
    ``encode_tree``).  Leaf ids are assigned root-attached first, then
    level by level in node order: the walk concatenates its per-level leaf
    survival in exactly that order.  ``device`` as in ``build_bss``."""
    data32 = np.asarray(tree.data, np.float32)

    # the degenerate k == 0 wrapper (tiny-dataset root) evaluates no
    # distances in the host walk: hoist its children
    leaves: list[np.ndarray] = []
    frontier: list[tuple[_Node, int, int]] = []  # (node, parent_pos, slot)

    def _intake(child, parent_pos: int, slot: int, nxt, leaf_edges):
        if child is None:
            return
        if isinstance(child, np.ndarray):
            if len(child):
                leaves.append(np.asarray(child, np.int64))
                leaf_edges.append((parent_pos, slot))
            return
        nxt.append((child, parent_pos, slot))

    root = tree.root
    if len(root.ref_idx) == 0:
        root_edges: list = []  # root-attached leaves are always alive
        for ch in root.children:
            _intake(ch, -1, -1, frontier, root_edges)
    else:
        frontier = [(root, -1, -1)]

    levels: list[_Level] = []
    while frontier:
        nodes = [n for n, _, _ in frontier]
        na = len(nodes)
        kmax = max(len(n.ref_idx) for n in nodes)
        ref_idx = np.full((na, kmax), -1, dtype=np.int64)
        ref_dists = np.zeros((na, kmax, kmax), np.float32)
        centre_dists = np.full((na, kmax), np.nan, np.float32)
        cover_r = np.zeros((na, kmax), np.float32)
        parent_pos = np.array([p for _, p, _ in frontier], dtype=np.int32)
        parent_slot = np.array([s for _, _, s in frontier], dtype=np.int32)
        centre_on = np.zeros(na, bool)
        nxt: list[tuple[_Node, int, int]] = []
        leaf_edges: list[tuple[int, int]] = []
        for i, node in enumerate(nodes):
            k = len(node.ref_idx)
            ref_idx[i, :k] = node.ref_idx
            ref_dists[i, :k, :k] = node.ref_dists
            centre_dists[i, :k] = node.centre_dists
            cover_r[i, :k] = node.cover_r
            centre_on[i] = not np.any(np.isnan(node.centre_dists))
            for j, child in enumerate(node.children):
                _intake(child, i, j, nxt, leaf_edges)
        ref_valid = ref_idx >= 0
        rows = np.where(ref_valid, ref_idx, 0).reshape(-1)
        ref_data = _pad_rows(
            np.where(
                ref_valid.reshape(-1, 1), data32[rows], np.float32(0.0)
            ).astype(np.float32),
            TILE_BLOCK,
        )
        node_of_row = np.full(ref_data.shape[0], -1, dtype=np.int32)
        node_of_row[: na * kmax] = np.repeat(
            np.arange(na, dtype=np.int32), kmax
        )
        levels.append(
            _Level(
                ref_idx=ref_idx,
                ref_valid=ref_valid,
                n_refs=ref_valid.sum(axis=1).astype(np.int32),
                ref_dists=ref_dists,
                centre_dists=centre_dists,
                centre_on=centre_on,
                cover_r=cover_r,
                parent_pos=parent_pos,
                parent_slot=parent_slot,
                ref_data=ref_data,
                node_of_row=node_of_row,
                leaf_parent_pos=np.array(
                    [p for p, _ in leaf_edges], dtype=np.int32
                ),
                leaf_parent_slot=np.array(
                    [s for _, s in leaf_edges], dtype=np.int32
                ),
            )
        )
        frontier = nxt

    return EncodedForest(
        variant=tree.variant,
        metric=tree.metric,
        n_points=int(tree.data.shape[0]),
        levels=levels,
        leaf=_build_leaf_table(leaves, data32),
        torch_device=device,
    )


# ---------------------------------------------------------------------------
# monotone family
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _MLevel:
    p2_idx: np.ndarray        # (Na,) int64
    delta: np.ndarray
    theta: np.ndarray
    h: np.ndarray
    nx: np.ndarray
    ny: np.ndarray
    split: np.ndarray
    parent_pos: np.ndarray
    parent_right: np.ndarray
    p2_data: np.ndarray
    p2_valid: np.ndarray
    leaf_parent_pos: np.ndarray
    leaf_parent_right: np.ndarray
    # cos(theta), sin(theta): float64 on the host, rounded once to float32
    cos_theta: np.ndarray = None
    sin_theta: np.ndarray = None

    def __post_init__(self):
        theta = np.asarray(self.theta, np.float32).astype(np.float64)  # lint: disable=R3
        if self.cos_theta is None:
            self.cos_theta = np.cos(theta).astype(np.float32)
        if self.sin_theta is None:
            self.sin_theta = np.sin(theta).astype(np.float32)


@dataclasses.dataclass
class EncodedMonotone(_Mirrors):
    """Array encoding of a ``MonotoneTree`` (closer / median / pca / lrt)."""

    partition: str
    select: str
    metric: str
    n_points: int
    root_p1: int
    root_p1_data: np.ndarray  # (1, dim) f32
    levels: list[_MLevel]
    leaf: _LeafTable
    torch_device: torch.device | None = dataclasses.field(
        default=None, compare=False
    )
    _device: MonotoneDev | None = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _leaf16: torch.Tensor | None = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _bf16_eps: float | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def __post_init__(self):
        self.torch_device = resolve_device(self.torch_device)

    @property
    def n_nodes(self) -> int:
        return sum(lv.delta.shape[0] for lv in self.levels)

    def _mirror(self, dev: torch.device) -> MonotoneDev:
        def level(lv: _MLevel) -> MLevelDev:
            rows = lv.p2_valid.shape[0]
            owner = np.where(lv.p2_valid, np.arange(rows), -1)
            f32 = {name: _tensor(getattr(lv, name), torch.float32, dev)
                   for name in ("delta", "cos_theta", "sin_theta", "h", "nx",
                                "ny", "split", "p2_data")}
            return MLevelDev(
                na=int(lv.delta.shape[0]),
                **f32,
                parent_pos=_tensor(lv.parent_pos, torch.int64, dev),
                parent_right=_tensor(lv.parent_right, torch.bool, dev),
                p2_owner=_tensor(owner, torch.int64, dev),
                leaf_parent_pos=_tensor(lv.leaf_parent_pos, torch.int64, dev),
                leaf_parent_right=_tensor(lv.leaf_parent_right, torch.bool, dev),
            )

        return MonotoneDev(
            root_p1_data=_tensor(self.root_p1_data, torch.float32, dev),
            levels=tuple(level(lv) for lv in self.levels),
            leaves=_leaf_dev(self.leaf, dev),
        )


def encode_monotone(tree: MonotoneTree, device=None) -> EncodedMonotone:
    """Breadth-first flatten of a built ``MonotoneTree`` (the reference's
    ``encode_monotone``).  Each node carries one fresh pivot; the inherited
    pivot is implicit in the parent edge (left inherits the parent's p1
    side distance, right the fresh p2's).  ``device`` as in
    ``build_bss``."""
    data32 = np.asarray(tree.data, np.float32)

    leaves: list[np.ndarray] = []
    frontier: list[tuple[_MNode, int, bool]] = []

    def _intake(child, parent_pos: int, right: bool, nxt, leaf_edges):
        if child is None:
            return
        if isinstance(child, np.ndarray):
            if len(child):
                leaves.append(np.asarray(child, np.int64))
                leaf_edges.append((parent_pos, right))
            return
        nxt.append((child, parent_pos, right))

    root_edges: list = []
    _intake(tree.root, -1, False, frontier, root_edges)

    levels: list[_MLevel] = []
    while frontier:
        nodes = [n for n, _, _ in frontier]
        na = len(nodes)
        p2_idx = np.array([n.p2 for n in nodes], dtype=np.int64)
        p2_data = _pad_rows(data32[p2_idx], TILE_BLOCK)
        p2_valid = np.zeros(p2_data.shape[0], bool)
        p2_valid[:na] = True
        nxt: list[tuple[_MNode, int, bool]] = []
        leaf_edges: list[tuple[int, bool]] = []
        for i, node in enumerate(nodes):
            _intake(node.left, i, False, nxt, leaf_edges)
            _intake(node.right, i, True, nxt, leaf_edges)
        levels.append(
            _MLevel(
                p2_idx=p2_idx,
                delta=np.array([n.delta for n in nodes], np.float32),
                theta=np.array([n.theta for n in nodes], np.float32),
                h=np.array([n.h for n in nodes], np.float32),
                nx=np.array([n.nx for n in nodes], np.float32),
                ny=np.array([n.ny for n in nodes], np.float32),
                split=np.array([n.split for n in nodes], np.float32),
                parent_pos=np.array([p for _, p, _ in frontier], np.int32),
                parent_right=np.array([r for _, _, r in frontier], bool),
                p2_data=p2_data,
                p2_valid=p2_valid,
                leaf_parent_pos=np.array(
                    [p for p, _ in leaf_edges], dtype=np.int32
                ),
                leaf_parent_right=np.array(
                    [r for _, r in leaf_edges], dtype=bool
                ),
            )
        )
        frontier = nxt

    return EncodedMonotone(
        partition=tree.partition,
        select=tree.select,
        metric=tree.metric,
        n_points=int(tree.data.shape[0]),
        root_p1=int(tree.root_p1),
        root_p1_data=data32[tree.root_p1][None, :],
        levels=levels,
        leaf=_build_leaf_table(leaves, data32),
        torch_device=device,
    )


# ---------------------------------------------------------------------------
# another encoder's host tables
# ---------------------------------------------------------------------------


def _fields(obj, cls) -> dict:
    """The dataclass fields of ``cls`` read from a mapping or an object."""
    get = obj.get if isinstance(obj, dict) else (lambda k: getattr(obj, k))
    return {f.name: np.asarray(get(f.name)) for f in dataclasses.fields(cls)
            if f.default is dataclasses.MISSING}


def forest_from_arrays(fields: dict, kind: str, *, device=None):
    """An ``EncodedForest`` (``kind="forest"``) or ``EncodedMonotone``
    (``kind="monotone"``) from another encoding's host tables: ``fields``
    maps the encoding's field names to numpy arrays and ints, its
    ``levels`` to a list of per-level mappings (or objects) of the level
    tables and its ``leaf`` to the leaf tables.  The reference's
    ``dataclasses.asdict(encoded)`` is such a mapping.  ``device`` as in
    ``build_bss``."""
    leaf = _LeafTable(**_fields(fields["leaf"], _LeafTable))
    if kind == "forest":
        return EncodedForest(
            variant=str(fields["variant"]),
            metric=str(fields["metric"]),
            n_points=int(fields["n_points"]),
            levels=[_Level(**_fields(lv, _Level)) for lv in fields["levels"]],
            leaf=leaf,
            torch_device=device,
        )
    if kind == "monotone":
        return EncodedMonotone(
            partition=str(fields["partition"]),
            select=str(fields["select"]),
            metric=str(fields["metric"]),
            n_points=int(fields["n_points"]),
            root_p1=int(fields["root_p1"]),
            root_p1_data=np.asarray(fields["root_p1_data"], np.float32),
            levels=[_MLevel(**_fields(lv, _MLevel)) for lv in fields["levels"]],
            leaf=leaf,
            torch_device=device,
        )
    raise ValueError(f"kind must be forest|monotone, got {kind!r}")
