"""The device mesh of the port and its placement helpers — the counterpart
of ``jax.sharding.Mesh`` / ``PartitionSpec`` / ``NamedSharding``, of
``repro.parallel.sharding`` (``dp_axes``, ``fsdp_axes``, ``batch_spec``,
``named``, ``shard_tree``, ``abstract_with_sharding``, ``maybe_constrain``,
``divisible_or_none``) and of ``repro.launch.mesh.make_local_mesh``'s
one-axis form (``local_mesh``, which calls the port's ``make_local_mesh``).

One Python process drives every device of a :class:`ShardMesh`, as one
process drives every device of a JAX mesh under ``shard_map``: the sharded
BSS engine (``repro_torch.parallel.shard_index``) keeps one shard's tensors
on each mesh device and merges on the lead device (``mesh.devices[0]``),
and the sharded train step (``repro_torch.parallel.sharded_step``) keeps
each state leaf in pieces (:class:`ShardedTensor`).  A device may appear
more than once: ``local_mesh(4)`` on a host with one card puts four shards
on ``cuda:0``, as the reference's simulated host devices put several mesh
devices on one CPU.

Axes: the data axes are ``("pod", "data")``, in that order, whichever the
mesh has (``dp_axes``); the BSS blocks and the batch rows are partitioned
over their product, shard ``pod * |data| + data``.  Any other axis
(``"model"``) may have any size: parameters name it in their specs (tensor
parallelism over their output dim, experts, KV-cache sequence), and the BSS
engine replicates over it, as the reference's ``ShardedBSSIndex`` does.

The mesh lives on the CUDA devices; on the CPU only when the caller lists
``"cpu"`` devices, as the CPU tests do; on ``meta`` devices for the dry run
(``launch.mesh.make_production_mesh``: 256 or 512 devices that hold
nothing).  A mesh never mixes device types.

A spec (:class:`P`) names, for each dim of a tensor, ``None`` (the dim is
whole on every device), one axis, or a tuple of axes (the dim is split
over their product, the first axis major).  A dim that its axes do not
divide is split in pieces of ``ceil(n / k)`` rows, the last shorter or
empty, and a device's share is reckoned at the full ``ceil(n / k)``: GSPMD
pads such a dim.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.pytree import tree_map

__all__ = [
    "ShardMesh",
    "P",
    "Placement",
    "ShardedTensor",
    "AbstractLeaf",
    "check_mesh",
    "dp_axes",
    "fsdp_axes",
    "batch_spec",
    "named",
    "shard_tree",
    "abstract_with_sharding",
    "maybe_constrain",
    "active_mesh",
    "divisible_or_none",
    "n_shards",
    "shard_devices",
    "local_mesh",
]

DATA_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """``devices`` listed row-major over ``axis_names``; ``shape`` defaults
    to ``(len(devices),)`` for a one-axis mesh."""

    devices: tuple
    axis_names: tuple = ("data",)
    shape: tuple | None = None

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        names = tuple(self.axis_names)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len(set(names)) != len(names):
            raise ValueError(f"axis names repeat: {names}")
        shape = (len(devices),) if self.shape is None and len(names) == 1 else self.shape
        if shape is None:
            raise ValueError(f"a mesh over axes {names} needs its shape")
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(names) or min(shape) < 1:
            raise ValueError(f"shape {shape} does not fit axes {names}")
        if int(np.prod(shape)) != len(devices):
            raise ValueError(f"shape {shape} holds {int(np.prod(shape))} devices, "
                             f"got {len(devices)}")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a mesh never mixes device types: {devices}")
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "shape", shape)

    def size(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise KeyError(f"mesh {self.axis_names} has no axis {axis!r}")
        return self.shape[self.axis_names.index(axis)]

    @property
    def sizes(self) -> dict:
        """``{axis: size}``: the reference's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.shape))

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def coords(self, i: int) -> dict:
        """``{axis: index}`` of the mesh's ``i``-th device (row-major)."""
        return dict(zip(self.axis_names, (int(c) for c in np.unravel_index(i, self.shape))))

    @property
    def lead(self) -> torch.device:
        """Where the per-shard outputs are merged."""
        return self.devices[0]


def dp_axes(mesh: ShardMesh) -> tuple[str, ...]:
    """The data axes the mesh has, pod first (the reference's rule)."""
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


def check_mesh(mesh) -> ShardMesh:
    """``mesh``, if it is a ``ShardMesh`` with a data axis to partition the
    blocks over (the reference's ``ShardedBSSIndex`` rule); raises
    otherwise."""
    if not isinstance(mesh, ShardMesh):
        raise TypeError(f"mesh must be a repro_torch.parallel.ShardMesh, got "
                        f"{type(mesh).__name__}")
    if not dp_axes(mesh):
        raise ValueError(
            f"mesh {mesh.axis_names} has no data axis; the sharded BSS engine "
            f"partitions corpus blocks over ('data',) (optionally ('pod', 'data'))"
        )
    return mesh


def n_shards(mesh: ShardMesh) -> int:
    return int(np.prod([mesh.size(a) for a in dp_axes(mesh)]))


def shard_devices(mesh: ShardMesh) -> tuple[torch.device, ...]:
    """Shard s's device, s = pod * |data| + data (every other axis at 0)."""
    grid = np.arange(len(mesh.devices)).reshape(mesh.shape)
    axes = dp_axes(mesh)
    order = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(mesh.shape)) if i not in order]
    grid = np.transpose(grid, order + rest).reshape(n_shards(mesh), -1)[:, 0]
    return tuple(mesh.devices[i] for i in grid)


def local_mesh(n_shards: int | None = None) -> ShardMesh:
    """``launch.mesh.make_local_mesh(1, n_shards)``: the data axis over this
    host's CUDA devices, round-robin (four shards on one H100: ``cuda:0``
    four times), with a ``"model"`` axis of 1.  Raises without a CUDA
    device."""
    from repro_torch.launch.mesh import make_local_mesh

    return make_local_mesh(1, n_shards)


# ------------------------------------------------------------------ specs


def _entry(e):
    """A spec entry as JAX normalises it: a one-axis tuple is the axis, an
    empty one ``None``."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        if any(not isinstance(a, str) for a in e):
            raise TypeError(f"a spec entry names axes by str, got {e!r}")
        return None if not e else e[0] if len(e) == 1 else e
    if e is None or isinstance(e, str):
        return e
    raise TypeError(f"a spec entry is None, an axis name or a tuple of them, got {e!r}")


class P:
    """A partition spec: the counterpart of ``jax.sharding.PartitionSpec``.
    One entry per leading dim of a tensor (``None``, an axis name, or a
    tuple of axis names); dims past the last entry are whole.  Equal to
    another ``P`` (or a tuple) with the same normalised entries, as JAX's
    is: ``P(("data",), None) == P("data", None)``, ``P() != P(None)``.  A
    ``P`` is a leaf of the port's trees (``repro_torch.pytree``), as a
    ``PartitionSpec`` is of JAX's."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        object.__setattr__(self, "_parts", tuple(_entry(e) for e in parts))

    def __setattr__(self, name, value):
        raise AttributeError("a P is immutable")

    def __iter__(self) -> Iterator:
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, P):
            return self._parts == other._parts
        if isinstance(other, tuple):
            return self._parts == tuple(_entry(e) for e in other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self._parts) + ")"

    def axes(self, ndim: int) -> tuple[tuple[str, ...], ...]:
        """Each of ``ndim`` dims' axes as a tuple (``()`` where whole)."""
        if len(self._parts) > ndim:
            raise ValueError(f"spec {self!r} has more entries than a {ndim}-d tensor has dims")
        out = [() if e is None else (e,) if isinstance(e, str) else e for e in self._parts]
        return tuple(out) + ((),) * (ndim - len(out))

    def names(self) -> set:
        return {a for e in self.axes(len(self._parts)) for a in e}


def fsdp_axes(mesh: ShardMesh) -> tuple[str, ...]:
    """Axes used for fully-sharded parameter storage: the data axes."""
    return dp_axes(mesh)


def batch_spec(mesh: ShardMesh, *rest: Any) -> P:
    """A spec with the batch dim split over all data axes."""
    return P(dp_axes(mesh), *rest)


def divisible_or_none(dim: int, mesh: ShardMesh, axes: tuple[str, ...] | str):
    """The axes if ``dim`` divides their product, else None (replicate):
    the reference's rule (it prefers replication to a padded weight dim)."""
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.size(a)
    return axes if dim % size == 0 else None


# --------------------------------------------------------------- placement


@dataclasses.dataclass(frozen=True)
class Placement:
    """A spec over a mesh: the counterpart of ``NamedSharding``.  Says, for
    a tensor of a given shape, which piece each mesh device holds."""

    mesh: ShardMesh
    spec: P

    def __post_init__(self):
        unknown = self.spec.names() - set(self.mesh.axis_names)
        if unknown:
            raise ValueError(f"spec {self.spec!r} names axes {sorted(unknown)} that "
                             f"mesh {self.mesh.axis_names} lacks")

    def counts(self, ndim: int) -> tuple[int, ...]:
        """How many pieces each dim is split into."""
        return tuple(math.prod(self.mesh.size(a) for a in ax) for ax in self.spec.axes(ndim))

    def piece_of(self, i: int, ndim: int) -> tuple[int, ...]:
        """The piece (one index per dim) that mesh device ``i`` holds."""
        c = self.mesh.coords(i)
        out = []
        for ax in self.spec.axes(ndim):
            k = 0
            for a in ax:
                k = k * self.mesh.size(a) + c[a]
            out.append(k)
        return tuple(out)

    def bounds(self, shape: tuple, piece: tuple) -> tuple[slice, ...]:
        """The slices of a ``shape`` tensor that ``piece`` covers."""
        out = []
        for n, k, j in zip(shape, self.counts(len(shape)), piece):
            step = -(-n // k)
            out.append(slice(min(n, j * step), min(n, (j + 1) * step)))
        return tuple(out)

    def device_shape(self, shape: tuple) -> tuple[int, ...]:
        """One device's share of a ``shape`` tensor, padded as GSPMD pads."""
        return tuple(-(-n // k) for n, k in zip(shape, self.counts(len(shape))))

    def device_bytes(self, shape: tuple, dtype: torch.dtype) -> int:
        return math.prod(self.device_shape(shape)) * dtype.itemsize

    def holders(self, ndim: int) -> dict:
        """``{piece: [distinct devices that hold it, in mesh order]}``."""
        out: dict = {}
        for i, dev in enumerate(self.mesh.devices):
            devs = out.setdefault(self.piece_of(i, ndim), [])
            if dev not in devs:
                devs.append(dev)
        return out


def named(mesh: ShardMesh, spec: P) -> Placement:
    return Placement(mesh, spec)


def shard_tree(mesh: ShardMesh, spec_tree: Any) -> Any:
    """A tree of ``P`` -> the same tree of ``Placement``s."""
    return tree_map(lambda s: Placement(mesh, s), spec_tree)


@dataclasses.dataclass(frozen=True)
class AbstractLeaf:
    """A leaf's shape and dtype with its placement and nothing allocated:
    the counterpart of a ``ShapeDtypeStruct`` with a sharding."""

    shape: tuple
    dtype: torch.dtype
    placement: Placement

    @property
    def device_bytes(self) -> int:
        return self.placement.device_bytes(self.shape, self.dtype)


def abstract_with_sharding(shape_tree: Any, sharding_tree: Any) -> Any:
    """Attach placements to a tree of shapes (``meta`` tensors, ``TensorSpec``s
    or anything with ``shape`` and ``dtype``), flattened up to
    ``sharding_tree``'s structure."""
    return tree_map(lambda sh, s: AbstractLeaf(tuple(s.shape), s.dtype, sh),
                    sharding_tree, shape_tree)


class ShardedTensor:
    """One leaf laid out over a mesh: each piece its placement names, kept
    once on each distinct device that holds it (mesh devices that are one
    device, as four shards on one card, share a piece).  ``gather`` puts
    the pieces back together exactly; ``scatter_`` writes a whole tensor
    into the pieces in place."""

    def __init__(self, placement: Placement, shape: tuple, dtype: torch.dtype, pieces: dict):
        self.placement = placement
        self.shape = tuple(shape)
        self.dtype = dtype
        self.pieces = pieces  # {piece: {device: tensor}}

    @classmethod
    def place(cls, t: torch.Tensor, placement: Placement) -> "ShardedTensor":
        pieces = {}
        for piece, devs in placement.holders(t.ndim).items():
            sl = t[placement.bounds(t.shape, piece)]
            pieces[piece] = {d: sl.to(d, copy=True).contiguous() for d in devs}
        return cls(placement, t.shape, t.dtype, pieces)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def local(self) -> Iterator[tuple[tuple, torch.device, torch.Tensor]]:
        """``(bounds, device, tensor)`` of every piece held."""
        for piece, by_dev in self.pieces.items():
            b = self.placement.bounds(self.shape, piece)
            for dev, t in by_dev.items():
                yield b, dev, t

    def gather(self, device) -> torch.Tensor:
        """The whole tensor on ``device``, each piece copied exactly."""
        device = torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for piece, by_dev in self.pieces.items():
            out[self.placement.bounds(self.shape, piece)] = by_dev.get(
                device, next(iter(by_dev.values())))
        return out

    @torch.no_grad()
    def scatter_(self, full: torch.Tensor) -> None:
        """Write ``full`` (the whole tensor) into every piece in place."""
        for b, dev, t in self.local():
            t.copy_(full[b])

    def model_region(self, i: int) -> tuple[tuple[int, int], ...]:
        """``(start, stop)`` per dim of mesh device ``i``'s piece over the
        axes that are not data axes: what a model shard computes with, whole
        over the data axes (the FSDP split) and split as the spec splits it
        over ``"model"``."""
        dp = set(dp_axes(self.placement.mesh))
        parts = []
        for ax in self.placement.spec.axes(self.ndim):
            keep = tuple(a for a in ax if a not in dp)
            if keep and len(keep) != len(ax):
                raise ValueError(f"spec {self.placement.spec!r} splits one dim over data "
                                 "and model axes at once")
            parts.append(keep or None)
        pl = Placement(self.placement.mesh, P(*parts))
        return tuple((b.start, b.stop) for b in pl.bounds(self.shape, pl.piece_of(i, self.ndim)))

    def gather_region(self, region: tuple[tuple[int, int], ...], device) -> torch.Tensor:
        """The ``region`` (``model_region``) on ``device``, each piece inside
        it copied exactly: a gather over the data axes only."""
        device = torch.device(device)
        out = torch.empty(tuple(hi - lo for lo, hi in region), dtype=self.dtype, device=device)
        for piece, by_dev in self.pieces.items():
            b = self.placement.bounds(self.shape, piece)
            if all(s.start >= lo and s.stop <= hi for s, (lo, hi) in zip(b, region)):
                rel = tuple(slice(s.start - lo, s.stop - lo) for s, (lo, _) in zip(b, region))
                out[rel] = by_dev.get(device, next(iter(by_dev.values())))
        return out

    def region(self, region: tuple[tuple[int, int], ...], device) -> torch.Tensor:
        """The ``region`` on ``device`` to compute with (read only): the
        piece held there itself where one piece is the region, else
        ``gather_region``'s copy."""
        device = torch.device(device)
        for piece, by_dev in self.pieces.items():
            b = self.placement.bounds(self.shape, piece)
            if device in by_dev and all(s.start == lo and s.stop == hi
                                        for s, (lo, hi) in zip(b, region)):
                return by_dev[device]
        return self.gather_region(region, device)

    def sum_sq(self, device=None) -> torch.Tensor:
        """The float32 sum of the squared elements, each piece's own sum
        added in piece order on ``device`` (the mesh's lead by default)."""
        device = torch.device(device) if device is not None else self.placement.mesh.lead
        total = None
        for by_dev in self.pieces.values():
            t = next(iter(by_dev.values()))
            part = torch.sum(t.float() ** 2).to(device)
            total = part if total is None else total + part
        return total

    def device_bytes(self) -> int:
        """One mesh device's share, as its spec reckons it."""
        return self.placement.device_bytes(self.shape, self.dtype)

    def held_bytes(self) -> dict:
        """Bytes allocated on each distinct device."""
        out: dict = {}
        for _, dev, t in self.local():
            out[dev] = out.get(dev, 0) + t.numel() * t.element_size()
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor({self.shape}, {self.dtype}, {self.placement.spec!r}, "
                f"{len(self.pieces)} pieces)")


# --------------------------------------------------------------- constrain

_ACTIVE = threading.local()


@contextlib.contextmanager
def active_mesh(mesh: ShardMesh):
    """The mesh a sharded step computes over, for ``maybe_constrain``."""
    prev = getattr(_ACTIVE, "mesh", None)
    _ACTIVE.mesh = mesh
    try:
        yield mesh
    finally:
        _ACTIVE.mesh = prev


def maybe_constrain(x, spec: P):
    """The counterpart of ``with_sharding_constraint``: ``x`` itself.
    Outside a sharded step nothing is checked (the same model code runs on
    one device); inside one (``active_mesh``) the spec must name only the
    active mesh's axes and fit ``x``'s dims.  Each shard already holds its
    own rows, so nothing moves."""
    mesh = getattr(_ACTIVE, "mesh", None)
    if mesh is not None:
        Placement(mesh, spec)
        spec.axes(x.ndim)
    return x
