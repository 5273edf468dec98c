"""The device mesh of the port — the counterpart of ``jax.sharding.Mesh``,
``repro.parallel.sharding.dp_axes`` and ``repro.launch.mesh.make_local_mesh``.

One Python process drives every device of a :class:`ShardMesh`, as one
process drives every device of a JAX mesh under ``shard_map``: the sharded
engine (``repro_torch.parallel.shard_index``) keeps one shard's tensors on
each mesh device, launches each shard's pass on its own device and merges
the per-shard outputs on the lead device (``mesh.devices[0]``).  A device
may appear more than once: ``local_mesh(4)`` on a host with one card puts
four shards on ``cuda:0``, as the reference's simulated host devices put
several mesh devices on one CPU.

Axes: the data axes are ``("pod", "data")``, in that order, whichever the
mesh has (``dp_axes``); the blocks are partitioned over their product,
shard ``pod * |data| + data``.  Any other axis (``"model"``) must have
size 1, as ``make_local_mesh`` gives it: model parallelism belongs with
the model scaffolding (ROADMAP Queue 1 item 8).

The mesh lives on the CUDA devices; the CPU only when the caller lists
``"cpu"`` devices, as the CPU tests do.  A mesh never mixes device types.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["ShardMesh", "check_mesh", "dp_axes", "n_shards", "shard_devices", "local_mesh"]

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
        wide = [a for a, s in zip(names, shape) if a not in DATA_AXES and s > 1]
        if wide:
            raise ValueError(
                f"mesh axes {wide} have size > 1: the port shards only over its "
                f"data axes {DATA_AXES}; model parallelism comes with the model "
                f"scaffolding (ROADMAP Queue 1 item 8)"
            )
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "shape", shape)

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

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
    """A ``("data",)`` mesh over this host's CUDA devices: one shard per card
    by default; with more shards than cards the cards are reused
    round-robin (four shards on one H100: ``cuda:0`` four times).  Raises
    without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: local_mesh spans the cards; list 'cpu' devices in "
            "ShardMesh to run on the CPU"
        )
    count = torch.cuda.device_count()
    n = count if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be positive, got {n}")
    return ShardMesh(tuple(torch.device("cuda", i % count) for i in range(n)))
