"""Simulated multi-device hosts, the port of ``repro.launch.simdevices``.

The reference must set ``--xla_force_host_platform_device_count`` before
jax first initialises, so it builds a subprocess's environment.  Torch
locks no device count: a mesh of CPU devices is built in-process, and the
port's tests use it as the reference's ``tests/multidevice_shim.py`` uses
its environment.  One process drives every mesh device (each one the
CPU): each piece a placement names is a tensor of its own, kept once for
the mesh devices that share it.
"""

from __future__ import annotations

from repro_torch.parallel.sharding import ShardMesh

__all__ = ["simulated_mesh"]


def simulated_mesh(n_devices: int, shape: tuple | None = None,
                   axis_names: tuple = ("data",)) -> ShardMesh:
    """A ``ShardMesh`` of ``n_devices`` CPU devices over ``axis_names``
    (``shape`` defaults to ``(n_devices,)`` for one axis)."""
    return ShardMesh(("cpu",) * int(n_devices), tuple(axis_names), shape)
