"""Production and local meshes of the port, the port of
``repro.launch.mesh``.  Functions, not module-level constants: importing
this module touches no device.

``make_production_mesh`` lays the reference's production meshes over
``meta`` devices: they hold nothing, so the dry run
(``repro_torch.launch.dryrun``) reckons a 256- or 512-device cell on any
host, where the reference fakes 512 XLA host devices.
``make_local_mesh`` spans the live CUDA devices.
"""

from __future__ import annotations

import torch

from repro_torch.parallel.sharding import ShardMesh

__all__ = ["make_production_mesh", "make_local_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> ShardMesh:
    """16 x 16 = 256 devices per pod; ``multi_pod`` adds the 2-pod leading
    axis.  Every device is ``meta``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    return ShardMesh((torch.device("meta"),) * n, axes, shape)


def make_local_mesh(model_parallel: int = 1, n_devices: int | None = None) -> ShardMesh:
    """A ``("data", "model")`` mesh over this host's CUDA devices (tests,
    single-host runs, elastic restarts: the mesh is derived from the LIVE
    device list).  ``n_devices`` beyond the card count reuses the cards
    round-robin (four mesh devices on one H100: ``cuda:0`` four times);
    ``parallel.sharding.local_mesh(n)`` is ``make_local_mesh(1, n)``.
    Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: make_local_mesh spans the cards; "
            "launch.simdevices.simulated_mesh builds a mesh of CPU devices"
        )
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be positive, got {n}")
    if n % model_parallel != 0:
        raise ValueError(
            f"device count {n} not divisible by model_parallel "
            f"{model_parallel}"
        )
    return ShardMesh(tuple(torch.device("cuda", i % count) for i in range(n)),
                     ("data", "model"), (n // model_parallel, model_parallel))
