"""Shared plumbing of the batched query engines — the port of
``repro.core.backends``: the engine option record, backend selection,
query-tile survival and the serving front's shape buckets.

Backends:

* ``"cuda"`` runs the hand-written Hopper kernels (``repro_torch/csrc``);
  it needs the index on a CUDA device of compute capability 9.0 or above
  and raises otherwise.
* ``"torch"`` runs the same math in plain torch ops on any device — the
  counterpart of the reference's ``"jnp"`` backend.
* ``"auto"`` is ``"cuda"`` for an index on a CUDA device and ``"torch"`` for
  an index the caller put on the CPU.  It never moves work off the card.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import torch

__all__ = [
    "EngineOpts",
    "resolve_engine_opts",
    "resolve_backend",
    "tile_survival",
    "DEFAULT_BUCKETS",
    "bucket_for",
]

STRICT_API_ENV = "REPRO_STRICT_API"

_BACKENDS = ("auto", "cuda", "torch")
_REALISATIONS = ("adaptive", "dense")
_PRECISIONS = ("fp32", "bf16")

# the oldest card the kernels are built for (sm_90a)
MIN_CAPABILITY = (9, 0)


@dataclasses.dataclass(frozen=True)
class EngineOpts:
    """The cross-cutting options of every batched query engine, as one
    frozen record.

    * ``bq`` — query-tile row count of the masked exact phase; ``None``
      means ``repro_torch.kernels.tiles.TILE_BQ``.
    * ``backend`` — ``"auto"`` | ``"cuda"`` | ``"torch"`` (module docstring).
    * ``realisation`` — ``"adaptive"`` | ``"dense"``: the ``"torch"``
      backend's exact phase, as the reference's jnp backend picks it.
      ``"adaptive"`` gathers only the alive (query, block) cells of a batch
      or kNN round when they are at most 0.08 of all
      (``flat_index._DENSE_ALIVE_FRAC``), else runs the dense pass; ``"dense"`` always runs the dense
      pass.  ``"cuda"`` runs the masked kernel whatever the value.
    * ``precision`` — ``"fp32"`` | ``"bf16"`` (the exact phase over the
      bf16 corpus mirror with an fp32 re-check of the margin band; results
      bit-identical to ``"fp32"``).

    The reference's ``interpret`` knob has no torch counterpart."""

    bq: int | None = None
    backend: str = "auto"
    realisation: str = "adaptive"
    precision: str = "fp32"

    def __post_init__(self):
        if self.bq is not None and int(self.bq) <= 0:
            raise ValueError(f"bq must be positive, got {self.bq}")
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"backend must be auto|cuda|torch, got {self.backend!r}"
            )
        if self.realisation not in _REALISATIONS:
            raise ValueError(
                f"realisation must be adaptive|dense, got "
                f"{self.realisation!r}"
            )
        if self.precision not in _PRECISIONS:
            raise ValueError(
                f"precision must be fp32|bf16, got {self.precision!r}"
            )


def resolve_engine_opts(opts: EngineOpts | None = None, **legacy) -> EngineOpts:
    """``opts`` or the legacy per-knob kwargs (never both) as one
    ``EngineOpts``; the kwargs warn under ``REPRO_STRICT_API=1``."""
    given = {k: v for k, v in legacy.items() if v is not None}
    if opts is not None:
        if not isinstance(opts, EngineOpts):
            raise TypeError(
                f"opts must be an EngineOpts, got {type(opts).__name__}"
            )
        if given:
            raise ValueError(
                f"pass opts= OR the legacy kwargs, not both (got opts= and "
                f"{sorted(given)})"
            )
        return opts
    if given and os.environ.get(STRICT_API_ENV) == "1":
        warnings.warn(
            f"legacy engine kwargs {sorted(given)} are deprecated; pass "
            f"opts=EngineOpts(...) (repro_torch.core.backends)",
            DeprecationWarning,
            stacklevel=3,
        )
    return EngineOpts(**given)


# micro-batch shape ladder of the serving front; 512 queries is also the
# largest exact-phase batch (512 x 101,504 fp32 distances ~ 208 MB)
DEFAULT_BUCKETS = (8, 32, 128, 512)


def bucket_for(n: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest bucket that fits ``n`` queries (``buckets`` ascending)."""
    if n <= 0:
        raise ValueError(f"need at least one query, got {n}")
    for b in buckets:
        if n <= b:
            return int(b)
    raise ValueError(
        f"batch of {n} exceeds the largest bucket {buckets[-1]}; "
        f"split it before dispatch"
    )


def resolve_backend(backend: str, device: torch.device) -> str:
    """The backend that serves an index on ``device`` (module docstring)."""
    device = torch.device(device)
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend == "torch":
        return backend
    if backend != "cuda":
        raise ValueError(f"backend must be auto|cuda|torch, got {backend!r}")
    if device.type != "cuda":
        raise ValueError(
            f"backend='cuda' needs an index on a CUDA device, not {device}"
        )
    cap = torch.cuda.get_device_capability(device)
    if cap < MIN_CAPABILITY:
        raise RuntimeError(
            f"backend='cuda' needs compute capability >= {MIN_CAPABILITY} "
            f"(kernels are built for sm_90a); {device} has {cap}"
        )
    return backend


def tile_survival(alive: torch.Tensor, bq: int) -> torch.Tensor:
    """(Q, B) per-query survival -> (ceil(Q/bq), B) tile survival: a tile
    lives when ANY of its queries does."""
    nq, nb = alive.shape
    qtiles = -(-nq // bq)
    pad = alive.new_zeros((qtiles * bq - nq, nb))
    return torch.cat([alive, pad]).reshape(qtiles, bq, nb).any(dim=1)
