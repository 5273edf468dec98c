"""Distance tiles on the H100 — the port of ``repro.kernels.pairwise_dist``
and of the JSD / Triangular tiles it dispatches (``jsd_dist``,
``tri_dist``).

One hand-written CUDA kernel per supermetric tile, each with two entry
points: the unmasked (m, n) matrix (the query -> pivot distances) and the
masked exact phase, which writes +inf into every (bm x bn) tile whose flag
is 0 without computing it.

* l2 (``csrc/pairwise_dist.cu``): ``sqrt(max(|x|^2 + |y|^2 - 2 x.y, 0))``
  in IEEE fp32 with the reference's epilogue order; it also serves cosine,
  which the engine maps onto the unit sphere.
* jsd and triangular (``csrc/prob_dist.cu``): the per-k sums of the
  reference registry over probability vectors, with the logarithm and the
  reciprocal on the special function units; the bound on their error that
  the source note derives is ``core.precision.prob_error_budget``.

Each source note says what it replaces, what bounds it and how.  The
metric-dispatched entry points take every name in ``KERNEL_METRICS`` (the
reference's ``_TILE_KERNELS``) and refuse any other: power transforms have
no tile and run as plain pairwise in the engine on either backend.

Every wrapper runs its plain version (``repro_torch.kernels.ref``) only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts kernel launches per C entry point and nothing else.

``x`` is float32; ``y`` is float32 or bfloat16 (the bf16 exact phase streams
the engine's bfloat16 corpus mirror).  Each C entry point has a ``_bf16``
twin, the same kernel template with ``y`` loaded as bfloat16 and widened to
float32 exactly on entry, as every Pallas tile upcasts; the wrappers pick
the entry point by ``y.dtype``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.tiles import TILE_BLOCK, TILE_BQ

__all__ = [
    "pairwise_l2_kernel_call",
    "masked_pairwise_l2_kernel_call",
    "pairwise_kernel_call",
    "masked_pairwise_kernel_call",
    "KERNEL_METRICS",
    "LAUNCHES",
]

DEFAULT_BM = TILE_BQ
DEFAULT_BN = TILE_BLOCK


class _Tile(NamedTuple):
    source: str                # csrc/<source>.cu
    entry: str                 # unmasked C entry point; the masked one is "masked_" + entry
    plain: Callable[..., torch.Tensor]  # plain version of the unmasked tile


# metric -> its tile kernel (the reference's _TILE_KERNELS,
# src/repro/kernels/pairwise_dist.py:111-115)
_TILES = {
    "l2": _Tile("pairwise_dist", "pairwise_l2", ref.pairwise_l2_ref),
    "jsd": _Tile("prob_dist", "pairwise_jsd", ref.pairwise_jsd_ref),
    "triangular": _Tile("prob_dist", "pairwise_tri", ref.pairwise_tri_ref),
}
KERNEL_METRICS = tuple(_TILES)

# y dtype -> suffix of the C entry point that reads it
_Y_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}

LAUNCHES = {
    prefix + tile.entry + suffix: 0
    for tile in _TILES.values()
    for suffix in _Y_SUFFIX.values()
    for prefix in ("", "masked_")
}

_P, _I = ctypes.c_void_p, ctypes.c_int
# C argument types: x, y, [mask,] out, m, n, k, [bm, bn,] [squared,] stream
_SIGNATURES = {
    "pairwise_dist": {
        **{"pairwise_l2" + s: [_P, _P, _P, _I, _I, _I, _I, _P] for s in _Y_SUFFIX.values()},
        **{"masked_pairwise_l2" + s: [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
           for s in _Y_SUFFIX.values()},
    },
    "prob_dist": {
        **{e + s: [_P, _P, _P, _I, _I, _I, _P]
           for e in ("pairwise_jsd", "pairwise_tri") for s in _Y_SUFFIX.values()},
        **{f"masked_{e}{s}": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
           for e in ("pairwise_jsd", "pairwise_tri") for s in _Y_SUFFIX.values()},
    },
}


def _check_pair(x: torch.Tensor, y: torch.Tensor) -> str:
    """Validate an (x, y) operand pair; returns the suffix of the C entry
    point that reads ``y``'s dtype."""
    if x.ndim != 2 or y.ndim != 2:
        raise ValueError(f"x and y must be 2-D, got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.shape[1] != y.shape[1]:
        raise ValueError(
            f"x and y must share the feature dimension: {tuple(x.shape)} vs {tuple(y.shape)}"
        )
    if x.device != y.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")
    if x.dtype != torch.float32 or y.dtype not in _Y_SUFFIX:
        raise TypeError(
            f"x must be float32 and y float32 or bfloat16, got {x.dtype} and {y.dtype}"
        )
    return _Y_SUFFIX[y.dtype]


def _check_launchable(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous row-major tensors")


def _mask_shape(m: int, n: int, bm: int, bn: int) -> tuple[int, int]:
    return (math.ceil(m / bm), math.ceil(n / bn))


def _launch(source: str, entry: str, out: torch.Tensor, *args) -> None:
    """Launch C entry point ``entry`` of ``csrc/<source>.cu`` on the current
    stream of ``out``'s device; raise if the launch was refused."""
    with torch.cuda.device(out.device):
        lib = _build.library(source, _SIGNATURES[source])
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*args, stream)
    _build.check(err, entry)
    _build.count_launch(LAUNCHES, entry)


def _tile(metric_name: str) -> _Tile:
    tile = _TILES.get(metric_name)
    if tile is None:
        raise KeyError(
            f"no tile kernel for {metric_name!r}; have {KERNEL_METRICS} (the "
            f"engine serves cosine as l2 and runs power transforms as plain "
            f"pairwise)"
        )
    return tile


def _pairwise(metric_name: str, x: torch.Tensor, y: torch.Tensor,
              squared: bool = False) -> torch.Tensor:
    tile = _tile(metric_name)
    suffix = _check_pair(x, y)
    l2_args = (int(squared),) if metric_name == "l2" else ()
    if x.device.type == "cpu":
        return tile.plain(x, y, *l2_args)
    _check_launchable(x, y)
    (m, k), n = x.shape, y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        _launch(tile.source, tile.entry + suffix, out,
                x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, *l2_args)
    return out


def _masked(metric_name: str, x: torch.Tensor, y: torch.Tensor,
            tile_mask: torch.Tensor, bm: int, bn: int,
            squared: bool = False) -> torch.Tensor:
    tile = _tile(metric_name)
    suffix = _check_pair(x, y)
    (m, k), n = x.shape, y.shape[0]
    if bm <= 0 or bn <= 0:
        raise ValueError(f"bm and bn must be positive, got {bm}, {bn}")
    grid = _mask_shape(m, n, bm, bn)
    if tuple(tile_mask.shape) != grid:
        raise ValueError(
            f"tile_mask shape {tuple(tile_mask.shape)} does not match the "
            f"(m_tiles, n_tiles) grid {grid}"
        )
    if tile_mask.device != x.device:
        raise ValueError(f"tile_mask on {tile_mask.device} but x on {x.device}")
    l2_args = (int(squared),) if metric_name == "l2" else ()
    if x.device.type == "cpu":
        return ref.masked_pairwise_metric_ref(tile.plain(x, y, *l2_args), tile_mask, bm, bn)
    mask = tile_mask.to(torch.int32).contiguous()
    _check_launchable(x, y, mask)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        _launch(tile.source, "masked_" + tile.entry + suffix, out,
                x.data_ptr(), y.data_ptr(), mask.data_ptr(), out.data_ptr(),
                m, n, k, bm, bn, *l2_args)
    return out


def pairwise_l2_kernel_call(
    x: torch.Tensor, y: torch.Tensor, *, squared: bool = False
) -> torch.Tensor:
    """(m, K) float32, (n, K) float32 or bfloat16 -> (m, n) float32
    Euclidean (or squared) distances."""
    return _pairwise("l2", x, y, squared)


def masked_pairwise_l2_kernel_call(
    x: torch.Tensor,
    y: torch.Tensor,
    tile_mask: torch.Tensor,
    *,
    bm: int = DEFAULT_BM,
    bn: int = DEFAULT_BN,
    squared: bool = False,
) -> torch.Tensor:
    """Masked variant: ``tile_mask[i, j] != 0`` marks live (bm x bn) output
    tiles; dead tiles come out +inf without being computed.  ``tile_mask``
    has shape (ceil(m/bm), ceil(n/bn)) — for BSS, bm is the query tile and
    bn the index block, so the mask is the block-survival matrix."""
    return _masked("l2", x, y, tile_mask, bm, bn, squared)


def pairwise_kernel_call(
    metric_name: str, x: torch.Tensor, y: torch.Tensor
) -> torch.Tensor:
    """Metric-dispatched (m, K), (n, K) -> (m, n) distance matrix for every
    metric in ``KERNEL_METRICS``."""
    return _pairwise(metric_name, x, y)


def masked_pairwise_kernel_call(
    metric_name: str,
    x: torch.Tensor,
    y: torch.Tensor,
    tile_mask: torch.Tensor,
    *,
    bm: int = DEFAULT_BM,
    bn: int = DEFAULT_BN,
) -> torch.Tensor:
    """Metric-dispatched masked pairwise: the BSS exact phase for every
    metric in ``KERNEL_METRICS``, with the tile-skipping contract of
    ``masked_pairwise_l2_kernel_call``."""
    return _masked(metric_name, x, y, tile_mask, bm, bn)
