"""l2 distance tiles on the H100 — the port of ``repro.kernels.pairwise_dist``.

The CUDA kernel (``csrc/pairwise_dist.cu``; its source note says what it
replaces, what bounds it and how) computes ``sqrt(max(|x|^2 + |y|^2 -
2 x.y, 0))`` in IEEE fp32 with the reference's epilogue order.  Two entry
points: the unmasked (m, n) matrix (the query -> pivot distances) and the
masked exact phase, which writes +inf into every (bm x bn) tile whose flag
is 0 without computing it.

Every wrapper runs its plain version (``repro_torch.kernels.ref``) only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts kernel launches per wrapper and nothing else.

This slice ports the l2 tile (which also serves cosine, mapped onto the
unit sphere by the engine).  The JSD and Triangular tiles of the reference
family are still to port (ROADMAP Queue 2 items 4-5); the metric-dispatched
entry points refuse them.
"""

from __future__ import annotations

import ctypes
import math

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

KERNEL_METRICS = ("l2",)

LAUNCHES = {"pairwise_l2": 0, "masked_pairwise_l2": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "pairwise_l2": [_P, _P, _P, _I, _I, _I, _I, _P],
    "masked_pairwise_l2": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


def _check_pair(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.ndim != 2 or y.ndim != 2:
        raise ValueError(f"x and y must be 2-D, got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.shape[1] != y.shape[1]:
        raise ValueError(
            f"x and y must share the feature dimension: {tuple(x.shape)} vs {tuple(y.shape)}"
        )
    if x.device != y.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")
    if y.dtype == torch.bfloat16:
        raise NotImplementedError(
            "bf16 y (the bf16 exact phase) is not ported yet: ROADMAP Queue 1 item 5"
        )
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"x and y must be float32, got {x.dtype} and {y.dtype}")


def _check_launchable(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous row-major tensors")


def _mask_shape(m: int, n: int, bm: int, bn: int) -> tuple[int, int]:
    return (math.ceil(m / bm), math.ceil(n / bn))


def pairwise_l2_kernel_call(
    x: torch.Tensor, y: torch.Tensor, *, squared: bool = False
) -> torch.Tensor:
    """(m, K), (n, K) float32 -> (m, n) Euclidean (or squared) distances."""
    _check_pair(x, y)
    if x.device.type == "cpu":
        return ref.pairwise_l2_ref(x, y, squared=squared)
    _check_launchable(x, y)
    (m, k), n = x.shape, y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        with torch.cuda.device(x.device):
            lib = _build.library("pairwise_dist", _SIGNATURES)
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.pairwise_l2(
                x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
                int(squared), stream,
            )
        _build.check(err, "pairwise_l2")
        LAUNCHES["pairwise_l2"] += 1
    return out


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
    _check_pair(x, y)
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
    if x.device.type == "cpu":
        return ref.masked_pairwise_l2_ref(x, y, tile_mask, bm, bn, squared=squared)
    mask = tile_mask.to(torch.int32).contiguous()
    _check_launchable(x, y, mask)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        with torch.cuda.device(x.device):
            lib = _build.library("pairwise_dist", _SIGNATURES)
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.masked_pairwise_l2(
                x.data_ptr(), y.data_ptr(), mask.data_ptr(), out.data_ptr(),
                m, n, k, bm, bn, int(squared), stream,
            )
        _build.check(err, "masked_pairwise_l2")
        LAUNCHES["masked_pairwise_l2"] += 1
    return out


def _require_kernel(metric_name: str) -> None:
    if metric_name not in KERNEL_METRICS:
        raise NotImplementedError(
            f"no CUDA tile kernel for {metric_name!r} yet (this slice has "
            f"{KERNEL_METRICS}); JSD and Triangular are ROADMAP Queue 2 "
            f"items 4-5"
        )


def pairwise_kernel_call(
    metric_name: str, x: torch.Tensor, y: torch.Tensor
) -> torch.Tensor:
    """Metric-dispatched (m, K), (n, K) -> (m, n) distance matrix for every
    metric in ``KERNEL_METRICS``."""
    _require_kernel(metric_name)
    return pairwise_l2_kernel_call(x, y)


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
    metric in ``KERNEL_METRICS``."""
    _require_kernel(metric_name)
    return masked_pairwise_l2_kernel_call(x, y, tile_mask, bm=bm, bn=bn)
