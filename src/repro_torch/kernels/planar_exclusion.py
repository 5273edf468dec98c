"""Planar lower bound on the H100 — the port of
``repro.kernels.planar_exclusion``.

``lb[q, b] = max_m dist2d(apex_m(q), box[b, m])``: the apex projection of
each query onto every pivot-pair plane, point-to-box distance, and the max
over planes, in one CUDA kernel (``csrc/planar_exclusion.cu``; its source
note says what it replaces, what bounds it and how).  Two forms run it:
``planar_lower_bound_kernel_call`` takes each plane's pivot distances d1,
d2 as (Q, M) matrices, as the Pallas call does;
``planar_lower_bound_pairs_kernel_call`` takes the (Q, P) query -> pivot
matrix and the (M, 2) pivot pairs and gathers d1, d2 inside the kernel,
which is how the engine calls it.  Both equal their plain versions bit for
bit.

The wrappers run the plain versions (``repro_torch.kernels.ref``) only for
tensors on the CPU; for CUDA tensors they launch the kernel or raise.
``LAUNCHES`` counts kernel launches, per form, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = [
    "planar_lower_bound_kernel_call",
    "planar_lower_bound_pairs_kernel_call",
    "LAUNCHES",
]

LAUNCHES = {"planar_lower_bound": 0, "planar_lower_bound_pairs": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "planar_lower_bound": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "planar_lower_bound_pairs": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def _check_planes(deltas: torch.Tensor, boxes: torch.Tensor, m: int, device) -> int:
    """Checks shared by both forms; returns the number of blocks B."""
    b = boxes.shape[0]
    if deltas.shape != (m,) or boxes.shape != (b, m, 4):
        raise ValueError(
            f"deltas {tuple(deltas.shape)} and boxes {tuple(boxes.shape)} do "
            f"not agree on (M,), (B, M, 4) with M = {m}"
        )
    if m < 1:
        raise ValueError("need at least one plane")
    if deltas.device != device or boxes.device != device:
        raise ValueError("all inputs must share one device")
    if deltas.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise TypeError("deltas and boxes must be float32")
    return b


def _launch(fn: str, tensors: tuple, ints: tuple, q: int, b: int) -> torch.Tensor:
    """Run C entry point ``fn`` on ``tensors`` (CUDA, boxes last), a (Q, B)
    output and ``ints``."""
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous row-major tensors")
    if tensors[-1].data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (read as float4)")
    device = tensors[0].device
    out = torch.empty((q, b), dtype=torch.float32, device=device)
    if q and b:
        with torch.cuda.device(device):
            lib = _build.library("planar_exclusion", _SIGNATURES)
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(lib, fn)(*(t.data_ptr() for t in tensors), out.data_ptr(),
                                   *ints, stream)
        _build.check(err, fn)
        _build.count_launch(LAUNCHES, fn)
    return out


def planar_lower_bound_kernel_call(
    d1: torch.Tensor,
    d2: torch.Tensor,
    deltas: torch.Tensor,
    boxes: torch.Tensor,
) -> torch.Tensor:
    """d1, d2: (Q, M) query distances to each plane's two pivots; deltas:
    (M,); boxes: (B, M, 4) = (x_lo, x_hi, y_lo, y_hi).  Returns (Q, B)
    float32 lower bounds.  Empty (padding) blocks carry +-3e38 sentinel
    boxes and come out +inf."""
    q, m = d1.shape
    if d2.shape != d1.shape:
        raise ValueError(f"d1 {tuple(d1.shape)} and d2 {tuple(d2.shape)} do not agree")
    b = _check_planes(deltas, boxes, m, d1.device)
    if d2.device != d1.device:
        raise ValueError("all inputs must share one device")
    if d1.dtype != torch.float32 or d2.dtype != torch.float32:
        raise TypeError("d1 and d2 must be float32")
    if d1.device.type == "cpu":
        return ref.planar_lower_bound_ref(d1, d2, deltas, boxes)
    if not d1.is_cuda:
        raise ValueError(f"expected CUDA tensors, got {d1.device}")
    return _launch("planar_lower_bound", (d1, d2, deltas, boxes), (q, m, b), q, b)


def planar_lower_bound_pairs_kernel_call(
    dqp: torch.Tensor,
    pairs: torch.Tensor,
    deltas: torch.Tensor,
    boxes: torch.Tensor,
) -> torch.Tensor:
    """The same bound from dqp: (Q, P) query -> pivot distances and pairs:
    (M, 2) int64 pivot indices per plane, each in [0, P); d1 = dqp[:,
    pairs[:, 0]], d2 = dqp[:, pairs[:, 1]].  The kernel does not check the
    indices (that would synchronise): the index checks them once when it
    is built (``BSSIndex.device``)."""
    q, p = dqp.shape
    m = pairs.shape[0]
    if pairs.shape != (m, 2):
        raise ValueError(f"pairs {tuple(pairs.shape)} is not (M, 2)")
    b = _check_planes(deltas, boxes, m, dqp.device)
    if pairs.device != dqp.device:
        raise ValueError("all inputs must share one device")
    if dqp.dtype != torch.float32:
        raise TypeError("dqp must be float32")
    if pairs.dtype != torch.int64:
        raise TypeError("pairs must be int64")
    if dqp.device.type == "cpu":
        return ref.planar_lower_bound_pairs_ref(dqp, pairs, deltas, boxes)
    if not dqp.is_cuda:
        raise ValueError(f"expected CUDA tensors, got {dqp.device}")
    return _launch("planar_lower_bound_pairs", (dqp, pairs, deltas, boxes), (q, p, m, b),
                   q, b)
