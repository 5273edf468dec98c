"""Planar lower bound on the H100 — the port of
``repro.kernels.planar_exclusion``.

``lb[q, b] = max_m dist2d(apex_m(q), box[b, m])``: the apex projection of
each query onto every pivot-pair plane, point-to-box distance, and the max
over planes, in one CUDA kernel (``csrc/planar_exclusion.cu``; its source
note says what it replaces, what bounds it and how).  It is built without
FMA contraction and equals its plain version bit for bit.

The wrapper runs the plain version (``repro_torch.kernels.ref``) only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = ["planar_lower_bound_kernel_call", "LAUNCHES"]

LAUNCHES = {"planar_lower_bound": 0}

# the kernel stages 2 x 8 x M floats of apex coordinates in shared memory;
# 768 planes keep that under the 48 KB a launch gets without opting in
MAX_PLANES = 768

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"planar_lower_bound": [_P, _P, _P, _P, _P, _I, _I, _I, _P]}


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
    b = boxes.shape[0]
    if d2.shape != d1.shape or deltas.shape != (m,) or boxes.shape != (b, m, 4):
        raise ValueError(
            f"shapes d1 {tuple(d1.shape)}, d2 {tuple(d2.shape)}, deltas "
            f"{tuple(deltas.shape)}, boxes {tuple(boxes.shape)} do not agree "
            f"on (Q, M), (M,), (B, M, 4)"
        )
    if m < 1:
        raise ValueError("need at least one plane")
    tensors = (d1, d2, deltas, boxes)
    if any(t.device != d1.device for t in tensors):
        raise ValueError("d1, d2, deltas and boxes must share one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("d1, d2, deltas and boxes must be float32")
    if d1.device.type == "cpu":
        return ref.planar_lower_bound_ref(d1, d2, deltas, boxes)
    if not d1.is_cuda:
        raise ValueError(f"expected CUDA tensors, got {d1.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous row-major tensors")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (read as float4)")
    if m > MAX_PLANES:
        raise ValueError(f"at most {MAX_PLANES} planes, got {m}")
    out = torch.empty((q, b), dtype=torch.float32, device=d1.device)
    if q and b:
        with torch.cuda.device(d1.device):
            lib = _build.library("planar_exclusion", _SIGNATURES)
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.planar_lower_bound(
                d1.data_ptr(), d2.data_ptr(), deltas.data_ptr(),
                boxes.data_ptr(), out.data_ptr(), q, m, b, stream,
            )
        _build.check(err, "planar_lower_bound")
        LAUNCHES["planar_lower_bound"] += 1
    return out
