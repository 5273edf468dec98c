"""Gradient compression of the port: int8 quantisation with error feedback,
the port of ``repro.optim.compression``.

The data-parallel all-reduce is where int8 gradients (fp32 -> int8 + one
scale per tensor) would cut the bytes on the wire; error feedback (Seide et
al., 2014; Karimireddy et al., 2019) keeps the quantisation residual and
adds it back the next step.  One card has no such reduce, so this is the
arithmetic and its convergence behaviour, as in the reference.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import torch

from repro_torch.pytree import leaves, unflatten

__all__ = ["int8_error_feedback", "int8_error_feedback_"]


def _quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    top = torch.clamp_min(torch.amax(torch.abs(g)), 1e-12)
    scale = torch.div(top, torch.full((), 127.0, dtype=torch.float32, device=g.device))
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _one(g: torch.Tensor, r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(one leaf's compressed-then-decompressed gradient, its new residual)."""
    g32 = g.float() + r
    q, s = _quantize(g32)
    deq = _dequantize(q, s)
    return deq.to(g.dtype), g32 - deq


@torch.no_grad()
def int8_error_feedback(grads, residuals):
    """Returns (compressed-then-decompressed grads, new residuals).

    ``residuals`` matches ``grads`` (float32); pass zeros initially.
    """
    out = [_one(g, r) for g, r in zip(leaves(grads), leaves(residuals))]
    return unflatten(grads, [o[0] for o in out]), unflatten(grads, [o[1] for o in out])


@torch.no_grad()
def int8_error_feedback_(grads, residuals):
    """``int8_error_feedback`` with each new residual written into the old
    one in place (the same operations, leaf by leaf); returns the
    compressed-then-decompressed grads."""
    out = []
    for g, r in zip(leaves(grads), leaves(residuals)):
        deq, new_r = _one(g, r)
        r.copy_(new_r)
        out.append(deq)
    return unflatten(grads, out)
