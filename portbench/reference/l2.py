"""Euclidean distance."""

from __future__ import annotations

import contextlib

import torch


def prepare(x: torch.Tensor) -> torch.Tensor:
    return x


def pair_bytes(d: int) -> int:
    """Bytes of the float64 intermediates ``pairwise`` holds per pair."""
    return 24


def pairwise(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    # the matrix-product identity; in float64 its cancellation stays far
    # below the float32 rounding the program is held to
    sq = (q * q).sum(-1)[:, None] + (x * x).sum(-1)[None, :] - 2.0 * (q @ x.T)
    return torch.sqrt(torch.clamp_min(sq, 0.0))


def paired(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(((q[:, None, :] - x) ** 2).sum(-1))


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (nearest, ties away), as a
    tensor core rounds its inputs."""
    bits = t.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def _tf32(device: torch.device):
    if device.type != "cuda":
        yield False
        return
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def control(q: torch.Tensor, x: torch.Tensor, precision: str) -> torch.Tensor:
    """``pairwise`` in float32 with its product in TF32 (the card's tensor
    cores; elsewhere the inputs are rounded to TF32 and multiplied in
    float32), or with every step in bfloat16."""
    if precision == "bf16":
        return pairwise(q.to(torch.bfloat16), x.to(torch.bfloat16)).float()
    if precision != "tf32":
        raise ValueError(f"l2 has a tf32 or bf16 control, not {precision!r}")
    q, x = q.float(), x.float()
    with _tf32(q.device) as native:
        if not native:
            q, x = _round_tf32(q), _round_tf32(x)
        return pairwise(q, x)
