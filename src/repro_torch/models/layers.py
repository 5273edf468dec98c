"""Transformer building blocks of the port — ``repro.models.layers`` in
PyTorch: RMSNorm, RoPE, GQA attention (full / sliding window / softcapped,
against a bf16 or an int8 KV cache), SwiGLU MLP, and a sort-based MoE with a
capacity bound.

Every function is plain torch on tensors, as the reference's are plain jnp:
none of them reaches a Pallas kernel there.  They follow the reference's
arithmetic where a bit or an order can move:

* A float32 product runs in IEEE float32 (``check_ieee_fp32``); the
  attention products of bf16 operands are formed in float32 (a bf16 product
  is exact there), as ``preferred_element_type=float32`` asks, and the
  probabilities are rounded to the value dtype before the second product.
* Heads group kv-major: query head ``h = kv * g + j``.
* A quotient by a constant is one tensor division (``_div``): torch
  multiplies a CUDA tensor by the reciprocal of a Python divisor.
* RoPE's frequencies are the correctly rounded float32 values (JAX's at
  every head width the configs use) and its cos / sin are taken in float64
  and rounded: torch's float32 ``cos`` on the CPU is 1.5e-4 off at angles
  near 32,768 (positions of the 32K cells), where JAX's is within an ulp.
* The MoE's top-k keeps the lowest expert on ties (``jax.lax.top_k``), its
  sort is stable, the drop bin is a row of the dispatch buffer, and the
  combine sums each token's k rows in one fixed order (the order the
  reference's scatter applies them), rounding after each add.

Every function is differentiable (the LM train step runs through them):
the in-place ``mul_`` and ``masked_fill_`` on the score tensor act on a
tensor no backward formula saves (the einsum keeps its inputs, a product
with a scalar keeps nothing, the softcap's product keeps its operands), so
autograd accepts them and they save a score tensor's worth of memory.
The MoE's ``index_put_(accumulate=True)`` dispatch, its gathers and the
combine's loop carry gradients as the reference's scatter and gathers do:
a dropped pair's weight is 0, so neither the drop row nor the row its
clamped gather reads gets a gradient from it, and the top-k's gradient
goes to the experts it picked.  The reference's ``aux`` loss is returned
as a value; the decoder drops it, as the reference's does.

The reference's ``_axprod`` (mesh-axis sizes) is 1 on one card and is not
ported; a non-None ``token_axes`` / ``expert_axis`` changes nothing here, as
``maybe_constrain`` changes nothing without a mesh.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.distances import check_ieee_fp32

__all__ = [
    "NEG_INF",
    "rms_norm",
    "softcap",
    "rope",
    "gqa_attention",
    "gqa_attention_quantized",
    "quantize_kv",
    "swiglu",
    "gqa_attention_qchunked",
    "MoEDims",
    "moe_block",
]

NEG_INF = -2.0e38


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d tensor of ``like``'s dtype on its device: a Python
    scalar rounded as JAX rounds a weakly typed constant to the array's
    dtype."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as one division in ``x``'s dtype."""
    return torch.div(x, _const(c, x))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``, each op rounded to ``x``'s dtype."""
    return x * torch.sigmoid(x)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.float32:
        check_ieee_fp32(a)
    return a @ b


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return y.to(dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return _const(cap, x) * torch.tanh(_div(x, cap))


@functools.lru_cache(maxsize=None)
def _freq(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """``theta ** (-arange(half) / half)`` correctly rounded to float32, on
    ``device``: made once per device, so a decode step copies nothing from
    the host."""
    f64 = np.float64  # lint: disable=R3
    freq = f64(theta) ** (-np.arange(half, dtype=np.float32).astype(f64) / half)
    return torch.from_numpy(freq.astype(np.float32)).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, n, d_head), positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    ang = positions[..., None].float() * _freq(half, theta, x.device)  # (..., S, half)
    ang64 = ang.double()  # lint: disable=R3
    cos = torch.cos(ang64).float()[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang64).float()[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _mask(q_positions, kv_positions, kv_valid, window) -> torch.Tensor:
    """(B, 1, 1, S, T) bool: causal, within ``window``, cache slot valid."""
    qp, kp = q_positions[:, :, None], kv_positions[:, None, :]
    mask = qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    if kv_valid is not None:
        mask &= kv_valid[:, None, :]
    return mask[:, None, None, :, :]


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    scores = scores.masked_fill_(~mask, NEG_INF)
    return torch.softmax(scores.float(), dim=-1)


def _scores(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``einsum("bskgd,btkd->bkgst")`` with float32 products and sums."""
    qf, kf = qg.float(), k.float()
    check_ieee_fp32(qf)
    return torch.einsum("bskgd,btkd->bkgst", qf, kf)


def _values(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum("bkgst,btkd->bskgd")`` with float32 products and sums."""
    return torch.einsum("bkgst,btkd->bskgd", probs.float(), v.float())


def gqa_attention(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,  # (B, T, KV, Dh)
    v: torch.Tensor,  # (B, T, KV, Dh)
    q_positions: torch.Tensor,  # (B, S) int
    kv_positions: torch.Tensor,  # (B, T) int
    kv_valid: torch.Tensor | None = None,  # (B, T) bool — cache occupancy
    window: int | None = None,  # sliding window (local attention)
    attn_softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal grouped-query attention; supports decode (S=1, long T) and
    train/prefill (S == T).  Softmax in fp32; outputs in q.dtype."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else dh**-0.5
    qg = q.reshape(b, s, kvh, g, dh)
    scores = _scores(qg, k).mul_(scale)
    scores = softcap(scores, attn_softcap)
    probs = _masked_softmax(scores, _mask(q_positions, kv_positions, kv_valid, window))
    out = _values(probs.to(v.dtype), v)
    return out.reshape(b, s, h, dh).to(q.dtype)


def gqa_attention_quantized(
    q: torch.Tensor,          # (B, S, H, Dh)
    k_q: torch.Tensor,        # (B, T, KV, Dh) int8
    k_scale: torch.Tensor,    # (B, T, KV) fp32, absmax/127 per (pos, head)
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_valid: torch.Tensor | None = None,
    window=None,
    attn_softcap: float | None = None,
) -> torch.Tensor:
    """Attention against an int8-quantised KV cache (KIVI-style per-token,
    per-head scales).  The scales factor OUT of the dh contraction, so they
    are applied to the score matrix / folded into the probabilities — the
    dequantised cache is never materialised:

        scores = (q . k_q) * k_scale[t]
        out    = (probs * v_scale[t]) . v_q
    """
    b, s, h, dh = q.shape
    kvh = k_q.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, dh)
    scores = _scores(qg, k_q.to(q.dtype)).mul_(dh**-0.5)
    scores = scores * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    scores = softcap(scores, attn_softcap)
    probs = _masked_softmax(scores, _mask(q_positions, kv_positions, kv_valid, window))
    probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    out = _values(probs.to(q.dtype), v_q.to(q.dtype))
    return out.reshape(b, s, h, dh).to(q.dtype)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, KV, Dh) -> int8 values + (B, S, KV) fp32 scales."""
    xf = x.float()
    scale = _div(torch.amax(torch.abs(xf), dim=-1), 127.0)
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = _silu(_matmul(x, w_gate)) * _matmul(x, w_up)
    return _matmul(h, w_down)


def gqa_attention_qchunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_valid: torch.Tensor | None = None,
    window=None,
    attn_softcap: float | None = None,
    chunk: int = 2048,
) -> torch.Tensor:
    """Query-chunked attention for long prefill: a loop over query chunks
    bounds the live score tensor to (B, H, chunk, T) (each chunk's softmax
    is complete because keys are fully resident; no online rescaling)."""
    b, s, h, dh = q.shape
    if s % chunk or s <= chunk:
        return gqa_attention(
            q, k, v, q_positions, kv_positions, kv_valid, window, attn_softcap
        )
    outs = [
        gqa_attention(q[:, i:i + chunk], k, v, q_positions[:, i:i + chunk],
                      kv_positions, kv_valid, window, attn_softcap)
        for i in range(0, s, chunk)
    ]
    return torch.cat(outs, dim=1)


@dataclasses.dataclass(frozen=True)
class MoEDims:
    n_experts: int
    top_k: int
    capacity: int  # per-expert token capacity (global, per microbatch)
    expert_axis: str | None = None  # mesh axis for expert parallelism
    token_axes: tuple | None = None  # mesh axes of the flattened token dim


def _top_k_largest(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: each row's k largest, descending, the lowest
    index first among equals (a stable descending sort keeps it)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(
    x: torch.Tensor,  # (B, S, D)
    router_w: torch.Tensor,  # (D, E)
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
    dims: MoEDims,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based token->expert dispatch (MaxText/MegaBlocks-style permute):

      route -> top-k -> flatten (token, expert) pairs -> sort by expert ->
      rank-in-expert -> scatter into an (E, C, D) buffer (drop beyond C) ->
      batched expert GEMMs -> gather back -> weighted combine.

    The drop bin is an extra row ``C`` of the buffer (the reference scatters
    there with ``mode="drop"``; an out-of-range write on the card is a
    device-side assert), and a dropped pair gathers row ``C - 1`` back, as
    the reference's clamping gather does, times a weight of 0.  No value
    is read to the host.

    Returns (output (B,S,D), aux_load_balance_loss scalar).
    """
    b, s, d = x.shape
    e, k, cap = dims.n_experts, dims.top_k, dims.capacity
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    dev = x.device

    logits = _matmul(tokens.float(), router_w.float())  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k_largest(probs, k)  # (T, k)
    top_p = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)

    # aux loss (Switch-style load balancing)
    density = torch.mean(
        torch.nn.functional.one_hot(top_e[:, 0], e).to(torch.float32), dim=0
    )
    density_prob = torch.mean(probs, dim=0)
    aux = torch.sum(density * density_prob) * e

    flat_e = top_e.reshape(-1)  # (T*k,)
    flat_p = top_p.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = torch.searchsorted(se, torch.arange(e, device=dev, dtype=se.dtype), right=False)
    pos = torch.arange(t * k, device=dev) - first[se]
    tok_of = order // k
    keep = pos < cap
    slot = torch.where(keep, pos, cap)  # cap row == drop bin

    gathered = tokens[tok_of]  # (T*k, D)
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=dev)
    buf.index_put_((se, slot), torch.where(keep[:, None], gathered, 0).to(x.dtype),
                   accumulate=True)
    buf = buf[:, :cap]
    # expert GEMMs emit x.dtype (bf16), accumulating in fp32
    h = _silu(_matmul(buf, w_gate)) * _matmul(buf, w_up)
    out_buf = _matmul(h.to(x.dtype), w_down).to(x.dtype)

    back = out_buf[se, torch.clamp_max(slot, cap - 1)]  # (T*k, D)
    vals = back * torch.where(keep, flat_p[order], 0.0)[:, None].to(x.dtype)
    # the combine: each token's k rows in the order the sorted pairs hold
    # them (the order the reference's scatter-add applies them), rounded to
    # x.dtype after each add, starting from zeros
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k, device=dev)
    seq = torch.sort(rank.reshape(t, k), dim=1).values  # (T, k) sorted positions
    combined = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for j in range(k):
        combined = combined + vals[seq[:, j]]
    return combined.reshape(b, s, d), aux
