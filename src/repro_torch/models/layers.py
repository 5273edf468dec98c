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

The reference's ``_axprod`` (mesh-axis sizes) is not ported: on one
device ``moe_block`` runs the whole batch, and over a mesh
``moe_block_split`` runs it expert-parallel (its note), the experts where
their weights' specs put them (``expert_axis``, when set, must name
``"model"``, the axis those specs split experts over) and the rows where
the batch's split over the data axes (``token_axes``) puts them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.distances import check_ieee_fp32
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import dp_axes

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
    "route_stats",
    "SplitLayout",
    "moe_block_split",
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


def _router(tokens: torch.Tensor, router_w: torch.Tensor, k: int):
    """The router over (T, D) tokens: the probabilities (T, E) and each
    token's top k, weights renormalised to sum to 1 and expert ids."""
    probs = torch.softmax(_matmul(tokens.float(), router_w.float()), dim=-1)
    top_p, top_e = _top_k_largest(probs, k)
    return probs, top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9), top_e


def _route(flat_e: torch.Tensor, e: int, k: int, cap: int) -> dict:
    """The sort that decides drops, over the (token, expert) pairs of a
    whole microbatch (T * k,) in token order: ``order`` (the stable sort
    by expert), ``se`` (the sorted experts), ``slot`` (each sorted pair's
    rank in its expert, ``cap`` past capacity), ``keep``, ``rank`` (each
    pair's position in the sorted order) and ``table`` (E, C): the token
    in each buffer slot (-1 if none)."""
    dev = flat_e.device
    tk = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = torch.searchsorted(se, torch.arange(e, device=dev, dtype=se.dtype), right=False)
    pos = torch.arange(tk, device=dev) - first[se]
    keep = pos < cap
    slot = torch.where(keep, pos, cap)  # cap row == drop bin
    table = torch.full((e, cap + 1), -1, dtype=torch.long, device=dev)
    table[se, slot] = order // k
    rank = torch.empty_like(order)
    rank[order] = torch.arange(tk, device=dev)
    return dict(order=order, se=se, slot=slot, keep=keep, rank=rank, table=table[:, :cap])


def route_stats(top_e, se, keep, e: int, cap: int) -> dict:
    """A routing's expert ids (T, k), capacity, and per expert the pairs
    kept (``loads``) and dropped (``drops``)."""
    return dict(top_e=top_e.reshape(-1, top_e.shape[-1]), capacity=cap,
                loads=torch.bincount(se[keep], minlength=e),
                drops=torch.bincount(se[~keep], minlength=e))


def moe_block(
    x: torch.Tensor,  # (B, S, D)
    router_w: torch.Tensor,  # (D, E)
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
    dims: MoEDims,
    stats: dict | None = None,
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

    Returns (output (B,S,D), aux_load_balance_loss scalar); ``stats``, when
    given, receives the routing (``route_stats``).
    """
    b, s, d = x.shape
    e, k, cap = dims.n_experts, dims.top_k, dims.capacity
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    dev = x.device

    probs, top_p, top_e = _router(tokens, router_w, k)  # (T, E), (T, k), (T, k)

    # aux loss (Switch-style load balancing)
    density = torch.mean(
        torch.nn.functional.one_hot(top_e[:, 0], e).to(torch.float32), dim=0
    )
    density_prob = torch.mean(probs, dim=0)
    aux = torch.sum(density * density_prob) * e

    rt = _route(top_e.reshape(-1), e, k, cap)  # over the (T*k,) pairs
    order, se, slot, keep = rt["order"], rt["se"], rt["slot"], rt["keep"]
    if stats is not None:
        stats.update(route_stats(top_e, se, keep, e, cap))

    gathered = tokens[order // k]  # (T*k, D)
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=dev)
    buf.index_put_((se, slot), torch.where(keep[:, None], gathered, 0).to(x.dtype),
                   accumulate=True)
    buf = buf[:, :cap]
    # expert GEMMs emit x.dtype (bf16), accumulating in fp32
    h = _silu(_matmul(buf, w_gate)) * _matmul(buf, w_up)
    out_buf = _matmul(h.to(x.dtype), w_down).to(x.dtype)

    back = out_buf[se, torch.clamp_max(slot, cap - 1)]  # (T*k, D)
    vals = back * torch.where(keep, top_p.reshape(-1)[order], 0.0)[:, None].to(x.dtype)
    # the combine: each token's k rows in the order the sorted pairs hold
    # them (the order the reference's scatter-add applies them), rounded to
    # x.dtype after each add, starting from zeros
    seq = torch.sort(rt["rank"].reshape(t, k), dim=1).values  # (T, k) sorted positions
    combined = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for j in range(k):
        combined = combined + vals[seq[:, j]]
    return combined.reshape(b, s, d), aux


# ------------------------------------------------------------ model split


@dataclasses.dataclass(frozen=True)
class SplitLayout:
    """Where a model-split step's compute lies on a mesh whose last axis is
    ``"model"`` (or that has none): rank ``r`` (mesh device ``r``) is data
    shard ``r // m`` and model shard ``r % m``.  Data shard ``s`` holds the
    microbatch's rows ``rows[s]``; under ``seq`` the residual stream of a
    row is split over the model shards by sequence (pieces of
    ``ceil(S / m)``), else every model shard holds all of it."""

    mesh: object
    m: int
    rows: tuple  # ((b0, b1), ...) per data shard
    seq_len: int
    seq: bool
    probe: bool = False  # meta only: device 0 computes, every device reads it

    def each(self, fn, *lists) -> list:
        """``[fn(r, *(l[r] for l in lists)) for every rank r]``; under
        ``probe`` rank 0's result stands for every rank's (the dry run
        reckons one device, and the ranks' shapes are alike)."""
        if self.probe:
            return [fn(0, *(lst[0] for lst in lists))] * self.R
        return [fn(r, *(lst[r] for lst in lists)) for r in range(self.R)]

    @property
    def R(self) -> int:
        return self.mesh.n_devices

    @property
    def D(self) -> int:
        return self.R // self.m

    @property
    def data_axes(self) -> tuple:
        return dp_axes(self.mesh)

    def device(self, r: int) -> torch.device:
        return self.mesh.devices[r]

    def seq_piece(self, j: int) -> tuple[int, int]:
        return coll.piece_bounds(self.seq_len, self.m, j) if self.seq else (0, self.seq_len)

    def over_model(self, fn, xs, *args):
        """The collective ``fn(xs, mesh, "model", *args)``, or ``xs`` with
        one model shard."""
        if self.m == 1:
            return list(xs)
        return fn(xs, self.mesh, "model", *args, probe=self.probe)

    def over_data(self, fn, xs, *args):
        if self.D == 1:
            return list(xs)
        return fn(xs, self.mesh, self.data_axes, *args, probe=self.probe)

    def token_ids(self, r: int, device) -> torch.Tensor:
        """The microbatch positions ``b * S + t`` of rank r's tokens, in the
        order its activations hold them (rows, then sequence)."""
        b0, b1 = self.rows[r // self.m]
        t0, t1 = self.seq_piece(r % self.m)
        b = torch.arange(b0, b1, device=device)
        t = torch.arange(t0, t1, device=device)
        return (b[:, None] * self.seq_len + t[None, :]).reshape(-1)

    def holder(self, tok: torch.Tensor, column: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(rank, local row) that holds each microbatch position ``tok``
        (>= 0): under ``seq`` the one rank whose piece holds it, else the
        copy in model column ``column``."""
        b, t = tok // self.seq_len, tok % self.seq_len
        s = torch.zeros_like(b)
        for b0, b1 in self.rows[1:]:
            if b1 > b0:
                s = s + (b >= b0).long()
        b_local = b - _lookup(s, [b0 for b0, _ in self.rows])
        if self.seq:
            step = -(-self.seq_len // self.m)
            j = t // step
            width = torch.clamp_max(self.seq_len - j * step, step)
            return s * self.m + j, b_local * width + (t - j * step)
        return s * self.m + column, b_local * self.seq_len + t


def _lookup(index: torch.Tensor, values: list) -> torch.Tensor:
    """``values[index]`` for a few host ints, formed on ``index``'s device
    from comparisons (a host list made a tensor would wait for the host)."""
    out = torch.zeros_like(index)
    for i, v in enumerate(values):
        if v:
            out = out + (index == i).long() * v
    return out


def moe_block_split(
    xs: list,       # per rank: (B_s, S_r, D), the tokens it holds
    routers: list,  # per rank: (D, E)
    gates: list,    # per rank: (E_r, D, F), its experts
    ups: list,
    downs: list,    # per rank: (E_r, F, D)
    dims: MoEDims,
    lay: SplitLayout,
    expert_split: bool,
    stats: dict | None = None,
) -> tuple[list, list]:
    """``moe_block`` over a mesh, expert-parallel: the same function of the
    whole microbatch.

    * Routing: each rank routes the tokens it holds (router product, top-k);
      the (T, k) expert ids are all-gathered (over ``"model"`` by sequence
      under ``seq``, then over the data axes by rows) into the one-device
      token order, and every device sorts them as ``moe_block`` does, so
      the ranks in expert and the capacity are counted over the whole
      microbatch.
    * Owners: rank ``(s, j)`` owns experts ``[j E / m, (j + 1) E / m)``
      (``expert_split``: the weights' spec splits experts over
      ``"model"``) and capacity slots ``[s C / D, (s + 1) C / D)``; without
      the expert split it owns every expert and slots ``[r C / R, …)``.
    * Dispatch (the token all-to-all): each owner fills its slots of the
      (E, C, D) buffer with the rows its slots name, each copied from the
      rank that holds it.
    * Expert products on the owner; the combine brings each token's k
      rows back to its holder and sums them in ``moe_block``'s order (by
      expert, rounding after each add).

    Each token's routing weights stay on the rank that holds it, so only
    ids cross for the routing.  Returns (outputs per rank, like ``xs``; the aux loss per
    rank, its density over the whole microbatch); ``stats``, when given,
    receives the routing as the lead device sorted it (``route_stats``)."""
    if dims.expert_axis not in (None, "model"):
        raise ValueError(f"expert_axis must be None or 'model', got {dims.expert_axis!r}")
    e, k, cap = dims.n_experts, dims.top_k, dims.capacity
    R, m = lay.R, lay.m
    d = xs[0].shape[-1]
    dtype = xs[0].dtype
    each = lay.each
    toks = each(lambda r, x: x.reshape(-1, d), xs)

    # routing of the tokens each rank holds
    routed = each(lambda r, tk_, w: _router(tk_, w, k), toks, routers)
    probs, top_p, top_e = ([x[i] for x in routed] for i in range(3))
    ids = each(lambda r, te, x: te.reshape(x.shape[0], x.shape[1], k), top_e, xs)
    if lay.seq:
        ids = lay.over_model(coll.all_gather, ids, 1)
    ids = lay.over_data(coll.all_gather, ids, 0)
    t = ids[0].shape[0] * ids[0].shape[1]
    routes: dict = {}
    for r in range(R):
        dev = lay.device(r)
        if dev not in routes:
            routes[dev] = _route(ids[r].reshape(-1), e, k, cap)
    if stats is not None:
        rt = routes[lay.device(0)]
        stats.update(route_stats(ids[0].reshape(-1, k), rt["se"], rt["keep"], e, cap))

    # aux loss: the density from the gathered ids, the mean probability by
    # an all-reduce over the ranks that hold distinct tokens
    dprob = each(lambda r, p: p.sum(dim=0), probs)
    dprob = lay.over_data(coll.all_reduce, lay.over_model(coll.all_reduce, dprob)
                          if lay.seq else dprob)

    def aux_loss(r, ids_r, dp):
        first = ids_r.reshape(t, k)[:, 0]
        # ``one_hot``'s 0/1 matrix, from a comparison (one_hot reads its
        # input's range on the host)
        hot = first[:, None] == torch.arange(e, device=first.device)
        return torch.sum(torch.mean(hot.to(torch.float32), dim=0) * (dp / t)) * e

    aux = each(aux_loss, ids, dprob)

    if expert_split:
        e_step, c_step = -(-e // m), -(-cap // lay.D)
    else:
        e_step, c_step = e, -(-cap // R)

    def owns(r: int) -> tuple[tuple[int, int], tuple[int, int]]:
        if expert_split:
            return (coll.piece_bounds(e, m, r % m), coll.piece_bounds(cap, lay.D, r // m))
        return (0, e), coll.piece_bounds(cap, R, r)

    def owner(se_p: torch.Tensor, slot_p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(rank, row in its (E_r * C_r) buffer) that owns each kept pair."""
        c = torch.clamp_max(slot_p, cap - 1)
        j, s = se_p // e_step, c // c_step
        width = torch.clamp_max(cap - s * c_step, c_step)
        rank = s * m + j if expert_split else s
        return rank, (se_p - j * e_step) * width + (c - s * c_step)

    def pool(parts: list, ranks, dev) -> tuple[torch.Tensor, list]:
        """``parts[r]`` of ``ranks`` stacked on ``dev`` (the exchange's rows
        in one tensor), and each rank's first row in it."""
        base, n = [0] * R, 0
        for r in ranks:
            base[r], n = n, n + parts[r].shape[0]
        return torch.cat([parts[r].to(dev) for r in ranks]), base

    zero = lambda dev: torch.zeros((), dtype=dtype, device=dev)  # noqa: E731

    # dispatch (the all-to-all) and the expert products, on each owner
    def expert(r, gate, up, down):
        dev = lay.device(r)
        (e0, e1), (c0, c1) = owns(r)
        if c1 <= c0:
            return None
        table = routes[dev]["table"][e0:e1, c0:c1]
        sources = range(R) if lay.seq else range(r % m, R, m)
        rows, base = pool(toks, sources, dev)
        src, local = lay.holder(torch.clamp_min(table, 0), r % m)
        buf = torch.where((table >= 0)[..., None], rows[_lookup(src, base) + local], zero(dev))
        if r == 0:  # one device's bytes, as the collectives tally them
            n = len(sources)
            buf = coll.moved(buf, "all-to-all", buf.numel() * buf.element_size() * (n - 1) / n)
        h = _silu(_matmul(buf, gate)) * _matmul(buf, up)
        return _matmul(h.to(dtype), down).to(dtype).reshape(-1, d)

    outs = each(expert, gates, ups, downs)

    # the combine, on each holder
    owners = [r for r in range(R) if outs[r] is not None]

    def combine(q, x_q, top_e_q, top_p_q):
        dev = lay.device(q)
        rt = routes[dev]
        gid = lay.token_ids(q, dev)
        perm = torch.argsort(top_e_q, dim=1, stable=True)
        p = rt["rank"][(gid[:, None] * k + perm)]  # (T_q, k): sorted positions
        se_p, slot_p, keep_p = rt["se"][p], rt["slot"][p], rt["keep"][p]
        rows, base = pool(outs, owners, dev)
        rank, at = owner(se_p, slot_p)
        back = torch.where(keep_p[..., None], rows[_lookup(rank, base) + at], zero(dev))
        if q == 0:
            back = coll.moved(back, "all-to-all",
                              back.numel() * back.element_size() * (R - 1) / R)
        w = torch.gather(top_p_q, 1, perm)
        vals = back * torch.where(keep_p, w, 0.0)[..., None].to(dtype)
        combined = torch.zeros((gid.shape[0], d), dtype=dtype, device=dev)
        for j in range(k):
            combined = combined + vals[:, j]
        return combined.reshape(x_q.shape)

    out = each(combine, xs, top_e, top_p)
    return out, aux
