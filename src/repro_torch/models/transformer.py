"""Decoder-only LM of the port — ``repro.models.transformer`` in PyTorch:
dense (llama-style) and MoE variants, GQA, RoPE, optional local/global
alternating attention with logit soft-capping (gemma2-style).

``LMModel`` is an ``nn.Module`` (``models.params.ParamModule``) holding the
reference's flat tree of *stacked* ``(L, …)`` leaves under the reference's
names; a layer reads ``leaf[i]``, a view.  It is built on ``meta``, so a full
configuration costs nothing until ``init_params`` or ``load_jax_params``
places it (the CUDA device unless ``device="cpu"``).  The model holds its
parameters, so the reference's ``f(params, …)`` methods take the rest of
their arguments alone: ``forward(tokens)``, ``prefill(tokens, chunk)``,
``decode_step(cache, token, pos)``, ``loss_fn(batch)``.

The reference's ``lax.scan`` over layers is a Python loop over the stacked
leaves (``unroll_layers`` is kept as a field only).  ``remat`` is the
reference's ``jax.checkpoint`` around each layer of ``forward``: while
autograd records, each layer runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, so the
backward keeps only the layers' inputs and recomputes one layer's
activations at a time (the full Llama-3.2-1B at 4,096 tokens a row would
otherwise keep ~6.5 GB of attention scores a layer).  The recompute runs
the same operators on the same inputs, so remat on and off give the same
loss and gradients bit for bit; with autograd off (serving, ``prefill``,
``decode_step``) nothing changes.  ``loss_fn`` is differentiable, and its
gradient is held to ``jax.value_and_grad`` of the reference's.  Serving
follows the reference step for step:

* ``prefill`` returns the last position's logits and the segment's KV cache
  ``(L, B, S, KV, Dh)`` under the keys ``"k"`` / ``"v"``; with ``chunk`` it
  grows the cache segment by segment (Sarathi-style), as the reference does.
* ``decode_step`` writes the new K/V (int8 values and float32 scales under
  ``"k_scale"`` / ``"v_scale"`` when the cache is int8) into the cache IN
  PLACE at slot ``pos`` and returns the same dict: the reference returns a
  new one.  ``pos`` is a host int, checked against the cache's length on
  the host, so a step reads nothing back from the card.

Over a mesh (the sharded step's ``"model"`` plan) ``split_loss`` and
``split_forward`` run the same function with each layer's compute split
over the mesh's ``"model"`` axis as the reference's specs lay it out (FSDP
over the data axes, tensor parallelism over "model"): column- and
row-parallel products, heads and vocabulary split, the residual stream
sequence-sharded under ``seq_shard_activations``, the MoE expert-parallel
(``layers.moe_block_split``), joined by ``parallel.collectives``.

Token ids index the embedding unchecked inside a pass (the reference's
gather clamps; torch raises on the CPU and asserts on the card): check them
with ``check_ids`` where they are made.  ``scale_embed`` multiplies by
``sqrt(d_model)`` rounded to the activations' dtype first, as JAX rounds a
weakly typed constant (torch would multiply in float32 and round once).
The unembedding and the float32 configs' products run in IEEE float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.common import TensorSpec
from repro_torch.core.distances import check_ieee_fp32
from repro_torch.models import layers
from repro_torch.models.params import ParamModule
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (
    P,
    divisible_or_none,
    dp_axes,
    fsdp_axes,
    maybe_constrain,
)

__all__ = ["LMConfig", "LMModel"]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    n_shared_experts: int = 0
    # gemma2-style features
    sliding_window: int | None = None
    local_global_alternate: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    scale_embed: bool = False
    post_norms: bool = False
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    remat: bool = True
    # distribution
    optimizer: str = "adamw"  # "adamw" | "adafactor"
    grad_accum_dtype: str = "float32"  # "bfloat16" halves accumulator HBM
    microbatches: int = 1
    seq_shard_activations: bool = False
    # FSDP execution mode of the reference's mesh (all-gather each layer's
    # weights at use, keeping their "model" split); the port's sharded step
    # always gathers a leaf over its data axes only
    unshard_weights_at_use: bool = False
    expert_axis: str | None = None  # mesh axis for MoE expert parallelism
    attn_q_chunk: int | None = None  # query chunking for long prefill
    # KV-cache precision for decode: "bf16" | "int8" (KIVI-style per-token
    # per-head scales; halves long-context cache HBM, scales factor out of
    # the attention contraction so the cache is never dequantised in full).
    kv_cache_dtype: str = "bf16"
    # the reference's straight-line layers for its dry-run cost probes
    unroll_layers: bool = False
    # mesh axes of the activations' batch dim; None = no mesh
    batch_axes: tuple | None = None

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    def n_params(self) -> int:
        d, dh = self.d_model, self.dh
        attn = d * self.n_heads * dh * 2 + d * self.n_kv_heads * dh * 2
        if self.is_moe:
            mlp = self.moe_experts * 3 * d * self.d_ff + d * self.moe_experts
            mlp += self.n_shared_experts * 3 * d * self.d_ff
        else:
            mlp = 3 * d * self.d_ff
        per_layer = attn + mlp + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: top-k + shared experts only)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        attn = d * self.n_heads * self.dh * 2 + d * self.n_kv_heads * self.dh * 2
        mlp = (self.moe_top_k + self.n_shared_experts) * 3 * d * self.d_ff
        mlp += d * self.moe_experts  # router
        per_layer = attn + mlp + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d


def _embed_scale(x: torch.Tensor, d_model: int) -> torch.Tensor:
    """``x * sqrt(d_model)`` with the constant rounded to ``x``'s dtype
    (made on ``x``'s device: no host tensor to wait for)."""
    return x * layers._const(math.sqrt(d_model), x)


def _unembed(x: torch.Tensor, unembed: torch.Tensor) -> torch.Tensor:
    """``x.astype(f32) @ unembed.T.astype(f32)`` in IEEE float32."""
    xf = x.float()
    check_ieee_fp32(xf)
    return xf @ unembed.float().T


# ---------------------------------------------------------------- model split

# the dim of each per-layer leaf (the stacked leaf's dim less one; the
# embeddings' own) that a spec may split over "model"
_MODEL_DIM = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "w_gate": 1, "w_up": 1, "w_down": 0,
              "shared_gate": 1, "shared_up": 1, "shared_down": 0, "moe_gate": 0,
              "moe_up": 0, "moe_down": 0, "embed": 0, "unembed": 0}
# leaves whose splits must agree: a product whose contraction runs over
# another leaf's split, and K and V, which share their slices
_PAIRS = (("wq", "wo"), ("wk", "wv"), ("w_gate", "w_down"), ("w_up", "w_down"),
          ("shared_gate", "shared_down"), ("shared_up", "shared_down"),
          ("moe_gate", "moe_up"), ("moe_gate", "moe_down"))


class _Split:
    """What each model shard of a ``split_loss`` computes, from the specs:
    ``cols(key, j)`` is the range of ``key``'s split dim that model shard
    ``j`` holds, or None where the spec leaves the leaf whole over
    ``"model"`` (the shard then runs that product whole)."""

    def __init__(self, model: "LMModel", lay: layers.SplitLayout, specs: dict):
        self.lay = lay
        self.m = lay.m
        shapes = model.param_shapes()
        self.size, self.split = {}, {}
        for key, spec in specs.items():
            axes = P(*spec).axes(len(shapes[key][0]))
            at = [i for i, ax in enumerate(axes) if "model" in ax]
            stacked = key not in ("embed", "unembed")
            want = _MODEL_DIM.get(key)
            if at and (want is None or at != [want + stacked] or axes[at[0]] != ("model",)):
                raise NotImplementedError(f"the model-split LM splits {key} over 'model' "
                                          f"only on dim {want}, not by {spec!r}")
            self.split[key] = bool(at) and self.m > 1
            if want is not None:
                self.size[key] = shapes[key][0][want + stacked]
        for a, b in _PAIRS:
            if a in self.split and self.split[a] != self.split[b]:
                raise NotImplementedError(f"{a} and {b} must be split over 'model' alike")

    def cols(self, key: str, j: int):
        return coll.piece_bounds(self.size[key], self.m, j) if self.split[key] else None

    def full_seq(self, xs: list) -> list:
        """The whole sequence on each model shard (an all-gather under
        ``seq``)."""
        return self.lay.over_model(coll.all_gather, xs, 1) if self.lay.seq else xs

    def settle(self, parts: list, partial: bool) -> list:
        """Products back into the residual stream's layout: partial sums
        (a row-parallel product) reduce-scattered over the sequence under
        ``seq``, else all-reduced; whole products sliced to the shard's
        sequence under ``seq``, else kept."""
        lay = self.lay
        if partial:
            fn = coll.reduce_scatter if lay.seq else coll.all_reduce
            return lay.over_model(fn, parts, 1) if lay.seq else lay.over_model(fn, parts)
        if not lay.seq:
            return parts
        return lay.each(lambda r, x: x[:, slice(*lay.seq_piece(r % self.m))], parts)


class LMModel(ParamModule):
    """The decoder over an ``LMConfig``; see the module note."""

    # ------------------------------------------------------------------ params

    def param_shapes(self) -> dict:
        c = self.cfg
        d, dh, L = c.d_model, c.dh, c.n_layers
        f32, dt = torch.float32, c.dtype
        sh = {
            "embed": ((c.vocab, d), dt),
            "unembed": ((c.vocab, d), dt),
            "final_norm": ((d,), f32),
            "attn_norm": ((L, d), f32),
            "mlp_norm": ((L, d), f32),
            "wq": ((L, d, c.n_heads * dh), dt),
            "wk": ((L, d, c.n_kv_heads * dh), dt),
            "wv": ((L, d, c.n_kv_heads * dh), dt),
            "wo": ((L, c.n_heads * dh, d), dt),
        }
        if c.post_norms:
            sh["attn_post_norm"] = ((L, d), f32)
            sh["mlp_post_norm"] = ((L, d), f32)
        if c.is_moe:
            sh["router"] = ((L, d, c.moe_experts), f32)
            sh["moe_gate"] = ((L, c.moe_experts, d, c.d_ff), dt)
            sh["moe_up"] = ((L, c.moe_experts, d, c.d_ff), dt)
            sh["moe_down"] = ((L, c.moe_experts, c.d_ff, d), dt)
            if c.n_shared_experts:
                fs = c.n_shared_experts * c.d_ff
                sh["shared_gate"] = ((L, d, fs), dt)
                sh["shared_up"] = ((L, d, fs), dt)
                sh["shared_down"] = ((L, fs, d), dt)
        else:
            sh["w_gate"] = ((L, d, c.d_ff), dt)
            sh["w_up"] = ((L, d, c.d_ff), dt)
            sh["w_down"] = ((L, c.d_ff, d), dt)
        return sh

    def _zero_init(self, name: str) -> bool:
        return "norm" in name

    def param_specs(self, mesh) -> dict:
        """FSDP over data axes (input dim) + TP over model axis (output dim):
        the reference's specs.  On a mesh without a "model" axis (where the
        reference's raise) what it would split is replicated."""
        c = self.cfg
        fs = fsdp_axes(mesh)
        m = mesh.size("model") if "model" in mesh.axis_names else 0
        d_ok = lambda dim: divisible_or_none(dim, mesh, fs)  # noqa: E731
        m_ok = lambda dim: ("model" if m and dim % m == 0 else None)  # noqa: E731
        dh = c.dh
        specs = {
            # the embedding is gathered, not multiplied: vocab-sharded only
            "embed": P(m_ok(c.vocab), None),
            "unembed": P(m_ok(c.vocab), d_ok(c.d_model)),
            "final_norm": P(None),
            "attn_norm": P(None, None),
            "mlp_norm": P(None, None),
            "wq": P(None, d_ok(c.d_model), m_ok(c.n_heads * dh)),
            "wk": P(None, d_ok(c.d_model), m_ok(c.n_kv_heads * dh)),
            "wv": P(None, d_ok(c.d_model), m_ok(c.n_kv_heads * dh)),
            "wo": P(None, m_ok(c.n_heads * dh), d_ok(c.d_model)),
        }
        if c.post_norms:
            specs["attn_post_norm"] = P(None, None)
            specs["mlp_post_norm"] = P(None, None)
        if c.is_moe:
            e_ax = m_ok(c.moe_experts)
            specs["router"] = P(None, d_ok(c.d_model), None)
            specs["moe_gate"] = P(None, e_ax, d_ok(c.d_model), None)
            specs["moe_up"] = P(None, e_ax, d_ok(c.d_model), None)
            specs["moe_down"] = P(None, e_ax, None, d_ok(c.d_model))
            if c.n_shared_experts:
                fs_dim = c.n_shared_experts * c.d_ff
                specs["shared_gate"] = P(None, d_ok(c.d_model), m_ok(fs_dim))
                specs["shared_up"] = P(None, d_ok(c.d_model), m_ok(fs_dim))
                specs["shared_down"] = P(None, m_ok(fs_dim), d_ok(c.d_model))
        else:
            specs["w_gate"] = P(None, d_ok(c.d_model), m_ok(c.d_ff))
            specs["w_up"] = P(None, d_ok(c.d_model), m_ok(c.d_ff))
            specs["w_down"] = P(None, m_ok(c.d_ff), d_ok(c.d_model))
        return specs

    # ------------------------------------------------------------------ layers

    def _layer_params(self) -> tuple[dict, list[str]]:
        """The stacked per-layer leaves ``(L, …)`` and their names."""
        keys = [k for k, (shape, _) in self.param_shapes().items()
                if len(shape) >= 2 and k not in ("embed", "unembed")]
        return {k: getattr(self, k) for k in keys}, keys

    def _layer(self, lp_all: dict, i: int) -> dict:
        return {k: v[i] for k, v in lp_all.items()}

    def _is_local_flags(self) -> list[bool]:
        c = self.cfg
        if c.local_global_alternate:
            return [i % 2 == 0 for i in range(c.n_layers)]  # even layers local
        return [False] * c.n_layers

    def _block(self, x, lp, is_local, q_pos, kv_pos, k_cache=None, v_cache=None,
               kv_valid=None, cache_slot=None, k_scale=None, v_scale=None):
        """One transformer layer.  Returns (x, new_k, new_v) — where new_k /
        new_v are (values, scales) tuples when the cache is int8-quantised.

        Train/prefill: caches are None — K/V come from this segment.
        Decode: k_cache/v_cache hold the past; new K/V are written at
        ``cache_slot`` IN PLACE (the caches returned are the ones given).
        """
        c = self.cfg
        b = x.shape[0]
        dh = c.dh
        x = self._constrain_resid(x)

        h = layers.rms_norm(x, lp["attn_norm"])
        q = layers._matmul(h, lp["wq"]).reshape(b, -1, c.n_heads, dh)
        k = layers._matmul(h, lp["wk"]).reshape(b, -1, c.n_kv_heads, dh)
        v = layers._matmul(h, lp["wv"]).reshape(b, -1, c.n_kv_heads, dh)
        q = layers.rope(q, q_pos, c.rope_theta)
        k = layers.rope(k, q_pos, c.rope_theta)

        quantized = k_cache is not None and k_cache.dtype == torch.int8
        if k_cache is not None:
            s = k.shape[1]
            sl = slice(cache_slot, cache_slot + s)
        if quantized:
            kq_new, ks_new = layers.quantize_kv(k)
            vq_new, vs_new = layers.quantize_kv(v)
            k_cache[:, sl] = kq_new
            k_scale[:, sl] = ks_new
            v_cache[:, sl] = vq_new
            v_scale[:, sl] = vs_new
            new_k, new_v = (k_cache, k_scale), (v_cache, v_scale)
            att_valid = kv_valid
        elif k_cache is not None:
            k_cache[:, sl] = k.to(k_cache.dtype)
            v_cache[:, sl] = v.to(v_cache.dtype)
            new_k, new_v = k_cache, v_cache
            att_k, att_v, att_valid = k_cache, v_cache, kv_valid
        else:
            new_k, new_v = k, v  # prefill: the segment IS the cache content
            att_k, att_v, att_valid = k, v, None

        if c.local_global_alternate and c.sliding_window:
            # local layers use the sliding window, global layers an
            # effectively-infinite one
            eff_window = c.sliding_window if is_local else 2**30
        else:
            eff_window = c.sliding_window
        if quantized:
            o = layers.gqa_attention_quantized(
                q, new_k[0], new_k[1], new_v[0], new_v[1],
                q_pos, kv_pos, att_valid,
                window=eff_window, attn_softcap=c.attn_softcap,
            )
        elif c.attn_q_chunk:
            o = layers.gqa_attention_qchunked(
                q, att_k, att_v, q_pos, kv_pos, att_valid,
                window=eff_window, attn_softcap=c.attn_softcap,
                chunk=c.attn_q_chunk,
            )
        else:
            o = layers.gqa_attention(
                q, att_k, att_v, q_pos, kv_pos, att_valid,
                window=eff_window, attn_softcap=c.attn_softcap,
            )
        o = layers._matmul(o.reshape(b, -1, c.n_heads * dh), lp["wo"])
        if c.post_norms:
            o = layers.rms_norm(o, lp["attn_post_norm"])
        x = x + o

        h = layers.rms_norm(x, lp["mlp_norm"])
        if c.is_moe:
            cap = self._capacity(h.shape[0] * h.shape[1])
            mo, _aux = layers.moe_block(
                h, lp["router"], lp["moe_gate"], lp["moe_up"], lp["moe_down"],
                layers.MoEDims(
                    c.moe_experts, c.moe_top_k, cap, c.expert_axis,
                    token_axes=c.batch_axes,
                ),
            )
            if c.n_shared_experts:
                mo = mo + layers.swiglu(
                    h, lp["shared_gate"], lp["shared_up"], lp["shared_down"]
                )
        else:
            mo = layers.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
        if c.post_norms:
            mo = layers.rms_norm(mo, lp["mlp_post_norm"])
        return x + mo, new_k, new_v

    def _capacity(self, n_tokens: int) -> int:
        c = self.cfg
        per = n_tokens * c.moe_top_k / c.moe_experts
        cap = int(math.ceil(per * c.moe_capacity_factor))
        cap = max(8, min(cap, n_tokens))
        if cap >= 64:
            cap = -(-cap // 64) * 64  # data-axis-shardable capacity dim
        return cap

    # ----------------------------------------------------------------- forward

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = self.embed[tokens.long()].to(c.dtype)
        if c.scale_embed:
            x = _embed_scale(x, c.d_model)
        return x

    def _positions(self, b: int, s: int, offset: int = 0) -> torch.Tensor:
        return (offset + torch.arange(s, dtype=torch.int32, device=self.embed.device)
                ).expand(b, s)

    def _constrain_resid(self, x: torch.Tensor) -> torch.Tensor:
        """The reference pins the residual stream's rows over ``batch_axes``
        (and its sequence over ``"model"`` with ``seq_shard_activations``);
        ``maybe_constrain`` checks the spec inside a sharded step."""
        c = self.cfg
        if c.batch_axes is None:
            return x
        seq = "model" if c.seq_shard_activations else None
        return maybe_constrain(x, P(tuple(c.batch_axes), seq, None))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits: tokens (B, S) -> (B, S, vocab)."""
        c = self.cfg
        b, s = tokens.shape
        x = self._embed(tokens)
        pos = self._positions(b, s)
        lp_all, _ = self._layer_params()
        remat = c.remat and torch.is_grad_enabled()
        for i, loc in enumerate(self._is_local_flags()):
            lp = self._layer(lp_all, i)
            if remat:
                x = checkpoint(self._train_block, x, lp, loc, pos, use_reentrant=False)
            else:
                x = self._train_block(x, lp, loc, pos)
        x = layers.rms_norm(x, self.final_norm)
        return layers.softcap(_unembed(x, self.unembed), c.final_softcap)

    def _train_block(self, x, lp, is_local, pos):
        """One layer of ``forward`` (the reference's scan body)."""
        return self._block(x, lp, is_local, pos, pos)[0]

    def prefill(self, tokens: torch.Tensor,
                chunk: int | None = None) -> tuple[torch.Tensor, dict]:
        """Prefill: run the full prompt, return (last-token logits (B, vocab),
        KV cache (L, B, S, KV, Dh)).  Only the final position's logits are
        computed — materialising (B, S, vocab) at 32K context is pure waste.

        ``chunk``: Sarathi-style chunked prefill — ``chunk``-token segments
        go through the whole stack in turn, growing the cache.  Bounds live
        activations (and the MoE dispatch buffer) to one segment.
        """
        c = self.cfg
        b, s = tokens.shape
        x = self._embed(tokens)
        lp_all, _ = self._layer_params()
        flags = self._is_local_flags()
        shape = (c.n_layers, b, s, c.n_kv_heads, self.dh_pad())
        dev = x.device

        if chunk and s > chunk and s % chunk == 0:
            kv_pos = self._positions(b, s)
            cache = {"k": torch.zeros(shape, dtype=c.dtype, device=dev),
                     "v": torch.zeros(shape, dtype=c.dtype, device=dev)}
            for offset in range(0, s, chunk):
                xc = x[:, offset:offset + chunk]
                q_pos = self._positions(b, chunk, offset)
                for i, loc in enumerate(flags):
                    xc, _, _ = self._block(
                        xc, self._layer(lp_all, i), loc, q_pos, kv_pos,
                        k_cache=cache["k"][i], v_cache=cache["v"][i], kv_valid=None,
                        cache_slot=offset,
                    )
            x_last = xc[:, -1:]
        else:
            pos = self._positions(b, s)
            cache = {"k": torch.empty(shape, dtype=c.dtype, device=dev),
                     "v": torch.empty(shape, dtype=c.dtype, device=dev)}
            for i, loc in enumerate(flags):
                x, k, v = self._block(x, self._layer(lp_all, i), loc, pos, pos)
                cache["k"][i] = k
                cache["v"][i] = v
            x_last = x[:, -1:]

        x_last = layers.rms_norm(x_last, self.final_norm)
        logits = _unembed(x_last[:, 0], self.unembed)
        return layers.softcap(logits, c.final_softcap), cache

    def dh_pad(self) -> int:
        return self.cfg.dh

    def loss_fn(self, batch: dict) -> torch.Tensor:
        """batch: tokens (B, S+1) int.  Mean next-token cross-entropy."""
        tokens = batch["tokens"]
        inp, tgt = tokens[:, :-1], tokens[:, 1:]
        logits = self.forward(inp)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tgt.long()[..., None])[..., 0]
        return torch.mean(logz - gold)

    # ------------------------------------------------------------- model split

    def split_loss(self, params: list, tokens: list, mesh, specs: dict,
                   probe: bool = False) -> torch.Tensor:
        """``loss_fn`` over a mesh, each model shard computing what its spec
        pieces hold (the reference's FSDP + TP plan as GSPMD splits it).

        ``params[r]``: mesh device r's tree, each leaf the piece it holds
        over ``"model"`` and whole over the data axes (``"model"`` the
        mesh's last axis, or none); ``tokens[s]``: data shard s's rows of
        the microbatch, (B_s, S + 1).  Column-parallel ``wq`` / ``wk`` /
        ``wv`` (heads kv-major, so a column block is a block of KV groups;
        a shard whose q heads read a KV head its block splits all-gathers
        K and V), ``w_gate`` / ``w_up`` / ``shared_*``; row-parallel ``wo``
        / ``w_down`` reduce-scattered over the sequence under
        ``seq_shard_activations`` (the residual stream, its norms, and the
        all-gather before each column-parallel product: sequence
        parallelism), all-reduced otherwise; the embedding and the
        unembedding split by vocabulary (a vocab-parallel cross-entropy:
        no shard forms the whole logits); the MoE expert-parallel
        (``layers.moe_block_split``).  A leaf its spec leaves whole over
        ``"model"`` runs whole on each shard.  ``remat`` checkpoints each
        layer, collectives included.  ``probe`` (meta tensors only: the dry
        run) computes mesh device 0's part alone and lets every device read
        it.  Returns ``sum_s (B_s / B) loss_s`` on the mesh's lead device,
        float32."""
        sp, xf, toks = self._split_trunk(params, tokens, mesh, specs, probe)
        per = self._split_ce(sp, params, xf, sp.lay.each(lambda r, t: t[:, 1:], toks))
        b_all = [t.shape[0] for t in tokens]
        lead, total, m = mesh.lead, sum(b_all), sp.m
        loss = None
        for s in (s for s in range(sp.lay.D) if b_all[s]):  # a shard may hold no rows
            w = torch.full((), b_all[s] / total, dtype=torch.float32, device=lead)
            part = torch.mean(per[s * m]).to(lead) * w
            loss = part if loss is None else loss + part
        return loss

    def split_forward(self, params: list, tokens: list, mesh, specs: dict) -> list:
        """``forward`` over a mesh (``split_loss``'s layout; ``tokens[s]``
        (B_s, S) here): each mesh device's logits (B_s, S, its vocabulary
        piece, or the whole where the unembedding is not split)."""
        sp, xf, _ = self._split_trunk(params, [F.pad(t, (0, 1)) for t in tokens], mesh, specs)
        return sp.lay.each(lambda r, x: self._split_logits(params[r], x), xf)

    def _split_trunk(self, params, tokens, mesh, specs, probe=False):
        """The embedding and the layers of ``split_loss``: its ``_Split``,
        each device's final-normed stream over the whole sequence, and each
        device's tokens (B_s, S + 1)."""
        c = self.cfg
        m = mesh.size("model") if "model" in mesh.axis_names else 1
        if "model" in mesh.axis_names and mesh.axis_names[-1] != "model":
            raise ValueError(f"the model axis must be the mesh's last, got {mesh.axis_names}")
        b_all = [t.shape[0] for t in tokens]
        starts = [sum(b_all[:s]) for s in range(len(tokens))]
        seq_len = tokens[0].shape[1] - 1
        lay = layers.SplitLayout(mesh, m, tuple((b0, b0 + n) for b0, n in zip(starts, b_all)),
                                 seq_len, bool(c.seq_shard_activations) and m > 1, probe)
        if lay.D != len(tokens):
            raise ValueError(f"{len(tokens)} row shards for {lay.D} data shards")
        sp = _Split(self, lay, specs)
        toks = lay.each(lambda r: tokens[r // m].to(lay.device(r)))
        xs = self._split_embed(sp, params, lay.each(lambda r, t: t[:, :-1], toks))
        pos = lay.each(lambda r, t: self._positions(t.shape[0], seq_len).to(t.device), toks)
        keys = self._layer_params()[1]
        remat = c.remat and torch.is_grad_enabled()
        for i, loc in enumerate(self._is_local_flags()):
            lps = lay.each(lambda r: {k: params[r][k][i] for k in keys})
            if remat:
                xs = checkpoint(self._split_block, sp, xs, lps, loc, pos, use_reentrant=False)
            else:
                xs = self._split_block(sp, xs, lps, loc, pos)
        xs = lay.each(lambda r, x: layers.rms_norm(x, params[r]["final_norm"]), xs)
        return sp, sp.full_seq(xs), toks

    def _split_logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return layers.softcap(_unembed(x, params["unembed"]), self.cfg.final_softcap)

    def _split_embed(self, sp: _Split, params: list, inp: list) -> list:
        c = self.cfg
        lay = sp.lay
        if sp.split["embed"]:
            def part(r, tok):
                v0, v1 = sp.cols("embed", r % sp.m)
                tok = tok.long()
                here = (tok >= v0) & (tok < v1)
                rows = params[r]["embed"][torch.clamp(tok - v0, 0, v1 - v0 - 1)].to(c.dtype)
                return torch.where(here[..., None], rows,
                                   torch.zeros((), dtype=c.dtype, device=rows.device))

            xs = sp.settle(lay.each(part, inp), partial=True)  # one nonzero term: exact
        else:
            def own(r, tok):
                lo, hi = lay.seq_piece(r % sp.m)
                return params[r]["embed"][tok[:, lo:hi].long()].to(c.dtype)

            xs = lay.each(own, inp)
        if c.scale_embed:
            xs = lay.each(lambda r, x: _embed_scale(x, c.d_model), xs)
        return xs

    def _split_block(self, sp: _Split, xs: list, lps: list, is_local, pos: list) -> list:
        """One layer of ``split_loss`` (``_block``'s train path)."""
        c = self.cfg
        each = sp.lay.each
        hs = each(lambda r, x, lp: layers.rms_norm(x, lp["attn_norm"]), xs, lps)
        o = self._split_attention(sp, sp.full_seq(hs), lps, is_local, pos)
        o = sp.settle(o, partial=sp.split["wo"])
        if c.post_norms:
            o = each(lambda r, y, lp: layers.rms_norm(y, lp["attn_post_norm"]), o, lps)
        xs = each(lambda r, x, y: x + y, xs, o)
        hs = each(lambda r, x, lp: layers.rms_norm(x, lp["mlp_norm"]), xs, lps)
        if c.is_moe:
            t = sum(b1 - b0 for b0, b1 in sp.lay.rows) * sp.lay.seq_len
            mo, _aux = layers.moe_block_split(
                hs, *[[lp[k] for lp in lps] for k in ("router", "moe_gate", "moe_up",
                                                       "moe_down")],
                layers.MoEDims(c.moe_experts, c.moe_top_k, self._capacity(t), c.expert_axis,
                               token_axes=c.batch_axes),
                sp.lay, sp.split["moe_gate"])
            if c.n_shared_experts:
                sh = each(lambda r, h, lp: layers.swiglu(h, lp["shared_gate"], lp["shared_up"],
                                                         lp["shared_down"]),
                          sp.full_seq(hs), lps)
                mo = each(lambda r, a, b: a + b, mo, sp.settle(sh, sp.split["shared_down"]))
        else:
            mo = each(lambda r, h, lp: layers.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]),
                      sp.full_seq(hs), lps)
            mo = sp.settle(mo, partial=sp.split["w_down"])
        if c.post_norms:
            mo = each(lambda r, y, lp: layers.rms_norm(y, lp["mlp_post_norm"]), mo, lps)
        return each(lambda r, x, y: x + y, xs, mo)

    def _split_attention(self, sp: _Split, hf: list, lps: list, is_local, pos: list) -> list:
        """Each model shard's heads, whole sequence: its part of ``wo``'s
        product (a partial sum where ``wo`` is split)."""
        c = self.cfg
        dh, g = c.dh, c.n_heads // c.n_kv_heads
        lay = sp.lay
        m = sp.m
        each = lay.each
        q = each(lambda r, h, lp: layers._matmul(h, lp["wq"]), hf, lps)
        k = each(lambda r, h, lp: layers._matmul(h, lp["wk"]), hf, lps)
        v = each(lambda r, h, lp: layers._matmul(h, lp["wv"]), hf, lps)
        qcols = [sp.cols("wq", j) or (0, c.n_heads * dh) for j in range(m)]
        heads = [(lo // dh, -(-hi // dh)) for lo, hi in qcols]
        if any(lo % dh or hi % dh for lo, hi in qcols):
            # a q block that splits a head: every shard takes whole heads
            q = each(lambda r, x: x[..., heads[r % m][0] * dh:heads[r % m][1] * dh],
                     lay.over_model(coll.all_gather, q, -1))
        kv = [(h0 // g, -(-h1 // g)) for h0, h1 in heads]
        kcols = [sp.cols("wk", j) or (0, c.n_kv_heads * dh) for j in range(m)]
        off = [lo for lo, _ in kcols]
        if any(k0 * dh < lo or k1 * dh > hi for (k0, k1), (lo, hi) in zip(kv, kcols)):
            # a q head reads a KV head another shard's block holds (or
            # splits): every shard gathers K and V whole
            k = lay.over_model(coll.all_gather, k, -1)
            v = lay.over_model(coll.all_gather, v, -1)
            off = [0] * m
        if c.local_global_alternate and c.sliding_window:
            window = c.sliding_window if is_local else 2**30
        else:
            window = c.sliding_window

        def attend(r, qr, kr, vr, p, lp):
            j = r % m
            (h0, h1), (k0, k1), (b, t) = heads[j], kv[j], qr.shape[:2]
            qr = qr.reshape(b, t, h1 - h0, dh)
            kr = kr[..., k0 * dh - off[j]:k1 * dh - off[j]].reshape(b, t, k1 - k0, dh)
            vr = vr[..., k0 * dh - off[j]:k1 * dh - off[j]].reshape(b, t, k1 - k0, dh)
            if not (h0 % g == 0 and h1 % g == 0) and k1 - k0 > 1:
                # q heads that straddle KV groups: one KV head per q head
                which = torch.arange(h0, h1, device=kr.device) // g - k0
                kr, vr = kr[:, :, which], vr[:, :, which]
            qr = layers.rope(qr, p, c.rope_theta)
            kr = layers.rope(kr, p, c.rope_theta)
            if c.attn_q_chunk:
                o = layers.gqa_attention_qchunked(qr, kr, vr, p, p, None, window=window,
                                                  attn_softcap=c.attn_softcap,
                                                  chunk=c.attn_q_chunk)
            else:
                o = layers.gqa_attention(qr, kr, vr, p, p, None, window=window,
                                         attn_softcap=c.attn_softcap)
            o = o.reshape(b, t, (h1 - h0) * dh)
            lo, hi = qcols[j]
            return layers._matmul(o[..., lo - h0 * dh:hi - h0 * dh], lp["wo"])

        return each(attend, q, k, v, pos, lps)

    def _split_ce(self, sp: _Split, params: list, xf: list, tgt: list) -> list:
        """Each rank's per-token cross-entropy (B_s, S), the whole on each
        model shard: vocab-parallel where the unembedding is split (the row
        max and the sum of exponentials all-reduced in float32, the
        target's logit from the shard that holds it)."""
        c = self.cfg
        lay = sp.lay
        each = lay.each
        logits = each(lambda r, x: self._split_logits(params[r], x), xf)
        if not sp.split["unembed"]:
            return each(lambda r, lg, t: torch.logsumexp(lg, dim=-1)
                        - torch.gather(lg, -1, t.long()[..., None])[..., 0], logits, tgt)
        top = lay.over_model(coll.all_reduce_max,
                             each(lambda r, lg: lg.amax(dim=-1, keepdim=True), logits))
        z = lay.over_model(coll.all_reduce,
                           each(lambda r, lg, t: torch.sum(torch.exp(lg - t), dim=-1),
                                logits, top))

        def gold(r, lg, t):
            v0, v1 = sp.cols("unembed", r % sp.m)
            t = t.long()
            here = (t >= v0) & (t < v1)
            got = torch.gather(lg, -1, torch.clamp(t - v0, 0, v1 - v0 - 1)[..., None])[..., 0]
            return torch.where(here, got, torch.zeros((), device=lg.device))

        gg = lay.over_model(coll.all_reduce, each(gold, logits, tgt))
        return each(lambda r, t, zz, g_: t[..., 0] + torch.log(zz) - g_, top, z, gg)

    # ------------------------------------------------------------------ decode

    def init_cache_shapes(self, batch: int, max_seq: int) -> dict:
        c = self.cfg
        shape = (c.n_layers, batch, max_seq, c.n_kv_heads, c.dh)
        if c.kv_cache_dtype == "int8":
            sshape = (c.n_layers, batch, max_seq, c.n_kv_heads)
            return {
                "k": TensorSpec(shape, torch.int8),
                "v": TensorSpec(shape, torch.int8),
                "k_scale": TensorSpec(sshape, torch.float32),
                "v_scale": TensorSpec(sshape, torch.float32),
            }
        return {
            "k": TensorSpec(shape, c.dtype),
            "v": TensorSpec(shape, c.dtype),
        }

    def cache_specs(self, mesh, batch: int) -> dict:
        """The reference's KV-cache specs: batch over the data axes when they
        divide it, the sequence over ``"model"``."""
        dp = dp_axes(mesh)
        dp_size = 1
        for a in dp:
            dp_size *= mesh.size(a)
        bdim = dp if batch % dp_size == 0 else None  # batch=1: replicate
        spec = P(None, bdim, "model", None, None)  # seq-sharded KV
        out = {"k": spec, "v": spec}
        if self.cfg.kv_cache_dtype == "int8":
            out["k_scale"] = P(None, bdim, "model", None)
            out["v_scale"] = P(None, bdim, "model", None)
        return out

    def decode_step(self, cache: dict, token: torch.Tensor,
                    pos: int) -> tuple[torch.Tensor, dict]:
        """One-token decode: token (B, 1) int, ``pos`` a host int (the
        current length).  Writes the new K/V into ``cache`` in place and
        returns (logits (B, vocab), cache)."""
        c = self.cfg
        b = token.shape[0]
        max_seq = cache["k"].shape[2]
        pos = int(pos)
        if not 0 <= pos < max_seq:
            raise ValueError(f"pos must lie in [0, {max_seq}); got {pos}")
        x = self._embed(token)
        q_pos = self._positions(b, 1, pos)
        kv_pos = self._positions(b, max_seq)
        kv_valid = kv_pos <= pos  # includes the slot being written
        lp_all, _ = self._layer_params()
        quantized = cache["k"].dtype == torch.int8
        for i, loc in enumerate(self._is_local_flags()):
            scales = ((cache["k_scale"][i], cache["v_scale"][i]) if quantized
                      else (None, None))
            x, _, _ = self._block(
                x, self._layer(lp_all, i), loc, q_pos, kv_pos,
                k_cache=cache["k"][i], v_cache=cache["v"][i], kv_valid=kv_valid,
                cache_slot=pos, k_scale=scales[0], v_scale=scales[1],
            )
        x = layers.rms_norm(x, self.final_norm)
        logits = layers.softcap(_unembed(x[:, 0], self.unembed), c.final_softcap)
        return logits, cache
