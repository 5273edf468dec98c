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
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.common import TensorSpec
from repro_torch.core.distances import check_ieee_fp32
from repro_torch.models import layers
from repro_torch.models.params import ParamModule
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
    # weights at use); the port's sharded step gathers a leaf whole
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
    """``x * sqrt(d_model)`` with the constant rounded to ``x``'s dtype."""
    return x * torch.tensor(math.sqrt(d_model), dtype=x.dtype)


def _unembed(x: torch.Tensor, unembed: torch.Tensor) -> torch.Tensor:
    """``x.astype(f32) @ unembed.T.astype(f32)`` in IEEE float32."""
    xf = x.float()
    check_ieee_fp32(xf)
    return xf @ unembed.float().T


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
