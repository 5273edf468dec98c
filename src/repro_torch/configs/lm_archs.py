"""The five assigned LM architectures — exact configs from the assignment,
the port of ``repro.configs.lm_archs``.

    phi3.5-moe-42b-a6.6b  [moe]   32L d4096 32H (GQA kv=8) dff6400 v32064, 16e top-2
                          [hf:microsoft/Phi-3.5-MoE-instruct]
    kimi-k2-1t-a32b       [moe]   61L d7168 64H (GQA kv=8) dff2048 v163840, 384e top-8
                          [arXiv:2501.kimi2] (+1 shared expert; head_dim 128
                          chosen for MXU alignment — assignment leaves it open)
    gemma2-9b             [dense] 42L d3584 16H (GQA kv=8) dff14336 v256000
                          local(4096)+global alternating, softcaps [arXiv:2408.00118]
    deepseek-coder-33b    [dense] 62L d7168 56H (GQA kv=8) dff19200 v32256
                          llama-arch [arXiv:2401.14196]
    llama3.2-1b           [dense] 16L d2048 32H (GQA kv=8) dff8192 v128256
                          [hf:meta-llama/Llama-3.2-1B]

Optimizer note: kimi-k2 (1T params) uses Adafactor — AdamW fp32 states are
20 bytes/param = 20 TB; Adafactor's factored second moment is the PaLM/T5
precedent.  The reduced configs (2 layers, d_model 32, vocab 211, float32)
are the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.configs import common
from repro_torch.models.transformer import LMConfig, LMModel


def _bundle(cfg: LMConfig, *, pure_full_attention: bool, reduced_kw: dict):
    model = LMModel(cfg)
    reduced_defaults = dict(
        name=cfg.name + "-smoke", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=211, dtype=torch.float32, remat=False,
    )
    reduced_defaults.update(reduced_kw)
    return common.ArchBundle(
        name=cfg.name,
        family="lm",
        cfg=cfg,
        model=model,
        cells=common.lm_cells(cfg, model, pure_full_attention=pure_full_attention),
        make_reduced=common.lm_reduced(LMConfig, LMModel, **reduced_defaults),
    )


PHI35_MOE = LMConfig(
    name="phi3.5-moe-42b-a6.6b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab=32064, moe_experts=16, moe_top_k=2,
    optimizer="adamw", microbatches=4, expert_axis="model",
    seq_shard_activations=True,
)

KIMI_K2 = LMConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163840, head_dim=128, moe_experts=384, moe_top_k=8,
    n_shared_experts=1,
    optimizer="adafactor", microbatches=8, expert_axis="model",
    seq_shard_activations=True, grad_accum_dtype="bfloat16",
)

GEMMA2_9B = LMConfig(
    name="gemma2-9b",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_ff=14336,
    vocab=256000, head_dim=256,
    sliding_window=4096, local_global_alternate=True,
    attn_softcap=50.0, final_softcap=30.0, post_norms=True, scale_embed=True,
    optimizer="adamw", microbatches=4, seq_shard_activations=True,
    kv_cache_dtype="int8",
)

DEEPSEEK_CODER_33B = LMConfig(
    name="deepseek-coder-33b",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19200,
    vocab=32256,
    optimizer="adamw", microbatches=4, seq_shard_activations=True,
)

LLAMA32_1B = LMConfig(
    name="llama3.2-1b",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab=128256,
    optimizer="adamw", microbatches=1, seq_shard_activations=True,
)


def bundles() -> dict:
    return {
        "phi3.5-moe-42b-a6.6b": _bundle(
            PHI35_MOE, pure_full_attention=True,
            reduced_kw=dict(moe_experts=4, moe_top_k=2, expert_axis=None),
        ),
        "kimi-k2-1t-a32b": _bundle(
            KIMI_K2, pure_full_attention=True,
            reduced_kw=dict(moe_experts=4, moe_top_k=2, n_shared_experts=1,
                            optimizer="adafactor", expert_axis=None,
                            seq_shard_activations=False),
        ),
        "gemma2-9b": _bundle(
            GEMMA2_9B, pure_full_attention=False,
            reduced_kw=dict(sliding_window=8, local_global_alternate=True,
                            attn_softcap=50.0, final_softcap=30.0,
                            post_norms=True, scale_embed=True),
        ),
        "deepseek-coder-33b": _bundle(
            DEEPSEEK_CODER_33B, pure_full_attention=True, reduced_kw={}
        ),
        "llama3.2-1b": _bundle(
            LLAMA32_1B, pure_full_attention=True, reduced_kw={}
        ),
    }
