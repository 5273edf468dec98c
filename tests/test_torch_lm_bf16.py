"""The port's decoder in bfloat16 against the JAX package's, on the CPU: the
five reduced LM configs with ``dtype=bfloat16`` (the reduced Gemma covers
``scale_embed``, the softcaps, the window and the post-norms).

The port holds JAX's own bf16 parameters, carried by their 16-bit pattern.
Both packages round every op to bf16, each summing a product in its own
order, so logits agree within 2e-2 of the largest |logit| (the reference's
own prefill bound, ``tests/test_arch_smoke.py``) and losses within 2e-2
relative.  JAX runs with jit disabled, op by op as the port runs: XLA's
fused layer scan keeps some bf16 intermediates in float32 and moved one
MoE token's logits by 0.35 against JAX's own op-by-op evaluation at the
reduced Phi config (a CPU check), which no port of the ops can follow.

A MoE routes by a top-k over router probabilities computed from bf16
activations: where two experts' probabilities lie closer than the last
bit of an activation moves them, the packages may pick different experts
and the token's output jumps.  So both packages' routers are recorded; a
call (a forward, a prefill, a decode step) in which they route every token
alike is held to 2e-2, and one in which they do not must show only near
ties (``NEAR_TIE``) and is counted.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_lm_common import LM_ARCHS, decode_both, jax_params, pair, to_np, tokens

REL = 2e-2
# a routing difference is allowed where JAX's kth and (k+1)th router
# probabilities of the token lie this close (the one seen: 0.0007)
NEAR_TIE = 5e-3


@pytest.fixture
def routing(monkeypatch):
    """Records each package's router probabilities per ``moe_block`` call."""
    import repro.models.layers as JL
    import repro_torch.models.layers as TL

    rec = {"jax": [], "port": []}
    jax_moe, port_moe = JL.moe_block, TL.moe_block

    def jax_wrap(x, router, *rest):
        logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ router.astype(jnp.float32)
        rec["jax"].append(np.asarray(jax.nn.softmax(logits, axis=-1)))
        return jax_moe(x, router, *rest)

    def port_wrap(x, router, *rest):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ router.float(), dim=-1)
        rec["port"].append(probs.detach().numpy())
        return port_moe(x, router, *rest)

    monkeypatch.setattr(JL, "moe_block", jax_wrap)
    monkeypatch.setattr(TL, "moe_block", port_wrap)
    return rec


def _flips(rec: dict, start: int, k: int, stop: int | None = None) -> list:
    """Tokens routed to different experts by the two packages in the MoE
    calls recorded in [start, stop); raises unless each is a near tie."""
    out = []
    for pj, pt in zip(rec["jax"][start:stop], rec["port"][start:stop]):
        top_j = np.argsort(-pj, axis=1, kind="stable")[:, :k]
        top_t = np.argsort(-pt, axis=1, kind="stable")[:, :k]
        for tok in range(len(pj)):
            if set(top_j[tok]) != set(top_t[tok]):
                srt = np.sort(pj[tok])[::-1]
                assert srt[k - 1] - srt[k] <= NEAR_TIE, (tok, pj[tok], pt[tok])
                out.append(tok)
    return out


def _held(rec: dict, start: int, k: int, got, want, stop: int | None = None) -> bool:
    """``got`` within 2e-2 of ``want`` unless the call (its MoE calls
    recorded in [start, stop)) routed a near tie apart; returns whether it
    was held."""
    if _flips(rec, start, k, stop):
        return False
    _close(got, want)
    return True


def _close(got, want, rel: float = REL) -> None:
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape
    err, scale = np.abs(g - w).max(), np.abs(w).max()
    assert err <= rel * scale, (err, scale)


def test_bf16_parameters_cross_bit_for_bit():
    _, _, host = jax_params("gemma2-9b", "bf16")
    _, _, tm = pair("gemma2-9b", "bf16")
    for name in ("embed", "wq", "attn_norm"):
        got = getattr(tm, name).detach()
        assert got.dtype == (torch.float32 if "norm" in name else torch.bfloat16)
        want = host[name]
        bits = (np.int16, torch.int16) if got.dtype == torch.bfloat16 else (np.int32, torch.int32)
        np.testing.assert_array_equal(got.view(bits[1]).numpy(), want.view(bits[0]))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_bf16_forward_prefill_and_loss_match_jax(arch, routing):
    jm, params, tm = pair(arch, "bf16")
    k = tm.cfg.moe_top_k
    toks = tokens(tm.cfg.vocab, 1)
    batch = tokens(tm.cfg.vocab, 2, s=33)
    held = []
    with torch.no_grad(), jax.disable_jit():
        start = len(routing["jax"])
        want = jm.forward(params, jnp.asarray(toks))
        held.append(_held(routing, start, k, tm.forward(torch.as_tensor(toks)), want))
        for chunk in (None, 4):
            start = len(routing["jax"])
            jl, jc = jm.prefill(params, jnp.asarray(toks), chunk=chunk)
            logits, cache = tm.prefill(torch.as_tensor(toks), chunk=chunk)
            assert logits.dtype == torch.float32 and cache["k"].dtype == torch.bfloat16
            held.append(_held(routing, start, k, logits, jl))
            for key in ("k", "v"):  # K/V precede a layer's routing
                _close(cache[key], jc[key])
        start = len(routing["jax"])
        want = float(jm.loss_fn(params, {"tokens": jnp.asarray(batch)}))
        loss = tm.loss_fn({"tokens": torch.as_tensor(batch)})
        if not _flips(routing, start, k):
            assert abs(float(loss) - want) <= REL * abs(want)
    assert held == [True] * 3 if not tm.cfg.is_moe else sum(held) >= 2, held


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_bf16_decode_matches_jax(arch, kv, routing):
    """Eight decode steps with a bf16 and an int8 cache.  A bf16 K/V value
    one bit off (2^-8 relative), in itself or in its row's absmax, moves its
    quantised value by at most 127 * 2 * 2^-8 ~ 1 before rounding: 2 steps
    after.  A MoE step that routed a near tie apart is not held."""
    jm, params, tm = pair(arch, "bf16", kv_cache_dtype=kv)
    k = tm.cfg.moe_top_k
    toks = tokens(tm.cfg.vocab, 4, s=8)
    with jax.disable_jit():
        jl, tl, jc, tc = decode_both(jm, params, tm, toks, 12)
    n = tm.cfg.n_layers  # MoE calls a step (none for a dense config)
    held = [_held(routing, i * n, k, b, a, (i + 1) * n) for i, (a, b) in enumerate(zip(jl, tl))]
    assert all(held) if not tm.cfg.is_moe else sum(held) >= 6, held
    for key in tc:
        if tc[key].dtype == torch.int8:
            diff = np.abs(tc[key].numpy().astype(np.int32) - np.asarray(jc[key]))
            assert diff.max() <= 2, diff.max()
            _close(tc[key].float() * tc[key + "_scale"][..., None],
                   np.asarray(jc[key]).astype(np.float32) * to_np(jc[key + "_scale"])[..., None])
        else:
            _close(tc[key], jc[key])


def test_bf16_scale_embed_rounds_the_constant_first():
    """Gemma multiplies the bf16 embedding by sqrt(d_model) rounded to bf16
    first, as JAX rounds a weakly typed constant: [1, 3, 7] * sqrt(3584)
    is [59.75, 179, 418] there, [59.75, 180, 420] in one float32 product."""
    from repro_torch.models.transformer import _embed_scale

    x = torch.tensor([1.0, 3.0, 7.0], dtype=torch.bfloat16)
    got = _embed_scale(x, 3584)
    want = jnp.asarray([1.0, 3.0, 7.0], jnp.bfloat16) * np.sqrt(3584.0).item()
    np.testing.assert_array_equal(got.float().numpy(), to_np(want))
    np.testing.assert_array_equal(got.float().numpy(), [59.75, 179.0, 418.0])
