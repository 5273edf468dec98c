"""The port's decoder (``repro_torch.models.transformer``) against the JAX
package's, on the CPU, at the five reduced LM configs in float32.

The port holds JAX's own parameters (``init_params(PRNGKey(0))`` through
``load_jax_params``) and takes the same seed-made tokens.  Both run IEEE
float32 and sum in another order, so logits, losses and cache values agree
within 1e-5; the int8 cache values agree bit for bit.  The prefill / decode
tests also hold the port to itself: prefill's logits are ``forward``'s last
position's, and decoding after a prefill gives ``forward``'s logits over
the grown sequence.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_lm_common import LM_ARCHS, decode_both, pair, to_np, tokens

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_loss_match_jax(arch):
    jm, params, tm = pair(arch)
    toks = tokens(tm.cfg.vocab, 1)
    with torch.no_grad():
        got = tm.forward(torch.as_tensor(toks))
        assert got.shape == (2, 16, tm.cfg.vocab) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), to_np(jm.forward(params, jnp.asarray(toks))),
                                   **TOL)
        batch = tokens(tm.cfg.vocab, 2, s=33)
        loss = tm.loss_fn({"tokens": torch.as_tensor(batch)})
    assert loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jm.loss_fn(params, {"tokens": batch})),
                               **TOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("chunk", [None, 4])
def test_prefill_matches_jax(arch, chunk):
    """Prefill, plain and chunked (four 4-token segments), against JAX's:
    last-position logits and the (L, B, S, KV, Dh) cache.  A MoE's chunked
    prefill sizes each segment's expert capacity from the segment, so only
    the plain one is ``forward``'s last position there."""
    jm, params, tm = pair(arch)
    toks = tokens(tm.cfg.vocab, 3)
    with torch.no_grad():
        logits, cache = tm.prefill(torch.as_tensor(toks), chunk=chunk)
        full = tm.forward(torch.as_tensor(toks))
    jl, jc = jm.prefill(params, jnp.asarray(toks), chunk=chunk)
    np.testing.assert_allclose(logits.numpy(), to_np(jl), **TOL)
    assert sorted(cache) == sorted(jc) == ["k", "v"]
    for key in cache:
        assert tuple(cache[key].shape) == jc[key].shape
        np.testing.assert_allclose(cache[key].numpy(), to_np(jc[key]), **TOL)
    if not (chunk and tm.cfg.is_moe):
        np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), **TOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_steps_match_jax(arch, kv):
    """Eight decode steps from an empty cache of 12 slots: logits at every
    step; the caches (int8 values bit for bit, their scales within 1e-5)."""
    jm, params, tm = pair(arch, kv_cache_dtype=kv)
    toks = tokens(tm.cfg.vocab, 4, s=8)
    jl, tl, jc, tc = decode_both(jm, params, tm, toks, 12)
    for a, b in zip(jl, tl):
        assert b.shape == (2, tm.cfg.vocab)
        np.testing.assert_allclose(b.numpy(), to_np(a), **TOL)
    assert sorted(tc) == sorted(jc)
    for key in tc:
        if tc[key].dtype == torch.int8:
            np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
        else:
            np.testing.assert_allclose(tc[key].numpy(), to_np(jc[key]), **TOL)


@pytest.mark.parametrize("arch", ["gemma2-9b", "phi3.5-moe-42b-a6.6b", "llama3.2-1b"])
def test_decode_after_prefill_is_forward(arch):
    """Prefill 12 tokens, copy the cache into 16 slots, decode 4 more: each
    step's logits are ``forward``'s last position over the grown sequence
    (Gemma's window of 8 is passed).  The MoE's capacity factor is raised
    so that no pair is dropped: capacity follows the call's token count."""
    _, _, tm = pair(arch, moe_capacity_factor=100.0)
    toks = torch.as_tensor(tokens(tm.cfg.vocab, 5, s=16))
    with torch.no_grad():
        logits, pcache = tm.prefill(toks[:, :12])
        cache = {k: torch.zeros(s.shape, dtype=s.dtype)
                 for k, s in tm.init_cache_shapes(2, 16).items()}
        for key in cache:
            cache[key][:, :, :12] = pcache[key]
        np.testing.assert_allclose(logits.numpy(), tm.forward(toks[:, :12])[:, -1].numpy(),
                                   **TOL)
        for pos in range(12, 16):
            got, cache = tm.decode_step(cache, toks[:, pos:pos + 1], pos)
            want = tm.forward(toks[:, :pos + 1])[:, -1]
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_decode_step_refuses_a_position_past_the_cache():
    _, _, tm = pair("llama3.2-1b")
    cache = {k: torch.zeros(s.shape, dtype=s.dtype)
             for k, s in tm.init_cache_shapes(1, 4).items()}
    for pos in (-1, 4):
        with pytest.raises(ValueError, match=r"\[0, 4\)"):
            tm.decode_step(cache, torch.zeros((1, 1), dtype=torch.int32), pos)


def test_attn_q_chunk_matches_jax():
    """``attn_q_chunk`` routes prefill's attention through query chunks."""
    jm, params, tm = pair("gemma2-9b", attn_q_chunk=4)
    toks = tokens(tm.cfg.vocab, 6)
    with torch.no_grad():
        logits, _ = tm.prefill(torch.as_tensor(toks))
    np.testing.assert_allclose(logits.numpy(), to_np(jm.prefill(params, jnp.asarray(toks))[0]),
                               **TOL)


def test_moe_capacity_matches_jax():
    jm, _, tm = pair("kimi-k2-1t-a32b")
    for n in (1, 7, 16, 33, 100, 4096, 70_000):
        assert tm._capacity(n) == jm._capacity(n)
    full = dataclasses.replace(tm.cfg, moe_experts=384, moe_top_k=8)
    assert type(tm)(full)._capacity(2048) == type(jm)(
        dataclasses.replace(jm.cfg, moe_experts=384, moe_top_k=8))._capacity(2048)
