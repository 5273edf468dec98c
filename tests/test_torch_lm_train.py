"""The LM family's training path of the port against the JAX package's, on
the CPU: the loss and its gradient, remat, the MoE backward with drops.

Each reduced LM config (float32) holds JAX's own parameters
(``load_jax_params``) and takes the same ``TokenStream`` batch.  Both run
IEEE float32 and sum in another order, so:

  * the loss within 1e-5 relative of ``jax.value_and_grad``'s (PR 23's
    bound for a loss);
  * every gradient leaf within 1e-4 of that leaf's largest |gradient| in
    JAX (read: up to 2.4e-6).  A gradient is a sum over every position
    through two layers of float32 products and softmaxes, each off by a
    few ulps between the packages; 1e-4 is the float32 card-against-CPU
    bound the logits are held to (PERF.md §2), and a relu or a top-k that
    a rounding flips would move one element by its whole size.

Remat recomputes the same operators on the same inputs: on and off give
the same loss and gradients bit for bit.  The train steps themselves
(5 steps, 1 and 2 microbatches): ``tests/test_torch_lm_steps.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_lm_common import LM_ARCHS, pair

from repro.data.pipeline import TokenStream as JTokenStream
from repro.models import layers as jlayers
from repro_torch.data.pipeline import TokenStream
from repro_torch.models import layers
from repro_torch.pytree import leaves
from repro_torch.train.step import functional_loss, make_train_step, to_device

LOSS_REL = 1e-5
GRAD_REL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the suite runs several workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(vocab: int, b: int = 2, s: int = 16, seed: int = 0) -> dict:
    """A ``TokenStream`` batch (B, S+1), the same numbers in both packages."""
    got = TokenStream(vocab=vocab, batch=b, seq=s, seed=seed).next()
    want = JTokenStream(vocab=vocab, batch=b, seq=s, seed=seed).next()
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    return got


def _port_grads(tm, batch: dict):
    step = make_train_step(functional_loss(tm, tm.loss_fn), optimizer=None)
    return step.grads(tm.param_tree(), to_device(batch, "cpu"))


def _check(loss, grads, jloss, jgrads) -> float:
    """Holds the port's (loss, grads) to JAX's; returns the largest gradient
    error over its leaf's largest |gradient|."""
    want = float(jloss)
    assert abs(float(loss) - want) <= LOSS_REL * abs(want), (float(loss), want)
    worst = 0.0
    got_l, want_l = leaves(grads), jax.tree.leaves(jgrads)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape and bool(torch.isfinite(g).all())
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.float().numpy() - w).max()) / scale
        assert err <= GRAD_REL, err
        worst = max(worst, err)
    return worst


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_grads_match_jax(arch):
    """Every reduced LM config (Gemma's softcaps and its local / global
    window over 16 positions past its window of 8, the MoEs' dispatch, Kimi's
    shared expert): the loss and every gradient leaf against
    ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    jm, params, tm = pair(arch)
    batch = _batch(tm.cfg.vocab)
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(params, {"tokens": jnp.asarray(batch["tokens"])})
    loss, grads = _port_grads(tm, batch)
    _check(loss, grads, jloss, jgrads)


def test_gemma_softcaps_and_window_under_autograd():
    """Gemma 2 over 40 positions (five windows of 8): the local layer masks
    past the window, both softcaps are on, the gradient matches JAX's, and
    a softcap-free copy gives another gradient (the caps are on the path)."""
    jm, params, tm = pair("gemma2-9b")
    cfg = tm.cfg
    assert cfg.attn_softcap and cfg.final_softcap and cfg.local_global_alternate
    batch = _batch(cfg.vocab, s=40, seed=3)
    assert batch["tokens"].shape[1] - 1 > 4 * cfg.sliding_window
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(params, {"tokens": jnp.asarray(batch["tokens"])})
    loss, grads = _port_grads(tm, batch)
    _check(loss, grads, jloss, jgrads)
    _, _, plain = pair("gemma2-9b", attn_softcap=None, final_softcap=None)
    loss2, _ = _port_grads(plain, batch)
    assert float(loss2) != float(loss)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_remat_on_equals_off_bit_for_bit(arch):
    """``remat=True`` (each layer under ``torch.utils.checkpoint``) and
    ``remat=False`` give the same loss and gradients bit for bit, and remat
    leaves a no-grad forward alone."""
    _, _, off = pair(arch, remat=False)
    _, _, on = pair(arch, remat=True)
    batch = _batch(off.cfg.vocab, seed=1)
    l0, g0 = _port_grads(off, batch)
    l1, g1 = _port_grads(on, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, b)
    toks = torch.as_tensor(batch["tokens"][:, :-1])
    with torch.no_grad():
        assert torch.equal(off.forward(toks), on.forward(toks))


def test_remat_recomputes_each_layer():
    """With remat on, the backward runs each layer's forward again: the
    MoE dispatch runs twice a layer (forward and recompute), once without."""
    calls = {"n": 0}
    orig = layers.moe_block

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    batch = _batch(211, seed=2)
    seen = {}
    for remat in (False, True):
        _, _, tm = pair("phi3.5-moe-42b-a6.6b", remat=remat)
        calls["n"] = 0
        layers.moe_block = counted
        try:
            _port_grads(tm, batch)
        finally:
            layers.moe_block = orig
        seen[remat] = calls["n"]
    assert seen == {False: 2, True: 4}


def _moe_inputs(seed: int, t: int = 48, d: int = 16, e: int = 4, f: int = 24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, t // 2, d)).astype(np.float32)
    router = rng.normal(size=(d, e)).astype(np.float32)
    # a router that favours expert 0, so pairs pile up past the capacity
    router[:, 0] += 0.8 * np.sign(x.reshape(-1, d).mean(0))
    w = [(rng.normal(size=s) / np.sqrt(s[-2])).astype(np.float32)
         for s in ((e, d, f), (e, d, f), (e, f, d))]
    return x, router, w


@pytest.mark.parametrize("capacity", [8, 12, 48])
def test_moe_block_grads_match_jax_with_drops(capacity):
    """``layers.moe_block``'s gradient (into the tokens, the router and the
    three expert weights) against ``jax.grad`` of the reference's, with
    pairs dropped at capacity 8 and 12 and none at 48: a dropped pair
    sends no gradient into its drop row or the row its clamped gather
    reads."""
    x, router, w = _moe_inputs(capacity)
    e, k = router.shape[1], 2
    dims = layers.MoEDims(e, k, capacity)
    jdims = jlayers.MoEDims(e, k, capacity)
    rng = np.random.default_rng(7)
    probe = rng.normal(size=x.shape).astype(np.float32)

    def jloss(x, r, a, b, c):
        out, _ = jlayers.moe_block(x, r, a, b, c, jdims)
        return jnp.sum(out * probe)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(x), jnp.asarray(router), *map(jnp.asarray, w))
    ts = [torch.tensor(a, requires_grad=True) for a in (x, router, *w)]
    out, _ = layers.moe_block(*ts, dims)
    tl = torch.sum(out * torch.as_tensor(probe))
    tg = torch.autograd.grad(tl, ts)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
    for g, want in zip(tg, jg):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=GRAD_REL * max(float(np.abs(want).max()), 1e-30))
    probs = torch.softmax(torch.as_tensor(x).reshape(-1, x.shape[-1]) @ torch.as_tensor(router),
                          dim=-1)
    load = torch.bincount(layers._top_k_largest(probs, k)[1].reshape(-1), minlength=e)
    dropped = int((load - capacity).clamp_min(0).sum())
    assert (dropped > 0) == (capacity < 48), (load, capacity)


def test_moe_model_step_with_drops_matches_jax():
    """The reduced Phi with a capacity factor of 0.25 (capacity 8 for 32
    pairs over 4 experts, so pairs drop in every layer): loss and gradients
    against JAX's."""
    jm, params, tm = pair("phi3.5-moe-42b-a6.6b", moe_capacity_factor=0.25)
    assert tm._capacity(32) == 8
    batch = _batch(tm.cfg.vocab, seed=4)
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(params, {"tokens": jnp.asarray(batch["tokens"])})
    loss, grads = _port_grads(tm, batch)
    _check(loss, grads, jloss, jgrads)


def test_aux_loss_stays_out_of_the_loss():
    """The reference drops the MoE's ``aux`` in ``_block``: the port's loss
    is the cross-entropy alone, equal to one computed from ``forward``."""
    _, _, tm = pair("kimi-k2-1t-a32b")
    batch = to_device(_batch(tm.cfg.vocab, seed=5), "cpu")
    toks = batch["tokens"]
    with torch.no_grad():
        logits = tm.forward(toks[:, :-1])
        want = torch.mean(torch.logsumexp(logits, -1)
                          - torch.gather(logits, -1, toks[:, 1:].long()[..., None])[..., 0])
        assert torch.equal(tm.loss_fn(batch), want)


def test_bf16_model_grads_are_bf16_and_finite():
    """A bf16 reduced Llama (the full config's dtype) takes a gradient: bf16
    leaves get bf16 gradients, float32 norms float32 ones, all finite, and
    remat on equals off bit for bit in bf16 too."""
    _, _, off = pair("llama3.2-1b", "bf16", remat=False)
    _, _, on = pair("llama3.2-1b", "bf16", remat=True)
    batch = _batch(off.cfg.vocab, seed=6)
    l0, g0 = _port_grads(off, batch)
    l1, g1 = _port_grads(on, batch)
    assert torch.isfinite(l0) and torch.equal(l0, l1)
    for p, a, b in zip(leaves(off.param_tree()), leaves(g0), leaves(g1)):
        assert a.dtype == p.dtype and bool(torch.isfinite(a).all())
        assert torch.equal(a, b)
    assert {p.dtype for p in leaves(g0)} == {torch.bfloat16, torch.float32}
    assert dataclasses.replace(off.cfg, remat=True) == on.cfg
