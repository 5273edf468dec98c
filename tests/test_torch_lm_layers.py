"""The port's transformer building blocks (``repro_torch.models.layers``)
against the JAX package's, on the CPU.

The same seed-made numpy inputs go through both.  Float32 results agree
within 1e-5: both run IEEE float32 but may sum in another order.  bf16
results agree within 2e-2 of the largest |output|: both round every op to
bf16, each summing in its own order.  ``quantize_kv`` agrees bit for bit
(both round half to even, both divide by 127).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 2e-2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _pair(a: np.ndarray, dt: str):
    """``a`` as a JAX array and a torch tensor of dtype ``dt``, holding the
    same values (bf16: rounded once, by JAX, and carried by its bits)."""
    j = jnp.asarray(a).astype(DTYPES[dt][0]) if a.dtype.kind == "f" else jnp.asarray(a)
    t = torch.as_tensor(np.array(j.astype(jnp.float32)) if a.dtype.kind == "f" else a)
    return j, (t.to(DTYPES[dt][1]) if a.dtype.kind == "f" else t)


def _close(got, want, dt: str) -> None:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    if dt == "f32":
        np.testing.assert_allclose(g, w, **TOL)
    else:
        assert np.abs(g - w).max() <= BF16_REL * max(np.abs(w).max(), 1e-6), \
            (np.abs(g - w).max(), np.abs(w).max())


def _rng(seed: int):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rms_norm_matches_jax(dt):
    rng = _rng(0)
    x = (3 * rng.normal(size=(2, 5, 32))).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    (jx, tx), (js, ts) = _pair(x, dt), _pair(scale, "f32")
    got = TL.rms_norm(tx, ts)
    assert got.dtype == DTYPES[dt][1]
    _close(got, JL.rms_norm(jx, js), dt)


@pytest.mark.parametrize("cap", [None, 30.0, 50.0])
def test_softcap_matches_jax(cap):
    x = (40 * _rng(1).normal(size=(3, 7, 11))).astype(np.float32)
    got = TL.softcap(torch.as_tensor(x), cap)
    np.testing.assert_allclose(_np(got), np.asarray(JL.softcap(jnp.asarray(x), cap)), **TOL)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("dh", [8, 64, 128, 256])
def test_rope_matches_jax_up_to_32k(dt, dh):
    """Positions up to 32,768 (the 32K cells): angles near 3e4 rad, where
    a float32 cos an ulp off in its frequency or its range reduction would
    move an output by 1e-4."""
    rng = _rng(2)
    x = rng.normal(size=(2, 9, 3, dh)).astype(np.float32)
    pos = np.sort(rng.integers(0, 32769, size=(2, 9)), axis=1).astype(np.int32)
    pos[0, -1] = 32768
    jx, tx = _pair(x, dt)
    for theta in (10000.0, 500000.0):
        got = TL.rope(tx, torch.as_tensor(pos), theta)
        assert got.dtype == DTYPES[dt][1]
        _close(got, JL.rope(jx, jnp.asarray(pos), theta), dt)


def _qkv(seed: int, b=2, s=6, t=6, h=4, kv=2, dh=8):
    rng = _rng(seed)
    q = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, t, kv, dh)).astype(np.float32)
    v = rng.normal(size=(b, t, kv, dh)).astype(np.float32)
    return q, k, v


def _positions(b: int, s: int, t: int):
    """(q_positions, kv_positions, kv_valid): prefill (S == T) or decode
    (S = 1 at position 5 of a T-slot cache, slots past it invalid)."""
    kv_pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    if s == t:
        return kv_pos.copy(), kv_pos, None
    q_pos = np.full((b, s), 5, np.int32)
    return q_pos, kv_pos, kv_pos <= 5


CASES = [
    # (S, T, window, softcap, with kv_valid)
    (6, 6, None, None, False),
    (6, 6, 3, None, False),
    (6, 6, None, 50.0, False),
    (6, 6, 2, 20.0, False),
    (1, 9, None, None, True),
    (1, 9, 3, 50.0, True),
    (1, 9, 2**30, None, True),
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("s, t, window, cap, valid", CASES)
def test_gqa_attention_matches_jax(dt, s, t, window, cap, valid):
    q, k, v = _qkv(3, s=s, t=t)
    q_pos, kv_pos, kv_valid = _positions(2, s, t)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    want = JL.gqa_attention(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                            None if kv_valid is None else jnp.asarray(kv_valid), window, cap)
    got = TL.gqa_attention(tq, tk, tv, torch.as_tensor(q_pos), torch.as_tensor(kv_pos),
                           None if kv_valid is None else torch.as_tensor(kv_valid), window, cap)
    assert got.dtype == DTYPES[dt][1]
    _close(got, want, dt)


def test_gqa_attention_groups_heads_kv_major():
    """Query head h reads kv head h // g: with kv head 1's values all 1 and
    kv head 0's all 0, heads 0..g-1 read 0 and heads g..2g-1 read 1."""
    q, k, _ = _qkv(4)
    v = np.zeros((2, 6, 2, 8), np.float32)
    v[:, :, 1] = 1.0
    pos = torch.as_tensor(_positions(2, 6, 6)[0])
    out = TL.gqa_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), pos, pos)
    np.testing.assert_allclose(out[:, :, :2].numpy(), 0.0)
    np.testing.assert_allclose(out[:, :, 2:].numpy(), 1.0, rtol=1e-6)


def test_gqa_attention_explicit_scale_matches_jax():
    q, k, v = _qkv(5)
    pos = _positions(2, 6, 6)[0]
    want = JL.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                            jnp.asarray(pos), scale=0.3)
    got = TL.gqa_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                           torch.as_tensor(pos), torch.as_tensor(pos), scale=0.3)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_kv_is_bit_equal_to_jax(dt):
    """int8 values and float32 scales bit for bit, including a zero row
    (scale floored at 1e-8) and quotients on .5 (half to even)."""
    x = (4 * _rng(6).normal(size=(2, 7, 3, 16))).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 0] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5] * 2, np.float32)
    jx, tx = _pair(x, dt)
    jq, js = JL.quantize_kv(jx)
    tq, ts = TL.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))
    np.testing.assert_array_equal(tq[0, 1, 0, :8].numpy(), [127, 0, 2, 2, 0, -2, -2, 126])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("s, t, window, cap, valid", [CASES[0], CASES[3], CASES[5]])
def test_gqa_attention_quantized_matches_jax(dt, s, t, window, cap, valid):
    q, k, v = _qkv(7, s=s, t=t)
    q_pos, kv_pos, kv_valid = _positions(2, s, t)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    jkq, jks = JL.quantize_kv(jk)
    jvq, jvs = JL.quantize_kv(jv)
    tkq, tks = TL.quantize_kv(tk)
    tvq, tvs = TL.quantize_kv(tv)
    want = JL.gqa_attention_quantized(
        jq, jkq, jks, jvq, jvs, jnp.asarray(q_pos), jnp.asarray(kv_pos),
        None if kv_valid is None else jnp.asarray(kv_valid), window, cap)
    got = TL.gqa_attention_quantized(
        tq, tkq, tks, tvq, tvs, torch.as_tensor(q_pos), torch.as_tensor(kv_pos),
        None if kv_valid is None else torch.as_tensor(kv_valid), window, cap)
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_swiglu_matches_jax(dt):
    rng = _rng(8)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    ws = [(rng.normal(size=sh) / 4).astype(np.float32) for sh in ((16, 24), (16, 24), (24, 16))]
    j = [_pair(a, dt) for a in (x, *ws)]
    _close(TL.swiglu(*(t for _, t in j)), JL.swiglu(*(a for a, _ in j)), dt)


@pytest.mark.parametrize("chunk", [2, 4, 8, 5])
def test_qchunked_attention_equals_full_attention(chunk):
    """Query chunks of the whole key range give the full attention's
    values (chunk 8 = S and 5, not dividing S, take the full path)."""
    q, k, v = _qkv(9, s=8, t=8)
    pos = _positions(2, 8, 8)[0]
    args = [torch.as_tensor(a) for a in (q, k, v, pos, pos)]
    full = TL.gqa_attention(*args, None, 3, 50.0)
    got = TL.gqa_attention_qchunked(*args, None, 3, 50.0, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0, atol=1e-6)
    want = JL.gqa_attention_qchunked(*(jnp.asarray(a) for a in (q, k, v, pos, pos)), None, 3,
                                     50.0, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _moe_inputs(seed: int, ties: bool, d=16, e=4, f=24):
    rng = _rng(seed)
    x = rng.normal(size=(2, 8, d)).astype(np.float32)
    router = rng.normal(size=(d, e)).astype(np.float32)
    if ties:  # experts 1 and 3 score alike for every token; 0 and 2 too
        router[:, 3] = router[:, 1]
        router[:, 2] = router[:, 0]
    w = [(rng.normal(size=sh) / 4).astype(np.float32) for sh in ((e, d, f), (e, d, f), (e, f, d))]
    return x, router, w


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("cap", [3, 16])
def test_moe_block_matches_jax(dt, ties, cap):
    """Capacity 3 drops pairs (16 tokens x top-2 over 4 experts); with ties
    the top-k must take the lower expert, as ``jax.lax.top_k`` does."""
    x, router, w = _moe_inputs(10, ties)
    dims_j, dims_t = JL.MoEDims(4, 2, cap), TL.MoEDims(4, 2, cap)
    jx, tx = _pair(x, dt)
    jw = [_pair(a, dt) for a in w]
    want, jaux = JL.moe_block(jx, jnp.asarray(router), *(a for a, _ in jw), dims_j)
    got, taux = TL.moe_block(tx, torch.as_tensor(router), *(t for _, t in jw), dims_t)
    assert got.dtype == DTYPES[dt][1]
    _close(got, want, dt)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    # drops happen at capacity 3: some token's output has fewer than 2 experts
    probs = torch.softmax(torch.as_tensor(x).reshape(-1, 16) @ torch.as_tensor(router), -1)
    per_expert = torch.bincount(TL._top_k_largest(probs, 2)[1].reshape(-1), minlength=4)
    assert (int(per_expert.max()) > cap) == (cap == 3)


def test_moe_top_k_takes_the_lowest_index_on_ties():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4], [0.0, 0.5, 0.5, 0.0]])
    vals, idx = TL._top_k_largest(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(idx.numpy(), [[0, 1], [1, 3], [1, 2]])
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_moe_block_with_all_experts_tied():
    """A zero router: every expert scores alike, so every token picks
    experts 0 and 1, and capacity 4 keeps only the first 4 tokens' pairs."""
    x, _, w = _moe_inputs(11, False)
    router = np.zeros((16, 4), np.float32)
    want, jaux = JL.moe_block(jnp.asarray(x), jnp.asarray(router), *map(jnp.asarray, w),
                              JL.MoEDims(4, 2, 4))
    got, taux = TL.moe_block(torch.as_tensor(x), torch.as_tensor(router),
                             *map(torch.as_tensor, w), TL.MoEDims(4, 2, 4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert np.abs(got.numpy().reshape(16, 16)[4:]).max() == 0.0
    assert np.abs(got.numpy().reshape(16, 16)[:4]).min() > 0.0
