"""The port's kernel wrappers.

On the CPU every wrapper runs its plain PyTorch version; those are held to
the JAX Pallas kernels in interpret mode on the shapes of
``tests/test_kernels.py`` (odd m/n, degenerate deltas, padded blocks):
rtol = atol = 1e-5 in fp32 and an identical +inf pattern for l2, the
planar bound and every masked tile; rtol = 1e-4 / atol = 1e-5 for the
unmasked JSD and Triangular tiles, as the reference's own sweep holds
them (the Pallas JSD tile sums entropies, the port per-k terms).

The CUDA kernels themselves are held to the plain versions on the card by
``tests/test_torch_cuda_kernels.py``, which imports no jax.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels import pairwise_dist as r_pdist
from repro_torch.core import distances as t_dist
from repro_torch.core.precision import (ARITH_ULPS, JSD_ACCURATE_BELOW, jsd_accurate_below,
                                       prob_error_budget, prob_error_verdict)
from repro_torch.kernels import launch_counts, ops, ref, reset_launch_counts
from repro_torch.kernels.planar_exclusion import planar_lower_bound_pairs_kernel_call as planar_pairs
from test_torch_cuda_kernels import (MASKED_CASES, PAIRS_CASES, PAIRWISE_SHAPES, PLANAR_SHAPES,
                                     PROB_TOL, TOL, assert_same, normal, pairs_inputs,
                                     planar_inputs, simplex)



def gamma_simplex(rng, n, k):
    """The reference sweep's probability rows (tests/test_kernels.py:93)."""
    x = rng.gamma(1.0, size=(n, k)).astype(np.float32)
    return x / x.sum(axis=1, keepdims=True)


# ------------------------------------------------ plain versions vs Pallas


def l2_mismatch_report(x, y, x0, y0, got, want, squared) -> str:
    """What an l2 mismatch needs to be traced (ROADMAP Queue 3: the first
    case below failed once in a full parallel run and never alone): which
    side is off from float64, whether the inputs the JAX call may share
    zero-copy with torch stayed as drawn, and whether a persistent JAX
    compilation cache was on."""
    d = np.sqrt(((x0[:, None, :].astype(np.float64) - y0[None]) ** 2).sum(-1))
    d = d * d if squared else d
    return (f"max |torch - float64| {np.abs(got - d).max():.3g}, "
            f"max |jax - float64| {np.abs(want - d).max():.3g}, "
            f"inputs unchanged {np.array_equal(x, x0) and np.array_equal(y, y0)}, "
            f"jax compilation cache dir {jax.config.jax_compilation_cache_dir!r}")


@pytest.mark.parametrize("m,n,k", PAIRWISE_SHAPES)
@pytest.mark.parametrize("squared", [False, True])
def test_pairwise_l2_plain_matches_pallas(m, n, k, squared):
    rng = np.random.default_rng(m * 7 + n * 3 + k)
    x, y = normal(rng, m, k), normal(rng, n, k)
    x0, y0 = x.copy(), y.copy()
    want = np.asarray(r_ops.pairwise_l2(jnp.asarray(x), jnp.asarray(y),
                                        squared=squared, interpret=True))
    got = ops.pairwise_l2(torch.from_numpy(x), torch.from_numpy(y), squared=squared).numpy()
    assert_same(got, want, **TOL,
                err_msg=l2_mismatch_report(x, y, x0, y0, got, want, squared))
    np.testing.assert_allclose(
        ops.pairwise_metric("l2", torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(r_ops.pairwise_metric("l2", jnp.asarray(x), jnp.asarray(y),
                                         interpret=True)), **TOL)


@pytest.mark.parametrize("m,n,k,bm,bn", MASKED_CASES)
def test_masked_pairwise_plain_matches_pallas(m, n, k, bm, bn):
    rng = np.random.default_rng(5 + m + bm)
    x, y = normal(rng, m, k), normal(rng, n, k)
    tm = rng.integers(0, 2, size=(math.ceil(m / bm), math.ceil(n / bn))).astype(np.int32)
    tm[0] = 0  # an all-dead row of tiles
    want = np.asarray(r_ops.masked_pairwise_l2(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(tm), bm=bm, bn=bn, interpret=True))
    got = ops.masked_pairwise_l2(torch.from_numpy(x), torch.from_numpy(y),
                                 torch.from_numpy(tm), bm=bm, bn=bn)
    assert_same(got.numpy(), want, **TOL)
    assert np.isinf(got.numpy()[:bm]).all()
    got_metric = ops.masked_pairwise_metric(
        "l2", torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(tm != 0),
        bm=bm, bn=bn)
    assert_same(got_metric.numpy(), want, **TOL)


@pytest.mark.parametrize("q,m,b", PLANAR_SHAPES)
def test_planar_lower_bound_plain_matches_pallas(q, m, b):
    d1, d2, delta, boxes = planar_inputs(q, m, b, seed=q + m + b)
    want = np.asarray(r_ops.planar_lower_bound(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(delta), jnp.asarray(boxes),
        interpret=True))
    got = ops.planar_lower_bound(torch.from_numpy(d1), torch.from_numpy(d2),
                                 torch.from_numpy(delta), torch.from_numpy(boxes))
    assert_same(got.numpy(), want, **TOL)
    assert np.isinf(got.numpy()[:, -1]).all(), "padded block must bound to +inf"
    assert np.isfinite(got.numpy()[:, :-1]).all()


@pytest.mark.parametrize("q,p,m,b", PAIRS_CASES)
def test_planar_pairs_plain_matches_pallas(q, p, m, b):
    """The gather form's plain version against the Pallas kernel on d1, d2
    gathered with numpy, and bit for bit against the d1/d2 form."""
    dqp, pairs, delta, boxes = pairs_inputs(q, p, m, b, seed=q + m)
    d1, d2 = dqp[:, pairs[:, 0]], dqp[:, pairs[:, 1]]
    want = np.asarray(r_ops.planar_lower_bound(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(delta), jnp.asarray(boxes),
        interpret=True))
    got = planar_pairs(*map(torch.from_numpy, (dqp, pairs, delta, boxes)))
    assert_same(got.numpy(), want, **TOL)
    assert np.isinf(got.numpy()[:, -1]).all(), "padded block must bound to +inf"
    assert torch.equal(got, ops.planar_lower_bound(
        *map(torch.from_numpy, (d1, d2, delta, boxes))))


def test_planar_pairs_checks_its_arguments():
    dqp, pairs, delta, boxes = map(torch.from_numpy, pairs_inputs(4, 5, 3, 6, seed=0))
    with pytest.raises(TypeError, match="int64"):
        planar_pairs(dqp, pairs.int(), delta, boxes)
    with pytest.raises(ValueError, match=r"\(M, 2\)"):
        planar_pairs(dqp, pairs[:, :1], delta, boxes)
    with pytest.raises(ValueError, match="agree"):
        planar_pairs(dqp, pairs[:2], delta, boxes)
    with pytest.raises(TypeError, match="float32"):
        planar_pairs(dqp.double(), pairs, delta, boxes)


def test_index_refuses_pairs_outside_the_pivots():
    """The pivot pairs are checked once, where the device mirror is made:
    the planar kernel reads ``dqp[q, pairs[m, i]]`` unchecked."""
    import dataclasses

    from repro_torch.core import flat_index as t_flat

    db = np.random.default_rng(0).random((300, 8)).astype(np.float32)
    index = t_flat.build_bss("l2", db, n_pivots=6, n_pairs=5, block=64, device="cpu")
    assert index.device.pairs.dtype == torch.int64
    for bad in (6, -1):
        pairs = index.pairs.copy()
        pairs[2, 1] = bad
        with pytest.raises(ValueError, match="6 pivots"):
            _ = dataclasses.replace(index, pairs=pairs, _device=None).device


def test_bss_query_fused_plain_matches_pallas():
    from repro.core import flat_index as r_flat

    rng = np.random.default_rng(11)
    db = rng.random((512, 24)).astype(np.float32)
    q = rng.random((64, 24)).astype(np.float32)
    idx = r_flat.build_bss("l2", db, n_pivots=8, n_pairs=12, block=128, seed=2)
    args = (idx.pivots, idx.pairs, idx.deltas, idx.boxes, idx.data)
    want_d, want_m = r_ops.bss_query_fused(
        jnp.asarray(q), *map(jnp.asarray, args), 0.45, block=128, bq=32, interpret=True)
    got_d, got_m = ops.bss_query_fused(
        torch.from_numpy(q), *map(torch.from_numpy, args), 0.45, block=128, bq=32)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert_same(got_d.numpy(), np.asarray(want_d), **TOL)


@pytest.mark.parametrize("m,n,k", [(64, 64, 16), (100, 70, 48), (3, 130, 24)])
@pytest.mark.parametrize("maker", [gamma_simplex, simplex])
def test_pairwise_jsd_plain_matches_pallas(m, n, k, maker):
    """The standalone JSD call (jsd_dist.py:91); ``simplex`` rows put bins
    at 0, 1e-13 and 1e-9 around the xlogx guard."""
    rng = np.random.default_rng(m + n + k)
    x, y = maker(rng, m, k), maker(rng, n, k)
    want = np.asarray(r_ops.pairwise_jsd(jnp.asarray(x), jnp.asarray(y), interpret=True))
    got = ops.pairwise_jsd(torch.from_numpy(x), torch.from_numpy(y))
    assert_same(got.numpy(), want, **PROB_TOL)
    np.testing.assert_allclose(
        ops.pairwise_metric("jsd", torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(r_ops.pairwise_metric("jsd", jnp.asarray(x), jnp.asarray(y),
                                         interpret=True)), **PROB_TOL)


@pytest.mark.parametrize("m,n,k", [(64, 64, 16), (100, 200, 64), (3, 130, 24),
                                   (128, 128, 112)])
@pytest.mark.parametrize("maker", [gamma_simplex, simplex])
def test_pairwise_tri_plain_matches_pallas(m, n, k, maker):
    rng = np.random.default_rng(m * 3 + n + k)
    x, y = maker(rng, m, k), maker(rng, n, k)
    want = np.asarray(r_pdist.pairwise_kernel_call(
        "triangular", jnp.asarray(x), jnp.asarray(y), interpret=True))
    got = ops.pairwise_tri(torch.from_numpy(x), torch.from_numpy(y))
    assert_same(got.numpy(), want, **PROB_TOL)


@pytest.mark.parametrize("metric", ["jsd", "triangular"])
@pytest.mark.parametrize("m,n,k", [(256, 384, 32), (100, 200, 48)])
def test_masked_prob_plain_matches_pallas(metric, m, n, k):
    """The masked family (tests/test_kernels.py:127-156): dead tiles +inf,
    live tiles within 1e-5 of the Pallas tile."""
    rng = np.random.default_rng(7 + m)
    bm = bn = 128
    x, y = gamma_simplex(rng, m, k), gamma_simplex(rng, n, k)
    tm = rng.integers(0, 2, size=(math.ceil(m / bm), math.ceil(n / bn))).astype(np.int32)
    tm[0, 0] = 0
    want = np.asarray(r_pdist.masked_pairwise_kernel_call(
        metric, jnp.asarray(x), jnp.asarray(y), jnp.asarray(tm), bm=bm, bn=bn,
        interpret=True))
    got = ops.masked_pairwise_metric(metric, torch.from_numpy(x), torch.from_numpy(y),
                                     torch.from_numpy(tm), bm=bm, bn=bn)
    assert_same(got.numpy(), want, **TOL)
    assert np.isinf(got.numpy()[:bm, :bn]).all()


@pytest.mark.parametrize("metric", ["l2", "jsd", "triangular"])
@pytest.mark.parametrize("masked", [False, True])
def test_bf16_y_plain_matches_pallas(metric, masked):
    """The bf16-y forms (the Pallas calls compiled for a bfloat16 ``y``,
    the engines' bf16 corpus mirror): the same bf16 ``y`` through the
    Pallas tile in interpret mode and through the plain version, which
    upcasts it on entry.  Tolerances as for the float32 forms."""
    rng = np.random.default_rng(21 + int(masked))
    m, n, k, bm, bn = 100, 300, 40, 64, 128
    maker = (lambda r, a, b: normal(r, a, b)) if metric == "l2" else gamma_simplex
    x, y = maker(rng, m, k), maker(rng, n, k)
    y16 = torch.from_numpy(y).bfloat16()
    y_j = jnp.asarray(y).astype(jnp.bfloat16)
    np.testing.assert_array_equal(y16.float().numpy(), np.asarray(y_j, np.float32))
    if masked:
        tm = rng.integers(0, 2, size=(math.ceil(m / bm), math.ceil(n / bn))).astype(np.int32)
        tm[0, 0] = 0
        want = np.asarray(r_pdist.masked_pairwise_kernel_call(
            metric, jnp.asarray(x), y_j, jnp.asarray(tm), bm=bm, bn=bn, interpret=True))
        got = ops.masked_pairwise_metric(metric, torch.from_numpy(x), y16,
                                         torch.from_numpy(tm), bm=bm, bn=bn)
        tol = TOL
    else:
        want = np.asarray(r_pdist.pairwise_kernel_call(
            metric, jnp.asarray(x), y_j, interpret=True))
        got = ops.pairwise_metric(metric, torch.from_numpy(x), y16)
        tol = TOL if metric == "l2" else PROB_TOL
    assert got.dtype == torch.float32
    assert_same(got.numpy(), want, **tol)


@pytest.mark.parametrize("metric", ["jsd", "triangular"])
def test_prob_plain_chunked_equals_unchunked(metric, monkeypatch):
    """The plain tiles run over column chunks of ``y``; with the byte budget
    forced down to a few columns per pass the result is ``torch.equal`` to
    the single pass: each element's K-sum is one reduction over the same
    contiguous K values, whatever the number of columns beside it."""
    rng = np.random.default_rng(4)
    x, y = torch.from_numpy(simplex(rng, 37, 112)), torch.from_numpy(simplex(rng, 301, 112))
    plain = {"jsd": ref.pairwise_jsd_ref, "triangular": ref.pairwise_tri_ref}[metric]
    whole = plain(x, y)
    monkeypatch.setattr(t_dist, "PAIRWISE_CHUNK_BYTES", 4 * 37 * 112 * 7)
    assert t_dist.pair_chunk_cols(37, 301, 112) == 7
    assert torch.equal(plain(x, y), whole)
    tm = torch.from_numpy(rng.random((3, 10)) < 0.5)
    assert torch.equal(
        ops.masked_pairwise_metric(metric, x, y, tm, bm=16, bn=32),
        ref.masked_pairwise_metric_ref(whole, tm, 16, 32))


@pytest.mark.parametrize("metric", ["l2", "jsd", "triangular"])
def test_bss_query_fused_metric_dispatch_matches_pallas(metric):
    """``bss_query_fused`` with each tile metric against the reference's
    composition of the same Pallas kernels (its own ``bss_query_fused`` is
    l2 only)."""
    from repro.core import flat_index as r_flat

    rng = np.random.default_rng(12)
    db, q = gamma_simplex(rng, 1024, 24), gamma_simplex(rng, 40, 24)
    idx = r_flat.build_bss(metric, db, n_pivots=8, n_pairs=12, block=128, seed=2)
    args = (idx.pivots, idx.pairs, idx.deltas, idx.boxes, idx.data)
    dqp = r_pdist.pairwise_kernel_call(metric, jnp.asarray(q), jnp.asarray(idx.pivots),
                                       interpret=True)
    pairs = np.asarray(idx.pairs)
    lb = np.asarray(r_ops.planar_lower_bound(
        dqp[:, pairs[:, 0]], dqp[:, pairs[:, 1]], jnp.asarray(idx.deltas),
        jnp.asarray(idx.boxes), interpret=True))
    tile_min = lb.reshape(5, 8, -1).min(axis=1)
    v = np.unique(tile_min)  # about half the (tile, block) cells live, and no
    t = float(0.5 * (v[len(v) // 2 - 1] + v[len(v) // 2]))  # bound ties t
    tm = tile_min <= t
    got_d, got_m = ops.bss_query_fused(torch.from_numpy(q), *map(torch.from_numpy, args), t,
                                       block=128, bq=8, metric_name=metric)
    np.testing.assert_array_equal(got_m.numpy(), tm)
    if metric == "l2":
        want_d, want_m = r_ops.bss_query_fused(jnp.asarray(q), *map(jnp.asarray, args), t,
                                               block=128, bq=8, interpret=True)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    want_d = np.asarray(r_pdist.masked_pairwise_kernel_call(
        metric, jnp.asarray(q), jnp.asarray(idx.data), jnp.asarray(tm), bm=8, bn=128,
        interpret=True))
    assert_same(got_d.numpy(), want_d, **TOL)
    assert tm.any() and not tm.all()


def test_kernel_metrics_and_ops_names_match_reference():
    assert ops.KERNEL_METRICS == r_ops.KERNEL_METRICS == ("l2", "jsd", "triangular")
    assert set(ops.__all__) == set(r_ops.__all__)


# ------------------------------------------------------------- validation


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, y = torch.ones(5, 3), torch.ones(7, 3)
    with pytest.raises(ValueError, match="does not match"):
        ops.masked_pairwise_l2(x, y, torch.ones(2, 3, dtype=torch.int32), bm=4, bn=4)
    with pytest.raises(ValueError, match="feature dimension"):
        ops.pairwise_l2(x, torch.ones(7, 4))
    # a bf16 y is the bf16 exact phase's corpus mirror: upcast on entry
    assert torch.equal(ops.pairwise_l2(x, y.bfloat16()), ops.pairwise_l2(x, y))
    with pytest.raises(TypeError):
        ops.pairwise_l2(x.double(), y.double())
    with pytest.raises(TypeError):  # x stays float32
        ops.pairwise_l2(x.bfloat16(), y.bfloat16())
    with pytest.raises(TypeError):  # no float16 corpus
        ops.pairwise_l2(x, y.half())
    for name in ("cosine", "l1^0.5", "nope"):  # no tile: served as l2, or plain
        with pytest.raises(KeyError, match="no tile kernel"):
            ops.pairwise_metric(name, x, y)
    with pytest.raises(KeyError, match="no tile kernel"):
        ops.masked_pairwise_metric("l1", x, y, torch.ones(1, 1), bm=8, bn=8)
    assert torch.equal(ops.pairwise_jsd(x, y.bfloat16()), ops.pairwise_jsd(x, y))
    assert torch.equal(
        ops.masked_pairwise_metric("triangular", x, y.bfloat16(), torch.ones(1, 1),
                                   bm=8, bn=8),
        ops.masked_pairwise_metric("triangular", x, y, torch.ones(1, 1), bm=8, bn=8))
    with pytest.raises(TypeError):
        ops.pairwise_jsd(x.bfloat16(), y)
    with pytest.raises(TypeError):
        ops.masked_pairwise_metric("triangular", x, y.half(), torch.ones(1, 1),
                                   bm=8, bn=8)
    with pytest.raises(ValueError, match="does not match"):
        ops.masked_pairwise_metric("jsd", x, y, torch.ones(2, 2), bm=8, bn=8)
    with pytest.raises(ValueError, match="agree"):
        ops.planar_lower_bound(x, x, torch.ones(4), torch.ones(2, 3, 4))


def test_cpu_runs_count_no_launches():
    reset_launch_counts()
    d1, d2, delta, boxes = map(torch.from_numpy, planar_inputs(9, 4, 6, seed=0))
    ops.planar_lower_bound(d1, d2, delta, boxes)
    planar_pairs(*map(torch.from_numpy, pairs_inputs(9, 5, 4, 6, seed=0)))
    ops.pairwise_l2(d1, d2)
    p = torch.from_numpy(simplex(np.random.default_rng(0), 9, 4))
    ops.pairwise_jsd(p, p)
    ops.masked_pairwise_metric("triangular", p, p, torch.ones(1, 1), bm=16, bn=16)
    ops.masked_pairwise_metric("jsd", p, p.bfloat16(), torch.ones(1, 1), bm=16, bn=16)
    ops.pairwise_l2(d1, d2.bfloat16())
    assert launch_counts() == {
        "pairwise_l2": 0, "masked_pairwise_l2": 0, "pairwise_jsd": 0,
        "masked_pairwise_jsd": 0, "pairwise_tri": 0, "masked_pairwise_tri": 0,
        "pairwise_l2_bf16": 0, "masked_pairwise_l2_bf16": 0, "pairwise_jsd_bf16": 0,
        "masked_pairwise_jsd_bf16": 0, "pairwise_tri_bf16": 0,
        "masked_pairwise_tri_bf16": 0, "planar_lower_bound": 0,
        "planar_lower_bound_pairs": 0}


@pytest.mark.parametrize("metric", ["jsd", "triangular"])
def test_prob_error_budget_fits_the_bf16_margin(metric):
    """The JSD / Triangular tiles' derived error budget (``csrc/prob_dist.cu``):
    the lg2 part is 2^-22 (1 + log2 K) / 2d, and twice the whole budget near
    the smallest SISAP colors threshold and kth (above 0.21 at K = 112) lies
    inside the bf16 margin's fp32 arithmetic term, as the two passes of the
    bf16 proof need."""
    k = 112
    approx, fp32 = (float(v) for v in prob_error_budget(metric, k, 0.21))
    arith = ARITH_ULPS * float(np.finfo(np.float32).eps) * math.sqrt(k)
    assert 2 * (approx + fp32) <= arith
    if metric == "jsd":
        assert approx == pytest.approx(2.0 ** -22 * (1 + math.log2(k)) / 0.42)
    # JSD's bound is on d^2, so it shrinks with d (up to 0.7 at K = 112);
    # Triangular's is relative
    steps = np.diff(sum(prob_error_budget(metric, k, np.linspace(0.2, 0.7, 6))))
    assert (steps < 0).all() if metric == "jsd" else (steps > 0).all()
    with pytest.raises(KeyError):
        prob_error_budget("l2", k, 0.5)


@pytest.mark.parametrize("k", [1, 3, 15, 16, 112, 130])
@pytest.mark.parametrize("metric", ["jsd", "triangular"])
def test_plain_prob_within_the_fp32_budget(metric, k):
    """The plain fp32 JSD / Triangular versions (accurate logarithm, IEEE
    division) against float64, near duplicates included: inside the fp32
    part of the derived budget, which the card tiles' budget adds its lg2 /
    rcp part to.  At small d no fp32 form holds a fixed 1e-5 there (JSD's
    rounding error is carried to d through dS / 2d), so the budget is what
    the card tests hold below d = 0.05."""
    from repro_torch.core.npdist import pairwise_np

    rng = np.random.default_rng(7 * k + 129)
    x = simplex(rng, 70, k)
    near = np.abs(x[:20] * (1 + 1e-3 * rng.normal(size=(20, k)))).astype(np.float32)
    for y in (simplex(rng, 129, k), near / near.sum(axis=1, keepdims=True),
              torch.from_numpy(x[:30]).bfloat16().float().numpy()):
        plain = ref.pairwise_jsd_ref if metric == "jsd" else ref.pairwise_tri_ref
        got = plain(torch.from_numpy(x), torch.from_numpy(y)).numpy().astype(np.float64)
        want = pairwise_np(metric, x, y)
        _, fp32 = prob_error_budget(metric, k, np.minimum(got, want))
        assert (np.abs(got - want) <= fp32).all()
        verdict = prob_error_verdict(metric, k, got, want, 0.21)
        assert verdict["cells_over_budget"] == 0 and verdict["cells"] == got.size
        # twice the budget at 0.21 (below SISAP colors' thresholds and kth)
        # fits the arithmetic term ARITH_ULPS eps_f32 sqrt(K)
        assert verdict["ok"] and verdict["arith_term"] == ARITH_ULPS * 2.0 ** -23 * math.sqrt(k)


@pytest.mark.parametrize("k", [3, 16, 112])
def test_jsd_near_duplicate_regime(k):
    """Below ``JSD_ACCURATE_BELOW`` the JSD tile recomputes a cell with the
    accurate logarithm (``csrc/prob_dist.cu``): the budget there has no
    approximate part.  The recompute threshold on the fast sum S covers
    every cell whose exact distance is below 0.05 (S_0 is 0.05^2 plus the
    fast sum's own bound there), and a fast output, sqrt(S) with S >= S_0,
    is never below 0.05."""
    s0 = jsd_accurate_below(k)
    u = float(np.finfo(np.float32).eps) / 2
    fast_bound = 2.0 ** -22 * (1 + math.log2(k)) + u * (6 * math.log2(k) + 2) + (k + 1) * u * s0
    assert s0 >= JSD_ACCURATE_BELOW ** 2 + fast_bound
    assert np.sqrt(np.float32(s0)) > np.float32(JSD_ACCURATE_BELOW)
    d = np.array([1e-3, 0.01, 0.049, 0.05, 0.2])
    approx, fp32 = prob_error_budget("jsd", k, d)
    assert (approx[:3] == 0).all() and (approx[3:] > 0).all()
    # below 0.05 the accurate regime is tighter than the fast one was
    fast = 2.0 ** -22 * (1 + math.log2(k)) / (2 * d[:3])
    assert (fp32[:3] < fast + (u * (6 * math.log2(k) + 2)) / (2 * d[:3]) + 2 * u * d[:3]).all()
