"""The port's kernel wrappers.

On the CPU every wrapper runs its plain PyTorch version; those are held to
the JAX Pallas kernels in interpret mode on the shapes of
``tests/test_kernels.py`` (odd m/n, degenerate deltas, padded blocks):
rtol = atol = 1e-5 in fp32 and an identical +inf pattern.

The CUDA kernels themselves are held to the plain versions on the card by
``tests/test_torch_cuda_kernels.py``, which imports no jax.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from test_torch_cuda_kernels import (MASKED_CASES, PAIRWISE_SHAPES, PLANAR_SHAPES, TOL,
                                     assert_same, normal, planar_inputs)


# ------------------------------------------------ plain versions vs Pallas


@pytest.mark.parametrize("m,n,k", PAIRWISE_SHAPES)
@pytest.mark.parametrize("squared", [False, True])
def test_pairwise_l2_plain_matches_pallas(m, n, k, squared):
    rng = np.random.default_rng(m * 7 + n * 3 + k)
    x, y = normal(rng, m, k), normal(rng, n, k)
    want = np.asarray(r_ops.pairwise_l2(jnp.asarray(x), jnp.asarray(y),
                                        squared=squared, interpret=True))
    got = ops.pairwise_l2(torch.from_numpy(x), torch.from_numpy(y), squared=squared)
    assert_same(got.numpy(), want, **TOL)
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


# ------------------------------------------------------------- validation


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, y = torch.ones(5, 3), torch.ones(7, 3)
    with pytest.raises(ValueError, match="does not match"):
        ops.masked_pairwise_l2(x, y, torch.ones(2, 3, dtype=torch.int32), bm=4, bn=4)
    with pytest.raises(ValueError, match="feature dimension"):
        ops.pairwise_l2(x, torch.ones(7, 4))
    with pytest.raises(NotImplementedError, match="bf16"):
        ops.pairwise_l2(x, y.bfloat16())
    with pytest.raises(TypeError):
        ops.pairwise_l2(x.double(), y.double())
    with pytest.raises(NotImplementedError, match="jsd"):
        ops.pairwise_metric("jsd", x, y)
    with pytest.raises(NotImplementedError, match="triangular"):
        ops.masked_pairwise_metric("triangular", x, y, torch.ones(1, 1), bm=8, bn=8)
    with pytest.raises(ValueError, match="agree"):
        ops.planar_lower_bound(x, x, torch.ones(4), torch.ones(2, 3, 4))


def test_cpu_runs_count_no_launches():
    reset_launch_counts()
    d1, d2, delta, boxes = map(torch.from_numpy, planar_inputs(9, 4, 6, seed=0))
    ops.planar_lower_bound(d1, d2, delta, boxes)
    ops.pairwise_l2(d1, d2)
    assert launch_counts() == {
        "pairwise_l2": 0, "masked_pairwise_l2": 0, "planar_lower_bound": 0}
