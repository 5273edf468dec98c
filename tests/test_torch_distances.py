"""Every metric of the port's torch registry is within 1e-5 of the JAX
registry (``repro.core.distances``) on seeded inputs, and the torch
projection matches the reference's jnp projection."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as r_dist
from repro.core import projection as r_projection
from repro_torch.core import distances as t_dist
from repro_torch.core import projection as t_projection
from repro_torch.kernels import ref

METRICS = ["l2", "cosine", "jsd", "triangular", "l1", "linf", "l1^0.5",
           "jsd^0.5", "l2^0.25"]


def _inputs(metric, m, n, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((m, k)).astype(np.float32) + 1e-3
    y = rng.random((n, k)).astype(np.float32) + 1e-3
    if r_dist.get_metric(metric).probability_space:
        x /= x.sum(axis=1, keepdims=True)
        y /= y.sum(axis=1, keepdims=True)
    return x, y


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("m,n,k", [(7, 11, 5), (33, 20, 64), (1, 9, 112)])
def test_pairwise_matches_jax(metric, m, n, k):
    x, y = _inputs(metric, m, n, k, seed=m * 31 + n + k)
    want = np.asarray(r_dist.get_metric(metric).pairwise(jnp.asarray(x), jnp.asarray(y)))
    got = t_dist.get_metric(metric).pairwise(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_registry_matches_reference():
    for name in ("l2", "cosine", "jsd", "triangular", "l1", "linf", "l1^0.5"):
        t, r = t_dist.get_metric(name), r_dist.get_metric(name)
        assert (t.name, t.four_point, t.probability_space) == (
            r.name, r.four_point, r.probability_space)
    with pytest.raises(ValueError):
        t_dist.power_transform(t_dist.l1, 0.7)
    for bad in ("nope", "l1^0.50", "l1^x"):
        with pytest.raises(KeyError):
            t_dist.get_metric(bad)
    x, y = _inputs("l2", 2, 3, 4, seed=0)
    m = t_dist.get_metric("l2")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert float(m.point(tx[0], ty[0])) == float(m.pairwise(tx, ty)[0, 0])
    torch.testing.assert_close(m.to_query(tx[1], ty), m.pairwise(tx, ty)[1])


def test_tf32_matmul_is_refused_on_the_card_only():
    x = torch.ones(2, 3)
    t_dist.check_ieee_fp32(x)  # CPU tensors never round through TF32
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        t_dist.get_metric("l2").pairwise(x, x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("precision", ["medium", "high"])
def test_rounded_cpu_matmul_is_refused(precision):
    """``set_float32_matmul_precision("medium")`` lets oneDNN round a
    float32 CPU matmul to bfloat16 ("high": TF32): the guard, and the
    plain l2 version through it, refuse to run; the settings are restored
    afterwards, and the guard passes again."""
    x = torch.ones(2, 3)
    onednn = getattr(getattr(torch.backends.mkldnn, "matmul", None), "fp32_precision", None)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision(precision)
        with pytest.raises(RuntimeError, match="IEEE float32"):
            t_dist.check_ieee_fp32(x)
        with pytest.raises(RuntimeError, match="IEEE float32"):
            ref.pairwise_l2_ref(x, x)
    finally:
        torch.set_float32_matmul_precision(prev)
        if onednn is not None:
            torch.backends.mkldnn.matmul.fp32_precision = onednn
    assert torch.get_float32_matmul_precision() == prev
    t_dist.check_ieee_fp32(x)


@pytest.mark.parametrize("seed", [0, 1])
def test_torch_projection_matches_jnp(seed):
    rng = np.random.default_rng(seed)
    d1 = (np.abs(rng.normal(size=(30, 10))) + 0.1).astype(np.float32)
    d2 = (np.abs(rng.normal(size=(30, 10))) + 0.1).astype(np.float32)
    delta = (np.abs(rng.normal(size=(1, 10))) + 0.3).astype(np.float32)
    delta[0, 4] = 0.0  # degenerate plane -> the ring (0, d1)
    gx, gy = t_projection.project(torch.from_numpy(d1), torch.from_numpy(d2),
                                  torch.from_numpy(delta))
    wx, wy = r_projection.project(d1, d2, delta)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=1e-6, atol=1e-6)
    assert (gx.numpy()[:, 4] == 0).all()
    np.testing.assert_allclose(
        t_projection.project_x(d1, d2, delta).numpy(),
        np.asarray(r_projection.project_x(d1, d2, delta)), rtol=1e-6, atol=1e-6)
    box = rng.normal(size=(30, 10, 4)).astype(np.float32)
    np.testing.assert_allclose(
        t_projection.point_to_box(gx, gy, torch.from_numpy(box)).numpy(),
        np.asarray(r_projection.point_to_box(wx, wy, box)), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        t_projection.project(d1, d2, delta, xp=jnp)


BROADCAST_BODIES = {"jsd": "_jsd_body", "triangular": "_triangular_body",
                    "l1": "_l1_body", "linf": "_linf_body"}


def test_broadcast_budget_at_paper_size():
    """The exact phase of a 512-query batch at the paper's colors size runs
    the broadcast metrics in column chunks: one (512, cols, 112) float32
    transient stays within the budget, against 23.3 GB broadcast whole."""
    cols = t_dist.pair_chunk_cols(512, 101_504, 112)
    assert 512 * cols * 112 * 4 <= t_dist.PAIRWISE_CHUNK_BYTES <= 256 * 2**20
    assert math.ceil(101_504 / cols) > 1
    assert t_dist.pair_chunk_cols(10**7, 5, 112) == 1  # at least one column


@pytest.mark.parametrize("metric", sorted(BROADCAST_BODIES))
@pytest.mark.parametrize("budget_cols", [1, 7, 64])
def test_broadcast_metrics_chunk_within_budget(metric, budget_cols, monkeypatch):
    """With the byte budget lowered to a few columns, every transient the
    pairwise function builds is within it, the chunks cover ``y`` once, and
    the result is ``torch.equal`` to the single pass: each element's K-sum
    (or max) is one reduction over the same contiguous K values, whatever
    the number of columns beside it."""
    x, y = (torch.from_numpy(a) for a in _inputs(metric, 23, 150, 112, seed=budget_cols))
    pairwise = t_dist.get_metric(metric).pairwise
    whole = pairwise(x, y)
    seen = []
    body = getattr(t_dist, BROADCAST_BODIES[metric])

    def recording_body(xb, yb):
        seen.append(tuple(torch.broadcast_shapes(xb.shape, yb.shape)))
        return body(xb, yb)

    budget = 4 * 23 * 112 * budget_cols
    monkeypatch.setattr(t_dist, "PAIRWISE_CHUNK_BYTES", budget)
    monkeypatch.setattr(t_dist, BROADCAST_BODIES[metric], recording_body)
    got = pairwise(x, y)
    assert len(seen) == math.ceil(150 / budget_cols)
    assert all(4 * math.prod(shape) <= budget for shape in seen)
    assert sum(shape[1] for shape in seen) == 150
    assert torch.equal(got, whole)


@pytest.mark.parametrize("k", [16, 112])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_row_bits_independent_of_the_batch(metric, k):
    """One row's distances have the same bits in a batch of 1, 7, 40, 128 or
    512 rows, wherever the row sits in it: the plain l2 and cosine sum each
    inner product over K by itself (``row_dot``), where a BLAS matmul's
    blocking would follow the batch's row count.  The plain l2 tile keeps
    them too, and so does ``y`` taken in column chunks."""
    x, y = _inputs(metric, 512, 300, k, seed=k)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    pairwise = t_dist.get_metric(metric).pairwise
    want = pairwise(x[:1], y)[0]
    for n in (1, 7, 40, 128, 512):
        for pos in {0, n // 2, n - 1}:
            batch = torch.cat([x[1:pos + 1], x[:1], x[pos + 1:n]])
            assert torch.equal(pairwise(batch, y)[pos], want), (n, pos)
            if metric == "l2":
                assert torch.equal(ref.pairwise_l2_ref(batch, y)[pos], want), (n, pos)
    chunked = torch.cat([pairwise(x[:1], y[s:s + 7]) for s in range(0, 300, 7)], dim=1)
    assert torch.equal(chunked[0], want)
