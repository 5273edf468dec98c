"""Every metric of the port's torch registry is within 1e-5 of the JAX
registry (``repro.core.distances``) on seeded inputs, and the torch
projection matches the reference's jnp projection."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as r_dist
from repro.core import projection as r_projection
from repro_torch.core import distances as t_dist
from repro_torch.core import projection as t_projection

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
