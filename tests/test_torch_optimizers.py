"""The port's optimizers (``repro_torch.optim``) on the CPU: the six tests
of ``tests/test_optimizers.py`` on the port, then each optimizer held to
the JAX package's on the same trees and gradients.

Parity: both packages run IEEE float32 but reduce a sum in another order,
so a gradient, a norm or a mean may differ in its last bits.  Gradients
are compared first (within 1e-6 relative of the leaf's largest).  Adam's
first steps move an element by about lr * sign(g), so an element whose
gradient is rounding noise in both packages may move the other way: the
updates are compared only where |g| is above 1e-6 of its leaf's largest
|g| (within 1e-5 abs), and everywhere within 2 * lr a step.  Adafactor,
the schedule, the clip and int8 error feedback are compared everywhere
(within 1e-5 relative, int8 codes exactly but for rounding ties).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import cosine_schedule as j_cosine
from repro.optim import int8_error_feedback as j_int8
from repro_torch.optim import (adafactor, adamw, clip_by_global_norm, cosine_schedule,
                               int8_error_feedback, make_optimizer)
from repro_torch.pytree import leaves, tree_map

STEPS = 5
REL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers at once,
    and a thread pool per worker oversubscribes the cores (a step that
    takes milliseconds alone took seconds beside the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quadratic_problem(seed=0):
    rng = np.random.default_rng(seed)
    target = {
        "w": torch.as_tensor(rng.normal(size=(12, 8, 6)), dtype=torch.float32),
        "b": torch.as_tensor(rng.normal(size=(6,)), dtype=torch.float32),
    }
    params = tree_map(torch.zeros_like, target)

    def loss(p):
        return sum(torch.sum((a - b) ** 2) for a, b in zip(leaves(p), leaves(target)))

    return params, loss


def _grad(loss, params):
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    value = loss(live)
    grads = torch.autograd.grad(value, leaves(live))
    return value.detach(), dict(zip(sorted(params), grads))


def _run(opt, params, loss, steps=60):
    state = opt.init(params)
    vals = []
    for _ in range(steps):
        value, g = _grad(loss, params)
        params, state = opt.update(g, state, params)
        vals.append(float(value))
    return params, vals


# ---------------------------------------------------- tests/test_optimizers.py


def test_adamw_converges():
    params, loss = _quadratic_problem()
    _, vals = _run(adamw(lr=5e-2, weight_decay=0.0), params, loss)
    assert vals[-1] < 0.05 * vals[0]


def test_adafactor_converges():
    params, loss = _quadratic_problem()
    _, vals = _run(adafactor(lr=5e-2), params, loss)
    assert vals[-1] < 0.2 * vals[0]


def test_adafactor_factored_state_shapes():
    opt = adafactor()
    params = {"w": torch.zeros((12, 8, 6)), "s": torch.zeros((5,))}
    st = opt.init(params)
    assert st["f"]["w"]["vr"].shape == (12, 8)
    assert st["f"]["w"]["vc"].shape == (12, 6)
    assert st["f"]["s"]["v"].shape == (5,)


def test_adafactor_scanned_update_equals_dense_without_clip():
    """With update-clipping disabled the per-slice update is the dense
    update (the one intended difference is the per-slice RMS clip)."""
    params, loss = _quadratic_problem()
    _, g = _grad(loss, params)
    outs = {}
    for flag in (True, False):
        opt = adafactor(lr=1e-2, scan_leading_dim=flag, clip_threshold=1e9)
        newp, _ = opt.update(g, opt.init(params), params)
        outs[flag] = newp
    for a, b in zip(leaves(outs[True]), leaves(outs[False])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


def test_state_specs_raise_naming_the_sharding_item():
    """The state's structure is the reference's, and so are its specs:
    AdamW's moments take the parameters' specs, Adafactor's ``vr`` / ``vc``
    drop the last / second-to-last dim's (the name is kept from when the
    port raised here)."""
    from jax.sharding import PartitionSpec as JP

    from repro_torch.parallel.sharding import P
    from torch_sharding_common import spec_tuples

    params = {"w": torch.zeros((12, 8, 6)), "s": torch.zeros((5,))}
    specs = {"w": P(None, ("pod", "data"), "model"), "s": P("model")}
    jspecs = {"w": JP(None, ("pod", "data"), "model"), "s": JP("model")}
    for (opt, keys), jopt in zip(((adamw(), ["m", "step", "v"]), (adafactor(), ["f", "step"])),
                                 (j_adamw(), j_adafactor())):
        assert sorted(opt.init(params)) == keys
        got = opt.state_specs(specs)
        assert spec_tuples(got) == spec_tuples(jopt.state_specs(jspecs))
        assert sorted(got) == keys


def test_cosine_schedule_shape():
    lr = cosine_schedule(1e-3, warmup=10, total=100)
    vals = [float(lr(torch.tensor(s, dtype=torch.int32))) for s in (0, 5, 10, 50, 100)]
    assert vals[0] == 0.0
    assert vals[1] < vals[2]
    assert abs(vals[2] - 1e-3) < 1e-6
    assert vals[3] < vals[2]
    assert vals[4] >= 0.1 * 1e-3 * 0.999  # floor (fp32 rounding slack)


# ------------------------------------------------------------ parity with JAX


def _tree(seed: int, scanned: bool) -> dict:
    """A tree with a stacked leaf (leading dim 8: Adafactor's per-slice
    update when ``scanned``), a leaf of leading dim 4, a matrix, a vector,
    a list, and keys out of sorted order."""
    rng = np.random.default_rng(seed)
    lead = 8 if scanned else 2
    return {
        "w": rng.normal(size=(lead, 24, 16)).astype(np.float32),
        "emb": rng.normal(size=(4, 30, 8)).astype(np.float32),
        "mlp": [rng.normal(size=(16, 12)).astype(np.float32),
                rng.normal(size=(12,)).astype(np.float32)],
        "a": rng.normal(size=(5,)).astype(np.float32),
    }


def _grads(seed: int, like: dict) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.1).astype(np.float32), like)
        out.append(g)
    return out


def _t(tree):
    return jax.tree.map(torch.as_tensor, tree)


def _close(got, want, rel=REL):
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=rel, atol=rel * max(np.abs(b).max(), 1e-30))


def test_gradients_of_the_same_loss_agree():
    """The gradients both packages feed their optimizers: the same loss on
    the same tree, float32 in both, within 1e-6 relative."""
    p = _tree(0, scanned=True)
    target = _tree(1, scanned=True)

    def jloss(q):
        return sum(jnp.sum((a - b) ** 2 * 0.5) for a, b in zip(jax.tree.leaves(q),
                                                                jax.tree.leaves(target)))

    tt = _t(target)

    def tloss(q):
        return sum(torch.sum((a - b) ** 2 * 0.5) for a, b in zip(leaves(q), leaves(tt)))

    want = jax.grad(jloss)(p)
    live = tree_map(lambda a: a.detach().requires_grad_(True), _t(p))
    got = torch.autograd.grad(tloss(live), leaves(live))
    _close(list(got), want, rel=1e-6)


@pytest.mark.parametrize("lr", ["constant", "cosine"])
def test_adamw_matches_jax_over_five_steps(lr):
    p = _tree(2, scanned=True)
    gs = _grads(3, p)
    lr_j = 3e-3 if lr == "constant" else j_cosine(3e-3, 2, STEPS)
    lr_t = 3e-3 if lr == "constant" else cosine_schedule(3e-3, 2, STEPS)
    jopt, topt = j_adamw(lr=lr_j), adamw(lr=lr_t)
    jp, js, tp, ts = p, jopt.init(p), _t(p), topt.init(_t(p))
    for g in gs:
        jp_new, js = jopt.update(g, js, jp)
        tp_new, ts = topt.update(_t(g), ts, tp)
        for a0, a1, b0, b1, gl in zip(leaves(tp), leaves(tp_new), jax.tree.leaves(jp),
                                      jax.tree.leaves(jp_new), jax.tree.leaves(g)):
            got, want = (a1 - a0).numpy(), np.asarray(b1) - np.asarray(b0)
            live = np.abs(gl) > 1e-6 * np.abs(gl).max()
            np.testing.assert_allclose(got[live], want[live], atol=1e-5)
            assert np.abs(got - want).max() <= 2 * 3e-3
        jp, tp = jp_new, tp_new
        _close(ts["m"], js["m"])
        _close(ts["v"], js["v"])
        assert int(ts["step"]) == int(js["step"]) and ts["step"].dtype == torch.int32


@pytest.mark.parametrize("scanned", [True, False], ids=["scanned", "dense"])
def test_adafactor_matches_jax_over_five_steps(scanned):
    """A stacked leaf of leading dim 8 takes the per-slice update (its RMS
    clip per slice); ``scan_leading_dim=False`` the whole-leaf one."""
    p = _tree(4, scanned=True)
    gs = _grads(5, p)
    jopt = j_adafactor(lr=1e-2, scan_leading_dim=scanned, weight_decay=0.01)
    topt = adafactor(lr=1e-2, scan_leading_dim=scanned, weight_decay=0.01)
    jp, js, tp, ts = p, jopt.init(p), _t(p), topt.init(_t(p))
    for g in gs:
        jp, js = jopt.update(g, js, jp)
        tp, ts = topt.update(_t(g), ts, tp)
        _close(tp, jp)
        _close(ts["f"], js["f"])


def test_adafactor_clips_each_slice_apart():
    """The per-slice clip differs from the whole-leaf one where slices'
    RMS differ, in both packages alike."""
    p = _tree(6, scanned=True)
    g = _grads(7, p)[0]
    g["w"][0] *= 100.0  # one slice far above the clip
    outs = []
    for scanned in (True, False):
        tp, _ = adafactor(lr=1e-2, scan_leading_dim=scanned).update(
            _t(g), adafactor().init(_t(p)), _t(p))
        jp, _ = j_adafactor(lr=1e-2, scan_leading_dim=scanned).update(
            g, j_adafactor().init(p), p)
        _close(tp, jp)
        outs.append(tp["w"])
    assert not torch.allclose(outs[0][1:], outs[1][1:])


def test_cosine_schedule_matches_jax():
    j, t = j_cosine(1e-3, 10, 100), cosine_schedule(1e-3, 10, 100)
    for s in range(0, 120, 3):
        want = float(j(jnp.int32(s)))
        got = float(t(torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * 1e-3, (s, got, want)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    """The norm sums the leaves in JAX's order (sorted keys): the tree's
    keys are out of order here."""
    g = _grads(8, _tree(8, scanned=False))[0]
    got, gnorm = clip_by_global_norm(_t(g), max_norm)
    want, jnorm = j_clip(g, max_norm)
    assert abs(float(gnorm) - float(jnorm)) <= 1e-6 * float(jnorm)
    _close(got, want)


def test_int8_error_feedback_matches_jax_over_five_steps():
    p = _tree(9, scanned=False)
    gs = _grads(10, p)
    jr = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), p)
    tr = _t(jr)
    for g in gs:
        jg, jr = j_int8(g, jr)
        tg, tr = int8_error_feedback(_t(g), tr)
        for a, b in zip(leaves(tg), jax.tree.leaves(jg)):
            b = np.asarray(b)
            scale = np.abs(b).max() / 127.0
            codes_t, codes_j = np.round(a.numpy() / scale), np.round(b / scale)
            assert (codes_t != codes_j).mean() <= 1e-3  # only rounding ties
        for a, b in zip(leaves(tr), jax.tree.leaves(jr)):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= np.abs(b).max() * 2 + 1e-6


def test_make_optimizer_kinds():
    for kind in ("adamw", "adafactor"):
        assert make_optimizer(kind, total_steps=10).init({"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError):
        make_optimizer("sgd")
