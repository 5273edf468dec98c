"""The port's train step (``repro_torch.train.step``) against the JAX
package's, on the CPU.

The reduced two-tower model holds JAX's own parameters
(``load_jax_params``); the same ``ClickStream`` batches go through both
packages' ``make_train_step`` for five steps, with one and two microbatches
and with int8 compression off and on.  Both run IEEE float32 but sum in
another order, so:

  * every loss within 1e-5 relative of JAX's;
  * every parameter within 2 * lr a step of JAX's: AdamW moves an element
    by about lr a step, and an element whose gradient is rounding noise in
    both packages may move the other way (int8 compression widens that
    set: a last-bit difference can cross a rounding boundary of the codes);
  * without compression, at most 1% of a leaf's elements more than 1e-5
    from JAX's.

Then one train step of every recsys arch (``tests/test_arch_smoke.py``'s
``test_arch_smoke_train_step``), and a step run under the audit's dispatch
watch: no float64 tensor and no operator that waits for the host.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import common as jcommon
from repro.configs.registry import registry as jax_registry
from repro.data.pipeline import ClickStream as JClickStream
from repro.optim import adamw as j_adamw
from repro.train.step import init_state as j_init_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.analysis.audit import watch_call
from repro_torch.configs import common
from repro_torch.configs.registry import registry
from repro_torch.data.pipeline import ClickStream
from repro_torch.models import recsys as R
from repro_torch.optim import adamw, make_optimizer
from repro_torch.pytree import leaves
from repro_torch.train.step import functional_loss, init_state, make_train_step, to_device

ARCHS = ["wide-deep", "din", "two-tower-retrieval", "dlrm-rm2"]
STEPS = 5
LR = 3e-3
LOSS_REL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers at once,
    and a thread pool per worker oversubscribes the cores (a step that
    takes milliseconds alone took seconds beside the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch: str = "two-tower-retrieval"):
    jm, _, _ = jax_registry()[arch].make_reduced()
    tm, _, _ = registry()[arch].make_reduced()
    params = jm.init_params(jax.random.PRNGKey(0))
    R.load_jax_params(tm, jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


def _port_step(tm, opt, microbatches=1, compression=False):
    loss_fn = functional_loss(tm, common.loss_for("recsys", tm))
    return make_train_step(loss_fn, opt, microbatches, compression)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("compression", [False, True], ids=["plain", "int8"])
def test_two_tower_train_step_matches_jax(microbatches, compression):
    jm, params, tm = _pair()
    jstep = jax.jit(j_make_train_step(jcommon.loss_for("recsys", jm), j_adamw(lr=LR),
                                      microbatches, compression))
    tstep = _port_step(tm, adamw(lr=LR), microbatches, compression)
    js = j_init_state(params, j_adamw(lr=LR), compression)
    ts = init_state(tm.param_tree(), adamw(lr=LR), compression)
    jstream, tstream = JClickStream(jm.cfg, 16, seed=0), ClickStream(tm.cfg, 16, seed=0)
    for _ in range(STEPS):
        jb, tb = jstream.next(), tstream.next()
        js, jmet = jstep(js, jb)
        ts, tmet = tstep(ts, to_device(tb, "cpu"))
        want = float(jmet["loss"])
        assert abs(float(tmet["loss"]) - want) <= LOSS_REL * abs(want)
    assert int(ts["step"]) == STEPS and ts["step"].dtype == torch.int32
    assert sorted(ts) == sorted(js)
    for got, want in zip(leaves(ts["params"]), jax.tree.leaves(js["params"])):
        d = np.abs(got.numpy() - np.asarray(want))
        assert d.max() <= 2 * LR * STEPS
        if not compression:
            assert (d > 1e-5).mean() <= 0.01
    if compression:
        for got, want in zip(leaves(ts["residual"]), jax.tree.leaves(js["residual"])):
            assert got.dtype == torch.float32 and got.shape == want.shape


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_smoke_train_step(arch):
    """One forward and two train steps of the reduced config on the CPU:
    finite losses, and the optimizer moved the parameters."""
    bundle = registry()[arch]
    model, cfg, batch_fn = bundle.make_reduced()
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = batch_fn(torch.Generator().manual_seed(1))
    with torch.no_grad():
        loss0 = bundle.loss_fn(model)(batch)
    assert loss0.shape == ()
    assert np.isfinite(float(loss0)), f"{arch}: non-finite initial loss"

    opt = make_optimizer(getattr(cfg, "optimizer", "adamw"))
    step = make_train_step(functional_loss(model, bundle.loss_fn(model)), opt, microbatches=1)
    params = model.param_tree()
    state = init_state(params, opt)
    state, metrics = step(state, batch)
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"])), f"{arch}: NaN after step"
    moved = any(not torch.equal(a, b) for a, b in zip(leaves(params), leaves(state["params"])))
    assert moved, f"{arch}: optimizer produced no update"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_makes_no_float64_and_no_sync(arch):
    """A step (two microbatches, compression on, the cosine schedule) under
    the audit's dispatch watch: every operator of the forward, the backward
    and the optimizer is seen."""
    bundle = registry()[arch]
    model, cfg, batch_fn = bundle.make_reduced()
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = batch_fn(torch.Generator().manual_seed(1))
    opt = make_optimizer("adamw", total_steps=10)
    step = make_train_step(functional_loss(model, bundle.loss_fn(model)), opt,
                           microbatches=2, compression=True)
    state = init_state(model.param_tree(), opt, compression=True)
    (new, metrics), problems = watch_call("train_step", step, state, batch)
    assert problems == []
    assert int(new["step"]) == 1 and np.isfinite(float(metrics["loss"]))


def test_watch_sees_a_sync_and_a_float64():
    """The watch the step is held to fires on a host read and on float64."""
    x = torch.ones(4)

    def bad(t):
        return float(t.sum()) + t.double().sum()

    _, problems = watch_call("bad", bad, x)
    assert {p.check for p in problems} == {"sync", "f64"}


def test_grads_and_apply_compose_to_the_step():
    """``step.grads`` then ``step.apply`` (the two parts the smoke times
    apart) give the step's own state, bit for bit."""
    _, _, tm = _pair()
    opt = adamw(lr=LR)
    step = _port_step(tm, opt)
    state = init_state(tm.param_tree(), opt)
    batch = to_device(ClickStream(tm.cfg, 16, seed=2).next(), "cpu")
    whole, metrics = step(state, batch)
    loss, grads = step.grads(state["params"], batch)
    parts = step.apply(state, grads)
    assert torch.equal(loss, metrics["loss"])
    for a, b in zip(leaves(whole), leaves(parts)):
        assert torch.equal(a, b)


def test_microbatches_must_divide_the_batch():
    _, _, tm = _pair()
    step = _port_step(tm, adamw(), microbatches=3)
    state = init_state(tm.param_tree(), adamw())
    with pytest.raises(ValueError, match="not divisible"):
        step(state, to_device(ClickStream(tm.cfg, 16, seed=0).next(), "cpu"))
