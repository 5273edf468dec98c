"""LM train steps of the port against the JAX package's, on the CPU: five
steps of ``make_train_step`` for each reduced LM config (float32, JAX's own
parameters), with one and two microbatches, each config's optimizer
(Adafactor's factored state for the reduced Kimi, AdamW's float32 moments
for the others) at a constant learning rate; a bf16 state with float32
moments; LM checkpoints across the two packages; the training launcher on
the reduced LMs.

As for two-tower training (``tests/test_torch_train.py``): every loss
within 1e-5 relative of JAX's; every parameter within 2·lr a step of JAX's
(an element whose gradient is rounding noise in both packages may move
the other way); at most 1% of a leaf's elements more than 1e-5 from JAX's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_lm_common import LM_ARCHS, pair

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import common as jcommon
from repro.data.pipeline import TokenStream as JTokenStream
from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.train.step import init_state as j_init_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import common
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch.train import main as train_main
from repro_torch.optim import adafactor, adamw
from repro_torch.pytree import leaves, leaves_with_paths, path_key
from repro_torch.train.step import functional_loss, init_state, make_train_step, to_device

STEPS = 5
LOSS_REL = 1e-5
LR = {"adamw": 3e-3, "adafactor": 1e-2}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the suite runs several workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _optimizers(kind: str):
    lr = LR[kind]
    if kind == "adamw":
        return j_adamw(lr=lr), adamw(lr=lr)
    return j_adafactor(lr=lr), adafactor(lr=lr)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_steps_match_jax(arch, microbatches):
    jm, params, tm = pair(arch)
    kind = tm.cfg.optimizer
    assert kind == jm.cfg.optimizer and (kind == "adafactor") == (arch == "kimi-k2-1t-a32b")
    jopt, topt = _optimizers(kind)
    jstep = jax.jit(j_make_train_step(jcommon.loss_for("lm", jm), jopt, microbatches))
    tstep = make_train_step(functional_loss(tm, common.loss_for("lm", tm)), topt,
                            microbatches)
    js, ts = j_init_state(params, jopt), init_state(tm.param_tree(), topt)
    jstream = JTokenStream(vocab=tm.cfg.vocab, batch=4, seq=16, seed=0)
    tstream = TokenStream(vocab=tm.cfg.vocab, batch=4, seq=16, seed=0)
    for _ in range(STEPS):
        jb, tb = jstream.next(), tstream.next()
        js, jmet = jstep(js, jb)
        ts, tmet = tstep(ts, to_device(tb, "cpu"))
        want = float(jmet["loss"])
        assert abs(float(tmet["loss"]) - want) <= LOSS_REL * abs(want)
    assert int(ts["step"]) == STEPS and sorted(ts) == sorted(js)
    for got, want in zip(leaves(ts["params"]), jax.tree.leaves(js["params"])):
        d = np.abs(got.numpy() - np.asarray(want))
        assert d.max() <= 2 * LR[kind] * STEPS
        assert (d > 1e-5).mean() <= 0.01
    # the optimizer state has JAX's structure, shapes and dtypes
    jopt_l = jax.tree_util.tree_flatten_with_path(js["opt"])[0]
    topt_l = leaves_with_paths(ts["opt"])
    assert [path_key(p) for p, _ in topt_l] == \
        ["/".join(str(getattr(q, "key", getattr(q, "idx", q))) for q in p) for p, _ in jopt_l]
    for (_, t), (_, j) in zip(topt_l, jopt_l):
        assert tuple(t.shape) == j.shape and str(t.dtype).removeprefix("torch.") == str(j.dtype)


def test_bf16_lm_state_keeps_float32_moments():
    """The full configs' dtype: bf16 parameters, AdamW's moments in float32,
    two steps finite, the parameters moved and still bf16."""
    _, _, tm = pair("llama3.2-1b", "bf16")
    opt = adamw(lr=3e-3)
    step = make_train_step(functional_loss(tm, tm.loss_fn), opt)
    state = init_state(tm.param_tree(), opt)
    stream = TokenStream(vocab=tm.cfg.vocab, batch=2, seq=16)
    for _ in range(2):
        state, met = step(state, to_device(stream.next(), "cpu"))
        assert torch.isfinite(met["loss"])
    assert all(m.dtype == torch.float32 for m in leaves(state["opt"]["m"]))
    assert all(v.dtype == torch.float32 for v in leaves(state["opt"]["v"]))
    moved = 0
    for p0, p1 in zip(leaves(tm.param_tree()), leaves(state["params"])):
        assert p1.dtype == p0.dtype
        moved += int(not torch.equal(p0, p1))
    assert {p.dtype for p in leaves(state["params"])} == {torch.bfloat16, torch.float32}
    assert moved == len(leaves(state["params"]))


def _lm_states(arch: str):
    """JAX's and the port's train state of a reduced bf16 LM over the same
    parameters, with distinct moments and step 3."""
    jm, params, tm = pair(arch, "bf16")
    jopt, topt = _optimizers(tm.cfg.optimizer)
    jstate = j_init_state(params, jopt)
    jstate["opt"] = jax.tree.map(lambda a: a + 0.25 if a.dtype == jnp.float32 else a,
                                 jstate["opt"])
    jstate["step"] = jnp.int32(3)
    tstate = init_state(tm.param_tree(), topt)
    return jstate, tstate


@pytest.mark.parametrize("arch", ["llama3.2-1b", "kimi-k2-1t-a32b"])
def test_jax_lm_checkpoint_restores_in_the_port_bit_for_bit(arch, tmp_path):
    """A JAX LM train state (bf16 parameters; AdamW's or Adafactor's
    factored state) restores in the port leaf for leaf, bit for bit."""
    jstate, tstate = _lm_states(arch)
    JCheckpointManager(tmp_path / "c").save(3, jstate, extra={"stream": {"seed": 0, "step": 3}})
    got, extra = CheckpointManager(tmp_path / "c").restore(tstate, device="cpu")
    assert extra == {"stream": {"seed": 0, "step": 3}}
    jflat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    tflat = leaves_with_paths(got)
    assert len(jflat) == len(tflat)
    for (_, want), (_, have) in zip(jflat, tflat):
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            assert have.dtype == torch.bfloat16
            want = want.view(np.int16)
        np.testing.assert_array_equal(_bits(have), want)
    assert int(got["step"]) == 3


@pytest.mark.parametrize("arch", ["llama3.2-1b", "kimi-k2-1t-a32b"])
def test_port_lm_checkpoint_restores_in_jax_bit_for_bit(arch, tmp_path):
    """A port LM train state after two steps restores in JAX bit for bit."""
    jstate, tstate = _lm_states(arch)
    _, _, tm = pair(arch, "bf16")
    step = make_train_step(functional_loss(tm, tm.loss_fn), _optimizers(tm.cfg.optimizer)[1])
    stream = TokenStream(vocab=tm.cfg.vocab, batch=2, seq=16)
    for _ in range(2):
        tstate, _ = step(tstate, to_device(stream.next(), "cpu"))
    CheckpointManager(tmp_path / "c").save(2, tstate, extra={"stream": stream.state()})
    got, extra = JCheckpointManager(tmp_path / "c").restore(jstate)
    assert extra == {"stream": stream.state()}
    for have, (_, want) in zip(jax.tree.leaves(got), leaves_with_paths(tstate)):
        have = np.asarray(have)
        assert have.dtype.name == str(want.dtype).removeprefix("torch.")
        if have.dtype.name == "bfloat16":
            have = have.view(np.int16)
        np.testing.assert_array_equal(have, _bits(want))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "kimi-k2-1t-a32b"])
def test_lm_launcher_trains_reduced_on_cpu(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch <lm> --reduced --device
    cpu``: finite losses over 6 steps (Kimi with Adafactor), a checkpoint
    at step 5, and a second run that resumes from it."""
    args = ["--arch", arch, "--reduced", "--steps", "6", "--checkpoint-every", "5",
            "--device", "cpu", "--checkpoint-dir", str(tmp_path)]
    train_main(args)
    out = capsys.readouterr().out
    assert "done: final loss" in out and "over 6 steps" in out and "nan" not in out
    assert (tmp_path / "step_000000005").is_dir()
    train_main(args[:4] + ["7"] + args[5:])
    out = capsys.readouterr().out
    assert "resumed from step 5" in out and "over 2 steps" in out

