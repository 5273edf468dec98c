"""The port's fault-tolerance contract on the CPU (the eight tests of
``tests/test_fault_tolerance.py``, on the reduced two-tower model since the
LM is not ported), and checkpoints carried across the two packages.

Checkpoint/restart is bit-exact; a corrupted leaf is refused; GC keeps the
last ``keep_last``; a crash at step 8 resumes to the same parameters as an
uninterrupted run; a checkpoint restores onto another device (the CPU here:
the elastic restart of one card); the stream resumes; int8 error feedback
stays within one quantisation step; compressed training still learns.
Across packages: a train state written by the JAX package's
``CheckpointManager`` restores in the port, and one written by the port
restores in JAX (``ml_dtypes`` in the JAX package only), leaf for leaf bit
for bit, bfloat16 leaves included.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import recsys_archs as jarchs
from repro.optim import adamw as j_adamw
from repro.train.step import init_state as j_init_state
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import common, recsys_archs
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import ClickStream
from repro_torch.models import recsys as R
from repro_torch.optim import adamw, int8_error_feedback, make_optimizer
from repro_torch.pytree import leaves, leaves_with_paths, path_key
from repro_torch.train.loop import TrainLoop, TrainLoopConfig
from repro_torch.train.step import functional_loss, init_state


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers at once,
    and a thread pool per worker oversubscribes the cores (a step that
    takes milliseconds alone took seconds beside the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_setup(tmp_path, total_steps=12, ckpt_every=4, arch="two-tower-retrieval",
                opt=None, compression=False, seed=7):
    bundle = get_arch(arch)
    model, cfg, _ = bundle.make_reduced()
    loss_fn = functional_loss(model, common.loss_for("recsys", model))
    opt = opt or make_optimizer("adamw", total_steps=total_steps)
    stream = ClickStream(model.cfg, batch=16, seed=seed)
    loop = TrainLoop(
        loss_fn, opt, stream,
        TrainLoopConfig(
            total_steps=total_steps, checkpoint_every=ckpt_every,
            checkpoint_dir=str(tmp_path / "ckpt"), log_every=100, compression=compression,
        ),
        device="cpu",
    )
    return model, loop


def _init(model):
    return model.init_params(torch.Generator().manual_seed(0), device="cpu").param_tree()


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path / "c")
    state = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16)},
             "step": torch.tensor(5, dtype=torch.int32)}
    mgr.save(5, state, extra={"stream": {"seed": 1, "step": 9}})
    like = {"a": torch.zeros(10), "b": {"c": torch.zeros((3, 4), dtype=torch.bfloat16)},
            "step": torch.tensor(0, dtype=torch.int32)}
    restored, extra = mgr.restore(like, device="cpu")
    assert extra == {"stream": {"seed": 1, "step": 9}}
    for a, b in zip(leaves(state), leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    manifest = json.loads((tmp_path / "c" / "step_000000005" / "manifest.json").read_text())
    assert [m["key"] for m in manifest["leaves"]] == ["a", "b/c", "step"]
    assert [m["dtype"] for m in manifest["leaves"]] == ["float32", "bfloat16", "int32"]


def test_checkpoint_detects_corruption(tmp_path):
    mgr = CheckpointManager(tmp_path / "c")
    mgr.save(1, {"w": torch.arange(100.0)})
    leaf = next((tmp_path / "c" / "step_000000001").glob("leaf_*.npy"))
    arr = np.load(leaf)
    arr[0] += 1
    np.save(leaf, arr)
    with pytest.raises(IOError, match="checksum"):
        mgr.restore({"w": torch.zeros(100)}, device="cpu")


def test_checkpoint_gc_keeps_last(tmp_path):
    mgr = CheckpointManager(tmp_path / "c", keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.full((4,), float(s))})
    assert mgr.all_steps() == [3, 4]


def test_crash_restart_is_bit_exact(tmp_path):
    """Train 12 steps straight vs crash-at-8 + resume: identical params."""
    model, loop_a = _tiny_setup(tmp_path / "a")
    state_a = loop_a.run(init_state(_init(model), loop_a.optimizer))

    model, loop_b = _tiny_setup(tmp_path / "b")
    with pytest.raises(RuntimeError, match="simulated crash"):
        loop_b.run(init_state(_init(model), loop_b.optimizer), crash_at=8)
    # a fresh loop object = a fresh process; restores step 8 + the stream
    model, loop_b2 = _tiny_setup(tmp_path / "b")
    state_b = loop_b2.init_or_restore(lambda: _init(model))
    assert int(state_b["step"]) == 8
    state_b = loop_b2.run(state_b)
    for a, b in zip(leaves(state_a), leaves(state_b)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert loop_a.losses[8:] == loop_b2.losses


def test_elastic_restore_onto_another_device(tmp_path):
    """Save from one device, restore onto the device given (the CPU here; on
    the card the CUDA device), and without one the CUDA device is asked
    for: no silent fallback."""
    mgr = CheckpointManager(tmp_path / "c")
    state = {"w": torch.arange(64.0).reshape(8, 8)}
    mgr.save(1, state)
    restored, _ = mgr.restore({"w": torch.empty((8, 8), device="meta")}, device="cpu")
    assert restored["w"].device == torch.device("cpu")
    assert torch.equal(restored["w"], state["w"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mgr.restore(state)


def test_stream_resume_determinism():
    cfg = get_arch("two-tower-retrieval").make_reduced()[1]
    s1 = ClickStream(cfg, batch=2, seed=3)
    for _ in range(5):
        s1.next()
    st = s1.state()
    a = s1.next()
    s2 = ClickStream(cfg, batch=2, seed=0)
    s2.restore(st)
    b = s2.next()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_int8_error_feedback_bounded_and_unbiased():
    rng = np.random.default_rng(0)
    g = {"w": torch.as_tensor(rng.normal(size=(64, 64)), dtype=torch.float32)}
    r = {"w": torch.zeros((64, 64))}
    acc = np.zeros((64, 64), np.float32)
    for _ in range(20):
        out, r = int8_error_feedback(g, r)
        acc += out["w"].numpy()
    # error feedback: accumulated compressed grads track accumulated true
    # grads to within one quantisation step
    scale = np.abs(g["w"].numpy()).max() / 127.0
    err = np.abs(acc - 20 * g["w"].numpy()).max()
    assert err <= scale + 1e-5, (err, scale)


def test_compression_training_converges(tmp_path):
    """Compressed training still reduces the loss.  The two-tower's
    synthetic (user, item) pairs are independent, so its in-batch softmax
    has nothing to learn below log(B); DLRM-RM2's clicks have a base rate
    (0.3) to learn, as the LM's tokens have a Zipf law in the reference's
    test."""
    model, loop = _tiny_setup(tmp_path, total_steps=30, ckpt_every=1000, arch="dlrm-rm2",
                              opt=adamw(lr=5e-3), compression=True, seed=1)
    state = loop.init_or_restore(lambda: _init(model))
    loop.run(state)
    assert np.mean(loop.losses[-5:]) < np.mean(loop.losses[:5]) - 0.1


# ------------------------------------------------ checkpoints across packages


def _jax_key(path) -> str:
    """A leaf's key as the reference's ``_flatten_with_paths`` spells it."""
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _bf16_pair():
    """The full two-tower widths in bfloat16 at vocab 31: JAX's train state
    and the port's over the same parameters (``load_jax_params``)."""
    jcfg = dataclasses.replace(jarchs.TWO_TOWER, vocab=31)
    tcfg = dataclasses.replace(recsys_archs.TWO_TOWER, vocab=31)
    jm, tm = jarchs._MODEL_CLS["two_tower"](jcfg), R.TwoTowerModel(tcfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    R.load_jax_params(tm, jax.tree.map(np.asarray, params), device="cpu")
    jstate = j_init_state(params, j_adamw())
    tstate = init_state(tm.param_tree(), adamw())
    # distinct moments, so a leaf swapped with another would show
    jstate["opt"]["m"] = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, jnp.float32) + p,
                                      jstate["opt"]["m"])
    jstate["step"] = jnp.int32(3)
    return jstate, tstate


def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    jstate, tstate = _bf16_pair()
    JCheckpointManager(tmp_path / "c").save(3, jstate, extra={"stream": {"seed": 0, "step": 3}})
    got, extra = CheckpointManager(tmp_path / "c").restore(tstate, device="cpu")
    assert extra == {"stream": {"seed": 0, "step": 3}}
    jflat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    tflat = leaves_with_paths(got)
    assert len(jflat) == len(tflat)
    n_bf16 = 0
    for (jpath, want), (tpath, have) in zip(jflat, tflat):
        assert _jax_key(jpath) == path_key(tpath)
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            n_bf16 += 1
            assert have.dtype == torch.bfloat16
            want = want.view(np.int16)
        np.testing.assert_array_equal(_bits(have), want)
    assert n_bf16 > 0 and int(got["step"]) == 3


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    jstate, tstate = _bf16_pair()
    tstate["step"] = torch.tensor(3, dtype=torch.int32)
    CheckpointManager(tmp_path / "c").save(3, tstate, extra={"stream": {"seed": 0, "step": 3}})
    got, extra = JCheckpointManager(tmp_path / "c").restore(jstate)
    assert extra == {"stream": {"seed": 0, "step": 3}}
    for have, (_, want) in zip(jax.tree.leaves(got), leaves_with_paths(tstate)):
        have = np.asarray(have)
        assert have.dtype.name == str(want.dtype).removeprefix("torch.")
        if have.dtype.name == "bfloat16":
            have = have.view(np.int16)
        np.testing.assert_array_equal(have, _bits(want))
    # the port's manifest is the reference's, key for key
    ref = tmp_path / "ref"
    JCheckpointManager(ref).save(3, jstate)
    a = json.loads((tmp_path / "c" / "step_000000003" / "manifest.json").read_text())
    b = json.loads((ref / "step_000000003" / "manifest.json").read_text())
    assert sorted(a) == sorted(b)
    assert [(m["key"], m["file"], m["shape"], m["dtype"]) for m in a["leaves"]] == \
        [(m["key"], m["file"], m["shape"], m["dtype"]) for m in b["leaves"]]
