"""LM training on the card: the reduced LM configs' loss and gradients on
the CUDA device against the same float32 model on the CPU, a train step run
twice from one state (bit for bit), remat on against off, the MoE backward
with pairs dropped at capacity, and the training launcher at ``--device
cuda``.

Both devices run IEEE float32 (TF32 off) and sum in another order, so the
loss agrees within 1e-5 relative and each gradient leaf within 1e-4 of its
largest |gradient| (``tests/test_torch_lm_train.py``'s bounds against
JAX).  The file imports no jax; on the card it runs as

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_lm_train.py
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.registry import registry
from repro_torch.data.pipeline import TokenStream
from repro_torch.kernels import _build
from repro_torch.models.params import cast_model
from repro_torch.optim import adafactor, adamw
from repro_torch.pytree import leaves, leaves_with_paths
from repro_torch.train.step import functional_loss, init_state, make_train_step, to_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
LM_ARCHS = ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "gemma2-9b",
            "deepseek-coder-33b", "llama3.2-1b"]
LOSS_REL = 1e-5
GRAD_REL = 1e-4


@pytest.fixture
def card():
    """The CUDA device, or a skip where no sm_90 card and nvcc are."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    try:
        _build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _models(arch: str, dev, **changes):
    """(the reduced float32 model on the CPU, the same weights on ``dev``)."""
    cpu, cfg, _ = registry()[arch].make_reduced()
    cpu = type(cpu)(dataclasses.replace(cfg, **changes))
    cpu.init_params(torch.Generator().manual_seed(0), device="cpu")
    return cpu, cast_model(cpu, torch.float32, dev)


def _batch(vocab: int, seed: int = 0, b: int = 4, s: int = 16) -> dict:
    return TokenStream(vocab=vocab, batch=b, seq=s, seed=seed).next()


def _step(model, microbatches: int = 1):
    opt = adafactor(lr=1e-2) if model.cfg.optimizer == "adafactor" else adamw(lr=3e-3)
    return make_train_step(functional_loss(model, model.loss_fn), opt, microbatches), opt


def _bits(t):
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.itemsize])


def _equal_trees(a, b) -> bool:
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y)) for (_, x), (_, y) in zip(la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_reduced_lm_grads_on_card_match_cpu(card, arch):
    cpu, dev_model = _models(arch, card)
    batch = _batch(cpu.cfg.vocab)
    step_c, _ = _step(cpu)
    step_d, _ = _step(dev_model)
    lc, gc = step_c.grads(cpu.param_tree(), to_device(batch, "cpu"))
    ld, gd = step_d.grads(dev_model.param_tree(), to_device(batch, card))
    assert abs(float(ld) - float(lc)) <= LOSS_REL * abs(float(lc))
    for a, b in zip(leaves(gd), leaves(gc)):
        assert a.device.type == "cuda" and bool(torch.isfinite(a).all())
        assert float((a.cpu() - b).abs().max()) <= GRAD_REL * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_step_on_card_twice_is_bit_equal(card, arch, microbatches):
    """Two steps from the same state on the same batch, each run twice:
    losses, parameters and optimizer states equal bit for bit (no atomic
    adds: the embedding's and the MoE's gathers add their gradients in a
    sorted order)."""
    _, model = _models(arch, card, remat=True)
    step, opt = _step(model, microbatches)
    batch = to_device(_batch(model.cfg.vocab, seed=1), card)
    runs = []
    for _ in range(2):
        state = init_state(model.param_tree(), opt)
        losses = []
        for _ in range(2):
            state, m = step(state, batch)
            losses.append(m["loss"])
        runs.append((state, torch.stack(losses)))
    assert torch.equal(_bits(runs[0][1]), _bits(runs[1][1]))
    assert _equal_trees(runs[0][0], runs[1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "phi3.5-moe-42b-a6.6b", "gemma2-9b"])
def test_remat_on_equals_off_on_card(card, arch):
    _, off = _models(arch, card, remat=False)
    on = type(off)(dataclasses.replace(off.cfg, remat=True)).load_param_tree(off.param_tree())
    batch = to_device(_batch(off.cfg.vocab, seed=2), card)
    l0, g0 = _step(off)[0].grads(off.param_tree(), batch)
    l1, g1 = _step(on)[0].grads(on.param_tree(), batch)
    assert torch.equal(l0, l1) and _equal_trees(g0, g1)


@pytest.mark.cuda
def test_moe_step_with_drops_on_card_matches_cpu(card):
    """The reduced Phi at a capacity factor of 0.25 (capacity 8 for 64
    pairs over 4 experts a microbatch): the card's loss and gradients
    against the CPU's, in bf16 too (finite, repeated bit for bit)."""
    cpu, dev_model = _models("phi3.5-moe-42b-a6.6b", card, moe_capacity_factor=0.25)
    assert dev_model._capacity(32) == 8
    batch = _batch(cpu.cfg.vocab, seed=3)
    lc, gc = _step(cpu)[0].grads(cpu.param_tree(), to_device(batch, "cpu"))
    ld, gd = _step(dev_model)[0].grads(dev_model.param_tree(), to_device(batch, card))
    assert abs(float(ld) - float(lc)) <= LOSS_REL * abs(float(lc))
    for a, b in zip(leaves(gd), leaves(gc)):
        assert float((a.cpu() - b).abs().max()) <= GRAD_REL * float(b.abs().max())
    bf16 = cast_model(cpu, torch.bfloat16, card)
    step = _step(bf16)[0]
    l1, g1 = step.grads(bf16.param_tree(), to_device(batch, card))
    l2, g2 = step.grads(bf16.param_tree(), to_device(batch, card))
    assert torch.isfinite(l1) and torch.equal(l1, l2) and _equal_trees(g1, g2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "pna"])
def test_training_launcher_on_card(card, arch, tmp_path):
    """``python -m repro_torch.launch.train --arch <arch> --reduced`` on the
    card: exit 0, finite losses, a checkpoint."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
                          "--reduced", "--steps", "10", "--checkpoint-every", "5",
                          "--checkpoint-dir", str(tmp_path)], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "done: final loss" in out.stdout and "on cuda" in out.stdout
    assert "nan" not in out.stdout and (tmp_path / "step_000000010").is_dir()
