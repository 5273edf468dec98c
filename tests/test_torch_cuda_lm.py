"""The LM family's serving path on the card: the five reduced LM configs on
the CUDA device against the same float32 model on the CPU, the MoE
dispatch with drops and router ties, greedy decode run twice, and the LM
embedding example at ``--device cuda``.

Both devices run IEEE float32 (TF32 off) and sum in another order, so
logits agree within 1e-5; an int8 cache value may sit one step apart where
a K / V value lies on a rounding boundary.  The file imports no jax; on
the card it runs as

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_lm.py
"""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import registry
from repro_torch.kernels import _build
from repro_torch.models import layers
from repro_torch.models.params import cast_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
LM_ARCHS = ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "gemma2-9b",
            "deepseek-coder-33b", "llama3.2-1b"]
TOL = dict(rtol=1e-5, atol=1e-5)


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
    """(the reduced model on the CPU, the same weights on ``dev``)."""
    cpu, cfg, _ = registry()[arch].make_reduced()
    if changes:
        cpu = type(cpu)(dataclasses.replace(cfg, **changes))
    cpu.init_params(torch.Generator().manual_seed(0), device="cpu")
    return cpu, cast_model(cpu, torch.float32, dev)


def _tokens(vocab: int, seed: int, s: int = 16) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=(2, s)).astype(np.int32)


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_reduced_forward_and_prefill_on_card_match_cpu(card, arch):
    cpu, gpu = _models(arch, card)
    toks = _tokens(cpu.cfg.vocab, 1)
    with torch.inference_mode():
        np.testing.assert_allclose(_np(gpu.forward(torch.as_tensor(toks, device=card))),
                                   _np(cpu.forward(torch.as_tensor(toks))), **TOL)
        for chunk in (None, 4):
            gl, gc = gpu.prefill(torch.as_tensor(toks, device=card), chunk=chunk)
            cl, cc = cpu.prefill(torch.as_tensor(toks), chunk=chunk)
            np.testing.assert_allclose(_np(gl), _np(cl), **TOL)
            for key in ("k", "v"):
                np.testing.assert_allclose(_np(gc[key]), _np(cc[key]), **TOL)
        batch = {"tokens": torch.as_tensor(_tokens(cpu.cfg.vocab, 2, 33))}
        np.testing.assert_allclose(float(gpu.loss_fn({"tokens": batch["tokens"].to(card)})),
                                   float(cpu.loss_fn(batch)), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_reduced_decode_on_card_matches_cpu(card, arch, kv):
    cpu, gpu = _models(arch, card, kv_cache_dtype=kv)
    toks = _tokens(cpu.cfg.vocab, 3, 8)
    caches = [{k: torch.zeros(s.shape, dtype=s.dtype, device=d)
               for k, s in cpu.init_cache_shapes(2, 12).items()} for d in (card, "cpu")]
    with torch.inference_mode():
        for i in range(8):
            gl, caches[0] = gpu.decode_step(caches[0], torch.as_tensor(toks[:, i:i + 1],
                                                                       device=card), i)
            cl, caches[1] = cpu.decode_step(caches[1], torch.as_tensor(toks[:, i:i + 1]), i)
            np.testing.assert_allclose(_np(gl), _np(cl), **TOL)
    for key, t in caches[0].items():
        if t.dtype == torch.int8:
            diff = np.abs(t.cpu().numpy().astype(np.int32) - caches[1][key].numpy())
            assert diff.max() <= 1, diff.max()
        else:
            np.testing.assert_allclose(_np(t), _np(caches[1][key]), **TOL)


@pytest.mark.cuda
def test_quantize_kv_and_rope_on_card_match_cpu(card):
    """``quantize_kv`` bit for bit (one division by 127, no reciprocal),
    RoPE at positions up to 32,768 within 1e-5."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor((4 * rng.normal(size=(2, 64, 8, 128))).astype(np.float32))
    for xt in (x, x.bfloat16()):
        gq, gs = layers.quantize_kv(xt.to(card))
        cq, cs = layers.quantize_kv(xt)
        assert torch.equal(gq.cpu(), cq) and torch.equal(gs.cpu().view(torch.int32),
                                                         cs.view(torch.int32))
    pos = torch.as_tensor(np.sort(rng.integers(0, 32769, size=(2, 64)), axis=1).astype(np.int32))
    np.testing.assert_allclose(_np(layers.rope(x.to(card), pos.to(card), 500000.0)),
                               _np(layers.rope(x, pos, 500000.0)), **TOL)
    np.testing.assert_allclose(_np(layers.softcap(x.to(card) * 20, 30.0)),
                               _np(layers.softcap(x * 20, 30.0)), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [2, 3, 64])
def test_moe_block_with_drops_and_ties_on_card(card, cap):
    """Capacity 2 and 3 drop pairs into the buffer's drop row (no
    device-side assert); experts 0 / 2 and 1 / 3 tie for every token; the
    card's output equals the CPU's."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 8, 16)).astype(np.float32)
    router = rng.normal(size=(16, 4)).astype(np.float32)
    router[:, 2], router[:, 3] = router[:, 0], router[:, 1]
    ws = [(rng.normal(size=sh) / 4).astype(np.float32) for sh in ((4, 16, 24), (4, 16, 24),
                                                                  (4, 24, 16))]
    dims = layers.MoEDims(4, 2, cap)
    for dt in (torch.float32, torch.bfloat16):
        args = [torch.as_tensor(a) for a in (x, router, *ws)]
        args = [a.to(dt) if i != 1 else a for i, a in enumerate(args)]
        got, aux = layers.moe_block(*(a.to(card) for a in args), dims)
        torch.cuda.synchronize()
        want, want_aux = layers.moe_block(*args, dims)
        tol = TOL if dt == torch.float32 else dict(rtol=0, atol=2e-2 * float(want.abs().max()))
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    zero = layers.moe_block(*(torch.as_tensor(a).to(card) for a in (x, 0 * router, *ws)),
                            dims)[0]
    torch.cuda.synchronize()
    kept = min(cap, 16)  # every token picks experts 0 and 1: the first cap tokens kept
    assert float(zero.reshape(16, 16)[kept:].abs().max() if kept < 16 else 0.0) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2-9b", "phi3.5-moe-42b-a6.6b"])
def test_greedy_decode_is_identical_when_run_twice(card, arch):
    """bf16 on the card: prefill, then 8 greedy steps with the config's
    cache, twice: the same tokens and the same logits bit for bit."""
    model, cfg, _ = registry()[arch].make_reduced()
    model = type(model)(dataclasses.replace(cfg, dtype=torch.bfloat16))
    model.init_params(torch.Generator(card).manual_seed(0), device=card)
    prompt = torch.as_tensor(_tokens(cfg.vocab, 6, 12), device=card)
    runs = []
    for _ in range(2):
        with torch.inference_mode():
            logits, pcache = model.prefill(prompt)
            cache = {k: torch.zeros(s.shape, dtype=s.dtype, device=card)
                     for k, s in model.init_cache_shapes(2, 20).items()}
            cache["k"][:, :, :12], cache["v"][:, :, :12] = pcache["k"], pcache["v"]
            toks, outs = [], []
            for pos in range(12, 20):
                tok = logits.argmax(-1, keepdim=True).to(torch.int32)
                toks.append(tok)
                logits, cache = model.decode_step(cache, tok, pos)
                outs.append(logits)
        runs.append((torch.cat(toks, 1).cpu(), torch.stack(outs).cpu()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1].view(torch.int32), runs[1][1].view(torch.int32))
    assert torch.isfinite(runs[0][1]).all()


@pytest.mark.cuda
def test_lm_example_on_card(card, capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_lm_embedding_retrieval", ROOT / "examples" / "torch_lm_embedding_retrieval.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = example.main(["--device", "cuda", "--windows", "1024"])
    assert out["exact"] and out["engine_backend"] == "cuda"
    assert "exact=True" in capsys.readouterr().out
