"""Shared cases of the LM model tests (``tests/test_torch_lm_models.py``,
``tests/test_torch_lm_bf16.py``): the reduced LM configs built in both
packages over JAX's own parameters, seed-made tokens, and the decode loop."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import registry as jax_registry
from repro_torch.configs.registry import registry
from repro_torch.models.params import load_jax_params

LM_ARCHS = ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "gemma2-9b",
            "deepseek-coder-33b", "llama3.2-1b"]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def jax_params(arch: str, dt: str):
    """JAX's reduced model of ``arch`` in dtype ``dt`` and its parameters
    (``init_params(PRNGKey(0))``), as JAX arrays and as numpy arrays."""
    jm, jcfg, _ = jax_registry()[arch].make_reduced()
    jm = type(jm)(dataclasses.replace(jcfg, dtype=DTYPES[dt][0]))
    params = jm.init_params(jax.random.PRNGKey(0))
    return jm, params, jax.tree.map(np.asarray, params)


def pair(arch: str, dt: str = "f32", **changes):
    """(JAX model, JAX params, port model holding the same parameters on
    the CPU), both over the reduced config with ``changes``."""
    jm, params, host = jax_params(arch, dt)
    if changes:
        jm = type(jm)(dataclasses.replace(jm.cfg, **changes))
    tm, tcfg, _ = registry()[arch].make_reduced()
    tm = type(tm)(dataclasses.replace(tcfg, dtype=DTYPES[dt][1], **changes))
    load_jax_params(tm, host, device="cpu")
    return jm, params, tm


def tokens(vocab: int, seed: int, b: int = 2, s: int = 16) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def decode_both(jm, params, tm, toks: np.ndarray, max_seq: int):
    """Greedy-free decode of ``toks`` one token a step from empty caches in
    both packages; returns the per-step logits and the final caches."""
    b, steps = toks.shape
    jc = {k: jnp.zeros(s.shape, s.dtype) for k, s in jm.init_cache_shapes(b, max_seq).items()}
    tc = {k: torch.zeros(s.shape, dtype=s.dtype)
          for k, s in tm.init_cache_shapes(b, max_seq).items()}
    assert {k: (tuple(s.shape), str(s.dtype)) for k, s in jc.items()} == \
        {k: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for k, t in tc.items()}
    jl, tl = [], []
    with torch.no_grad():
        for i in range(steps):
            a, jc = jm.decode_step(params, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
            t, tc = tm.decode_step(tc, torch.as_tensor(toks[:, i:i + 1]), i)
            jl.append(a)
            tl.append(t)
    return jl, tl, jc, tc
