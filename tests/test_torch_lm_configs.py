"""The port's LM configs and bundles (``repro_torch.configs.lm_archs``,
``common.lm_cells`` / ``lm_reduced``, the registry, the arch files) against
the JAX package's, on the CPU; the full configs' parameter trees as
``meta`` tensors (nothing allocated); the knobs that need a mesh, and the
training launcher, raising with the ROADMAP item that ports them."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as jarchs
from repro.configs.registry import registry as jax_registry
from repro_torch.configs import common, lm_archs
from repro_torch.configs.registry import all_cells, get_arch, registry
from repro_torch.models.params import load_jax_params
from repro_torch.models.transformer import LMConfig, LMModel

from torch_lm_common import LM_ARCHS

FULL = {"phi3.5-moe-42b-a6.6b": "PHI35_MOE", "kimi-k2-1t-a32b": "KIMI_K2",
        "gemma2-9b": "GEMMA2_9B", "deepseek-coder-33b": "DEEPSEEK_CODER_33B",
        "llama3.2-1b": "LLAMA32_1B"}


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg) | {"dtype": None}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_bundle_matches_jax(arch):
    """Config, family and cells: kinds, skips, notes and input specs."""
    b, jb = registry()[arch], jax_registry()[arch]
    assert b.family == jb.family == "lm" and b.name == jb.name == arch
    assert _fields(b.cfg) == _fields(jb.cfg)
    assert b.cfg.dtype == torch.bfloat16 and jb.cfg.dtype == jnp.bfloat16
    assert b.cfg is getattr(lm_archs, FULL[arch]) and _fields(b.cfg) == _fields(
        getattr(jarchs, FULL[arch]))
    assert list(b.cells) == list(jb.cells) == list(common.LM_SHAPES)
    for name, cell in b.cells.items():
        jcell = jb.cells[name]
        assert (cell.kind, cell.skip, cell.note) == (jcell.kind, jcell.skip, jcell.note)
        got, want = cell.inputs(), jcell.inputs()
        assert list(got) == list(want)
        for key, spec in got.items():
            assert spec.shape == want[key].shape
            assert spec.dtype == torch.int32 and want[key].dtype == jnp.int32
    assert common.SKIP_PURE_FULL_ATTENTION == b.cells["long_500k"].skip or arch == "gemma2-9b"


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_reduced_lm_bundles_match_jax(arch):
    (_, jcfg, jbatch), (tm, tcfg, batch_fn) = (jax_registry()[arch].make_reduced(),
                                               registry()[arch].make_reduced())
    assert _fields(tcfg) == _fields(jcfg)
    assert tcfg.dtype == torch.float32 and jcfg.dtype == jnp.float32
    assert (tcfg.n_layers, tcfg.d_model, tcfg.vocab) == (2, 32, 211)
    assert isinstance(tm, LMModel) and tm.cfg is tcfg
    batch = batch_fn(torch.Generator().manual_seed(0))
    want = jbatch(jax.random.PRNGKey(0))
    assert list(batch) == list(want) == ["tokens"]
    t = batch["tokens"]
    assert tuple(t.shape) == want["tokens"].shape == (2, 33) and t.dtype == torch.int32
    assert 0 <= int(t.min()) and int(t.max()) < tcfg.vocab
    assert torch.equal(t, batch_fn(torch.Generator().manual_seed(0))["tokens"])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_full_param_trees_match_jax_unallocated(arch):
    """The full configs: ``abstract_params`` (shapes, dtypes, names, order),
    ``n_params`` and ``n_active_params`` equal JAX's; every parameter is a
    ``meta`` tensor until placed."""
    jm, tm = jax_registry()[arch].model, registry()[arch].model
    want, got = jm.abstract_params(), tm.abstract_params()
    assert list(got) == list(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape and t.device.type == "meta"
        assert str(t.dtype).replace("torch.", "") == str(want[name].dtype)
    assert all(p.device.type == "meta" for p in tm.parameters())
    assert tm.cfg.n_params() == jm.cfg.n_params()
    assert tm.cfg.n_active_params() == jm.cfg.n_active_params()
    assert tm.param_bytes() == sum(int(np.prod(s.shape)) * s.dtype.itemsize
                                   for s in want.values())
    if arch == "llama3.2-1b":
        assert tm.cfg.n_params() == 1_498_480_640


def test_all_cells_cover_lm_and_recsys():
    """20 LM cells of JAX's 40 (the GNN's 4 and the recsys' 16 with them)."""
    cells = all_cells()
    lm = [(a, c) for a, c in cells if registry()[a].family == "lm"]
    assert len(lm) == 20 and len(cells) == 40
    assert {a for a, _ in lm} == set(LM_ARCHS)
    skips = sorted(a for a, c in lm if registry()[a].cells[c].skip is not None)
    assert skips == ["deepseek-coder-33b", "kimi-k2-1t-a32b", "llama3.2-1b",
                     "phi3.5-moe-42b-a6.6b"]


def test_arch_files_expose_their_lm_bundle():
    from repro_torch.configs import (deepseek_coder_33b, gemma2_9b, kimi_k2, llama3_2_1b,
                                     phi3_5_moe)

    for mod in (phi3_5_moe, kimi_k2, gemma2_9b, deepseek_coder_33b, llama3_2_1b):
        assert mod.BUNDLE.name == mod.ARCH_ID and mod.CONFIG is mod.BUNDLE.cfg
        assert mod.BUNDLE.family == "lm" and get_arch(mod.ARCH_ID).cfg == mod.CONFIG


def test_init_params_draws_the_reference_distribution():
    """Norms zero; every other leaf normal over sqrt(fan_in), fan_in =
    ``shape[-2]`` (``vocab`` for the embedding), reproducible from the
    generator's seed, on the device asked for."""
    cfg = dataclasses.replace(lm_archs.GEMMA2_9B, n_layers=2, d_model=64, n_heads=4,
                              n_kv_heads=2, head_dim=32, d_ff=256, vocab=4096)
    m = LMModel(cfg).init_params(torch.Generator().manual_seed(0), device="cpu")
    again = LMModel(cfg).init_params(torch.Generator().manual_seed(0), device="cpu")
    for (name, _, (shape, dt)), p, q in zip(m._leaves(), m.parameters(), again.parameters()):
        assert p.device.type == "cpu" and p.dtype == dt and tuple(p.shape) == shape
        assert torch.equal(p, q)
        if "norm" in name:
            assert dt == torch.float32 and not p.any()
        else:
            std = float(p.detach().float().std()) * np.sqrt(shape[-2])
            assert abs(std - 1.0) < 0.05, (name, std)


def test_load_jax_params_refuses_a_wrong_tree():
    jm, _, _ = jax_registry()["llama3.2-1b"].make_reduced()
    tm, tcfg, _ = registry()["llama3.2-1b"].make_reduced()
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match=r"embed: .*float32.*bfloat16"):
        load_jax_params(LMModel(dataclasses.replace(tcfg, dtype=torch.bfloat16)), params,
                        device="cpu")
    params["wq"] = params["wq"][:1]
    with pytest.raises(ValueError, match=r"wq: "):
        load_jax_params(tm, params, device="cpu")


def test_mesh_knobs_raise_with_their_item():
    """The reduced Kimi's parameter and KV-cache specs and Llama's
    ``train_4k`` partition equal JAX's on the three meshes of
    ``torch_sharding_common``; ``batch_axes`` leaves the logits' bits as
    they are, and inside a sharded step its spec must name the active
    mesh's axes (the name is kept from when the port raised here)."""
    from repro_torch.launch.simdevices import simulated_mesh
    from repro_torch.parallel.sharding import active_mesh
    from torch_sharding_common import MESHES, meshes, spec_tuples

    tm, cfg, batch_fn = registry()["kimi-k2-1t-a32b"].make_reduced()
    jm, _, _ = jax_registry()["kimi-k2-1t-a32b"].make_reduced()
    for names, shape in MESHES:
        jmesh, tmesh = meshes(names, shape)
        assert spec_tuples(tm.param_specs(tmesh)) == spec_tuples(jm.param_specs(jmesh))
        for b in (1, 32):
            assert spec_tuples(tm.cache_specs(tmesh, b)) == spec_tuples(jm.cache_specs(jmesh, b))
        assert spec_tuples(registry()["llama3.2-1b"].cells["train_4k"].partition(tmesh)) == \
            spec_tuples(jax_registry()["llama3.2-1b"].cells["train_4k"].input_partition(jmesh))
    tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    sharded = LMModel(dataclasses.replace(cfg, batch_axes=("data",))).load_param_tree(
        tm.param_tree())
    tokens = batch_fn(torch.Generator().manual_seed(1))["tokens"][:, :8]
    want = tm.forward(tokens)
    assert torch.equal(sharded.forward(tokens), want)
    with active_mesh(simulated_mesh(2)):
        assert torch.equal(sharded.forward(tokens), want)
    with active_mesh(simulated_mesh(2, axis_names=("pod",))), \
            pytest.raises(ValueError, match="lacks"):
        sharded.forward(tokens)


def test_expert_axis_changes_nothing_on_one_card():
    """``expert_axis="model"`` (the full Phi and Kimi configs) constrains
    nothing without a mesh: the same logits as without it."""
    tm, cfg, batch_fn = registry()["phi3.5-moe-42b-a6.6b"].make_reduced()
    tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    other = LMModel(dataclasses.replace(cfg, expert_axis="model")).load_param_tree(
        tm.param_tree())
    toks = batch_fn(torch.Generator().manual_seed(1))["tokens"][:, :16]
    with torch.no_grad():
        assert torch.equal(tm.forward(toks), other.forward(toks))


def test_train_launcher_raises_for_the_lm_family(tmp_path, capsys):
    """Both names the launcher refused before now train: one step of each
    reduced config on the CPU, a finite loss printed, and no family left
    in ``NOT_TRAINED``."""
    from repro_torch.launch.train import NOT_TRAINED, main

    assert NOT_TRAINED == {}
    for arch in ("llama3.2-1b", "pna"):
        main(["--arch", arch, "--reduced", "--steps", "1", "--device", "cpu",
              "--checkpoint-dir", str(tmp_path / arch)])
        out = capsys.readouterr().out
        assert "done: final loss" in out and "nan" not in out, out


def test_lm_config_defaults_match_jax():
    from repro.models.transformer import LMConfig as JLMConfig

    small = dict(name="t", n_layers=1, d_model=8, n_heads=2, n_kv_heads=1, d_ff=16, vocab=5)
    got, want = LMConfig(**small), JLMConfig(**small)
    assert _fields(got) == _fields(want) and got.dh == want.dh == 4
    assert got.dtype == torch.bfloat16 and not got.is_moe
