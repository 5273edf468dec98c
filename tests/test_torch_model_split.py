"""The LM's compute split over a mesh's "model" axis
(``parallel.collectives``, ``LMModel.split_loss`` / ``split_forward``,
``layers.moe_block_split``, the sharded step's ``"model"`` plan) on
simulated CPU meshes, against the one-device port in float32.  The file
imports no jax (the reference's partitioned step is held in
``tests/test_torch_train.py``); ~10 s serial.

Tolerances: the collectives' values and transposes exactly (a fixed-order
float32 sum is its own reference); logits within 1e-5 of the largest
|logit|, the loss within 1e-5 relative, each gradient leaf within 1e-4 of
its largest |value| (the split sums partial products in another order);
the MoE's routing (expert ids, capacity, pairs kept and dropped per
expert) exactly.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import registry
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch.simdevices import simulated_mesh
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharded_step import gather_state, plan_for, sharded_step_for
from repro_torch.parallel.sharding import Placement, ShardedTensor
from repro_torch.pytree import tree_map
from repro_torch.train.step import functional_loss, init_state, to_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = [(1, 2), (1, 4), (2, 2)]
LOGIT_REL = 1e-5
LOSS_REL = 1e-5
GRAD_REL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return simulated_mesh(shape[0] * shape[1], shape, ("data", "model"))


# ------------------------------------------------------------ collectives

def _xs(mesh, shape, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(dtype) for _ in range(mesh.n_devices)]


def _ordered_sum(parts, dtype):
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    return acc.to(dtype)


@pytest.mark.parametrize("axis", ["model", "data", ("data", "model")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_collectives_values_and_transposes(axis, dtype):
    """On a (2, 2) mesh over each axis: all-gather concatenates the group
    in member order, reduce-scatter gives member a piece a of the group's
    float32 sum in member order (cast once), all-reduce that sum; each
    one's backward is its transpose on the upstream gradients (all-gather
    <-> reduce-scatter, all-reduce <-> all-reduce), bit for bit, and a
    second run gives the same bits."""
    mesh = _mesh((2, 2))
    groups = coll.groups(mesh, axis)
    assert sorted(i for g in groups for i in g) == list(range(4))
    for _ in range(2):
        xs = [x.requires_grad_(True) for x in _xs(mesh, (3, 4, 5), dtype)]
        up = _xs(mesh, (3, 4 * len(groups[0]), 5), dtype, seed=1)
        out = coll.all_gather(xs, mesh, axis, 1)
        gx = torch.autograd.grad(out, xs, up)
        for g in groups:
            for a, i in enumerate(g):
                assert torch.equal(out[i], torch.cat([xs[q] for q in g], 1))
                lo, hi = coll.piece_bounds(4 * len(g), len(g), a)
                assert torch.equal(gx[i], _ordered_sum([up[q][:, lo:hi] for q in g], dtype))

        xs = [x.detach().requires_grad_(True) for x in _xs(mesh, (3, 8, 5), dtype, seed=2)]
        k = len(groups[0])
        up = _xs(mesh, (3, 8 // k, 5), dtype, seed=3)
        out = coll.reduce_scatter(xs, mesh, axis, 1)
        gx = torch.autograd.grad(out, xs, up)
        for g in groups:
            for a, i in enumerate(g):
                lo, hi = coll.piece_bounds(8, k, a)
                assert torch.equal(out[i], _ordered_sum([xs[q][:, lo:hi] for q in g], dtype))
                assert torch.equal(gx[i], torch.cat([up[q] for q in g], 1))

        xs = [x.detach().requires_grad_(True) for x in _xs(mesh, (6, 5), dtype, seed=4)]
        up = _xs(mesh, (6, 5), dtype, seed=5)
        out = coll.all_reduce(xs, mesh, axis)
        gx = torch.autograd.grad(out, xs, up)
        top = coll.all_reduce_max(xs, mesh, axis)
        for g in groups:
            for i in g:
                assert torch.equal(out[i], _ordered_sum([xs[q] for q in g], dtype))
                assert torch.equal(gx[i], _ordered_sum([up[q] for q in g], dtype))
                assert torch.equal(top[i], torch.stack([xs[q] for q in g]).amax(0))


def test_collectives_tally_one_device_ring_bytes():
    """``tally`` counts what one device moves, ring-reckoned, in the forward
    and again in the backward pass."""
    mesh = _mesh((1, 4))
    xs = [x.requires_grad_(True) for x in _xs(mesh, (2, 8))]
    with coll.tally() as moved:
        out = coll.reduce_scatter(xs, mesh, "model", 1)
        forward = dict(moved)
        torch.autograd.grad(out, xs, [torch.ones_like(o) for o in out])
    whole = 2 * 8 * 4
    assert forward == {"reduce-scatter": whole * 3 / 4}
    assert moved == {"reduce-scatter": whole * 3 / 4, "all-gather": whole * 3 / 4}


# ------------------------------------------------------------- the model

# (arch, config changes): vocabularies the model axis divides (256) run the
# vocab-parallel embedding and loss; 211 leaves them whole on every shard
CASES = {
    "llama-seq": ("llama3.2-1b", dict(vocab=256, seq_shard_activations=True, remat=True)),
    "llama-whole-vocab": ("llama3.2-1b", dict(seq_shard_activations=False)),
    "gemma2": ("gemma2-9b", dict(vocab=256, seq_shard_activations=True)),
    "kimi-kv-head-split-inside-a-head": (
        "kimi-k2-1t-a32b", dict(vocab=256, seq_shard_activations=True, expert_axis="model")),
    "phi-ep": ("phi3.5-moe-42b-a6.6b",
               dict(vocab=256, seq_shard_activations=True, expert_axis="model")),
    "phi-ep-replicated-stream": ("phi3.5-moe-42b-a6.6b", dict(expert_axis="model",
                                                              seq_shard_activations=False)),
}


def _model(case):
    arch, changes = CASES[case]
    model, cfg, _ = registry()[arch].make_reduced()
    model = type(model)(dataclasses.replace(cfg, **changes))
    return model.init_params(torch.Generator().manual_seed(0), device="cpu")


def _batch(model, rows=8, seq=16):
    return to_device(TokenStream(vocab=model.cfg.vocab, batch=rows, seq=seq, seed=0).next(),
                     "cpu")


def _rank_params(model, mesh):
    """Each mesh device's tree: its "model" pieces, whole over the data axes."""
    specs = model.param_specs(mesh)
    placed = {k: ShardedTensor.place(t, Placement(mesh, specs[k]))
              for k, t in model.param_tree().items()}
    return [{k: st.gather_region(st.model_region(i), dev) for k, st in placed.items()}
            for i, dev in enumerate(mesh.devices)], specs


def _rows(tokens, d):
    step = -(-tokens.shape[0] // d)
    return [tokens[s * step:(s + 1) * step] for s in range(d)]


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "1x4", "2x2"])
@pytest.mark.parametrize("case", list(CASES))
def test_model_split_matches_one_device(case, shape):
    """The split forward's logits, the sharded step's loss and gradients
    (the ``"model"`` plan: ``split_loss``, the gradient pieces summed over
    the devices that hold them) against the one-device port's
    ``forward``, ``loss_fn`` and autograd gradients, float32."""
    model = _model(case)
    mesh = _mesh(shape)
    c = model.cfg
    if case.startswith("kimi") and shape[1] == 4:
        # the case the name says: 4 columns of K a shard, a head is 8
        assert c.n_kv_heads * c.dh // 4 < c.dh
    batch = _batch(model)
    params, specs = _rank_params(model, mesh)
    with torch.no_grad():
        want = model.forward(batch["tokens"][:, :-1])
        got = model.split_forward(params, _rows(batch["tokens"][:, :-1], shape[0]), mesh, specs)
    m = shape[1]
    whole = torch.cat([torch.cat(got[s * m:(s + 1) * m], -1) if c.vocab % m == 0
                       else got[s * m] for s in range(shape[0])])
    assert float((whole - want).abs().max()) <= LOGIT_REL * float(want.abs().max())

    p0 = model.param_tree()
    live = [p.detach().requires_grad_(True) for p in p0.values()]
    loss = functional_loss(model, model.loss_fn)(dict(zip(p0, live)), batch)
    grads = dict(zip(p0, torch.autograd.grad(loss, live)))
    step = sharded_step_for("lm", model, adamw(), mesh)
    state = step.shard(init_state(tree_map(lambda t: t.clone(), p0), adamw()))
    l_sh, g_sh = step.grads(state, batch)
    assert abs(float(l_sh) - float(loss.detach())) <= LOSS_REL * abs(float(loss.detach()))
    g_sh = gather_state(g_sh, "cpu")
    for k, g in grads.items():
        assert float((g_sh[k] - g).abs().max()) <= GRAD_REL * float(g.abs().max()), k


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "1x4", "2x2"])
@pytest.mark.parametrize("case", ["phi-ep", "kimi-kv-head-split-inside-a-head",
                                  "phi-ep-replicated-stream"])
def test_moe_routing_equals_one_device(case, shape):
    """``moe_block_split`` on a microbatch split as the step splits it:
    the expert ids, the capacity and the pairs kept and dropped per expert
    equal ``moe_block``'s, and the output matches bit for bit (each
    expert's product runs whole on one device)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    model = _model(case)
    # a capacity factor of 0.5 binds (the reduced configs' 1.25 rounds up
    # to every token here), so the drops are part of the check
    model = type(model)(dataclasses.replace(model.cfg, moe_capacity_factor=0.5)
                        ).load_param_tree(model.param_tree())
    tokens = _batch(model, rows=4, seq=32)["tokens"][:, :-1]
    got = chip_smoke.moe_split_against_one(torch, model, tokens, _mesh(shape))
    assert got["capacity_equal"] and got["ids_equal"]
    assert got["loads_equal"] and got["drops_equal"]
    assert sum(got["drops"]) > 0
    assert got["out_bits_equal"], got


def test_lm_plan_splits_compute_and_never_gathers_a_model_leaf_whole():
    """Every LM, dense or MoE, runs the ``"model"`` plan; on (1, 4) each
    mesh device computes with its quarter of each leaf the specs split
    over "model" (and the whole of the rest), never the whole model: the
    bytes each device gathers for compute, against the whole."""
    for case in ("llama-seq", "phi-ep"):
        model = _model(case)
        assert plan_for("lm", model)["rows"] == "model"
        mesh = _mesh((1, 4))
        specs = model.param_specs(mesh)
        step = sharded_step_for("lm", model, adamw(), mesh)
        state = step.shard(init_state(model.param_tree(), adamw()))
        step.grads(state, _batch(model))
        whole = {k: t.numel() * t.element_size() for k, t in model.param_tree().items()}
        split = {k for k, s in specs.items() if "model" in s.names()}
        assert {"wq", "wo", "unembed", "embed"} <= split
        want = sum(n // 4 if k in split else n for k, n in whole.items())
        assert step.compute_bytes == [want] * 4
        assert want < sum(whole.values())


def test_more_data_shards_than_rows():
    """A microbatch of 2 rows over 4 data shards: the last two hold no rows
    and add nothing (their pieces of the loss are skipped)."""
    model = _model("llama-seq")
    batch = _batch(model, rows=2)
    p0 = model.param_tree()
    live = [p.detach().requires_grad_(True) for p in p0.values()]
    loss = functional_loss(model, model.loss_fn)(dict(zip(p0, live)), batch)
    step = sharded_step_for("lm", model, adamw(), _mesh((4, 2)))
    l_sh, g_sh = step.grads(step.shard(init_state(p0, adamw())), batch)
    assert abs(float(l_sh) - float(loss.detach())) <= LOSS_REL * abs(float(loss.detach()))
    assert all(np.isfinite(float(g.abs().max())) for g in gather_state(g_sh, "cpu").values())


def test_split_step_makes_no_host_sync():
    """The expert-parallel Phi's model-split gradients on (2, 2) under the
    audit's dispatch watch, after one step has made RoPE's frequency table
    (once per device, as on one device): no operator that waits for the
    host (the float64 of RoPE's angles is the one-device forward's own)."""
    from repro_torch.analysis.audit import watch_call

    model = _model("phi-ep")
    step = sharded_step_for("lm", model, adamw(), _mesh((2, 2)))
    state = step.shard(init_state(model.param_tree(), adamw()))
    batch = _batch(model)
    step.grads(state, batch)
    _, problems = watch_call("split_grads", step.grads, state, batch)
    assert [p for p in problems if p.check != "f64"] == []
