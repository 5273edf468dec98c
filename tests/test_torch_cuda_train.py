"""Two-tower training on the card: the reduced train step on the card
against the CPU port, two runs of the same steps bit-equal, crash and
resume bit-exact, and a checkpoint saved from the card restored onto the
CPU and onto the card bit for bit, bfloat16 leaves included.  The sharded
step of each family on mesh devices of the card, and the LM's compute
split over "model" (the collectives, the split step of every LM arch,
the expert-parallel MoE's routing) against one device on the card.

The file imports no jax; on the card it runs as

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_train.py
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import common
from repro_torch.configs.recsys_archs import TWO_TOWER
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import ClickStream, TokenStream
from repro_torch.kernels import _build
from repro_torch.models import recsys as R
from repro_torch.optim import adamw
from repro_torch.pytree import leaves, leaves_with_paths, tree_map
from repro_torch.train.loop import TrainLoop, TrainLoopConfig
from repro_torch.train.step import functional_loss, init_state, make_train_step, to_device

STEPS = 5
LR = 3e-3
# one step on the card and one on the CPU from the same state: the loss
# within 1e-5 relative (both IEEE float32, summed in another order); a
# parameter within 2 * lr (AdamW moves an element about lr a step, and one
# whose gradient is rounding noise may move the other way), and at most 1%
# of a leaf's elements more than 1e-5 apart
LOSS_REL = 1e-5


@pytest.fixture
def card():
    """The CUDA device, or a skip where no sm_90 card and nvcc are (as the
    other card test files: the port's card is the H100)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the port's card is sm_90")
    try:
        _build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc, as the other card test files")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().cpu()
    return t.view({2: torch.int16, 4: torch.int32, 1: torch.int8}[t.itemsize])


def _equal_trees(a, b) -> bool:
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y)) for (_, x), (_, y) in zip(la, lb))


def _reduced(dev):
    model, cfg, _ = get_arch("two-tower-retrieval").make_reduced()
    model.init_params(torch.Generator("cpu").manual_seed(0), device="cpu")
    return model, cfg, tree_map(lambda t: t.to(dev), model.param_tree())


def _run(dev, steps=STEPS, seed=0):
    model, cfg, params = _reduced(dev)
    step = make_train_step(functional_loss(model, common.loss_for("recsys", model)), adamw(lr=LR))
    state = init_state(params, adamw(lr=LR))
    stream = ClickStream(cfg, batch=64, seed=seed)
    losses = []
    for _ in range(steps):
        state, m = step(state, to_device(stream.next(), dev))
        losses.append(m["loss"])
    return state, torch.stack(losses).cpu()


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(card):
    """Along the CPU's five steps, each step also taken on the card from the
    same state."""
    model, cfg, params = _reduced(torch.device("cpu"))
    step = make_train_step(functional_loss(model, common.loss_for("recsys", model)), adamw(lr=LR))
    state = init_state(params, adamw(lr=LR))
    stream = ClickStream(cfg, batch=64, seed=0)
    for _ in range(STEPS):
        batch = stream.next()
        got, got_m = step(tree_map(lambda t: t.to(card), state), to_device(batch, card))
        state, m = step(state, to_device(batch, "cpu"))
        want = float(m["loss"])
        assert abs(float(got_m["loss"]) - want) <= LOSS_REL * abs(want)
        for a, b in zip(leaves(got["params"]), leaves(state["params"])):
            d = (a.cpu() - b).abs()
            assert float(d.max()) <= 2 * LR
            assert float((d > 1e-5).float().mean()) <= 0.01


@pytest.mark.cuda
def test_two_runs_on_card_are_bit_equal(card):
    a, la = _run(card)
    b, lb = _run(card)
    assert torch.equal(_bits(la), _bits(lb))
    assert _equal_trees(a, b)


def _loop(tmp_path, dev, total=12):
    model, cfg, _ = get_arch("two-tower-retrieval").make_reduced()
    loop = TrainLoop(functional_loss(model, common.loss_for("recsys", model)), adamw(lr=LR),
                     ClickStream(cfg, batch=64, seed=7),
                     TrainLoopConfig(total_steps=total, checkpoint_every=4,
                                     checkpoint_dir=str(tmp_path), log_every=100), device=dev)
    return model, loop


@pytest.mark.cuda
def test_crash_and_resume_on_card_is_bit_exact(card, tmp_path):
    def init(model):
        return lambda: model.init_params(torch.Generator(card).manual_seed(0),
                                         device=card).param_tree()

    model, a = _loop(tmp_path / "a", card)
    state_a = a.run(a.init_or_restore(init(model)))
    model, b = _loop(tmp_path / "b", card)
    with pytest.raises(RuntimeError, match="simulated crash"):
        b.run(b.init_or_restore(init(model)), crash_at=8)
    model, b2 = _loop(tmp_path / "b", card)
    state_b = b2.init_or_restore(init(model))
    assert int(state_b["step"]) == 8 and leaves(state_b)[0].is_cuda
    state_b = b2.run(state_b)
    assert _equal_trees(state_a, state_b)
    assert a.losses[8:] == b2.losses


@pytest.mark.cuda
def test_checkpoint_from_card_restores_on_cpu_and_card(card, tmp_path):
    """The full two-tower widths in bfloat16 (vocab 64), AdamW's state after
    one step on the card: saved, restored onto the CPU and onto the card."""
    cfg = dataclasses.replace(TWO_TOWER, vocab=64)
    model = R.TwoTowerModel(cfg).init_params(torch.Generator(card).manual_seed(0), device=card)
    step = make_train_step(functional_loss(model, model.loss_fn), adamw(lr=LR))
    state = init_state(model.param_tree(), adamw(lr=LR))
    state, _ = step(state, to_device(ClickStream(cfg, batch=32, seed=0).next(), card))
    assert state["params"]["user_w"][0].dtype == torch.bfloat16
    mgr = CheckpointManager(tmp_path / "c")
    mgr.save(1, state, extra={"note": "card"})
    on_cpu, extra = mgr.restore(state, device="cpu")
    on_card, _ = mgr.restore(state)
    assert extra == {"note": "card"}
    assert all(t.device.type == "cpu" for t in leaves(on_cpu))
    assert all(t.is_cuda for t in leaves(on_card))
    assert _equal_trees(on_cpu, state) and _equal_trees(on_card, state)


@pytest.mark.cuda
def test_async_save_is_not_reached_by_later_updates(card, tmp_path):
    """``save(blocking=False)`` copies every leaf to the host first: an
    in-place write on the card after ``save`` returns is not in the file."""
    mgr = CheckpointManager(tmp_path / "c")
    state = {"w": torch.arange(1 << 20, dtype=torch.float32, device=card)}
    want = state["w"].cpu().clone()
    mgr.save(1, state, blocking=False)
    state["w"].add_(1.0)
    mgr.wait()
    got, _ = mgr.restore({"w": torch.empty(1 << 20, device="meta")}, device="cpu")
    assert torch.equal(got["w"], want)
    assert np.isfinite(want.numpy()).all()


def _equal_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "two-tower-retrieval", "pna"])
@pytest.mark.parametrize("data,model_parallel", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_sharded_step_on_card_matches_the_one_device_step(card, arch, data,
                                                          model_parallel):
    """``parallel.sharded_step`` over ``make_local_mesh`` on the card (the
    mesh devices are ``cuda:0`` reused) against the one-device step on the
    card from the same state: bit for bit where one data shard computes it
    all (a data axis of 1 under ``"split"`` / ``"in_batch"``, the tables in
    "model" pieces on (1, 2)); within the training bound (loss 1e-5
    relative, a parameter within 2 * lr, at most 1% of a leaf beyond 1e-5)
    where rows are split, an LM's layers are split over "model" (the
    ``"model"`` plan) or PNA's nodes over every device (``"node"``, the
    molecules in the dst-partitioned layout)."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel.sharded_step import gather_state, plan_for, sharded_step_for

    bundle = get_arch(arch)
    model, cfg, batch_fn = bundle.make_reduced()
    model.init_params(torch.Generator(card).manual_seed(0), device=card)
    batch = batch_fn(torch.Generator(card).manual_seed(1)) if bundle.family == "lm" else (
        to_device(ClickStream(cfg, batch=64, seed=0).next(), card)
        if bundle.family == "recsys" else None)
    if batch is None:
        from repro_torch.launch.train import MoleculeStream

        model = type(model)(dataclasses.replace(cfg, graph_level=True))
        model.init_params(torch.Generator(card).manual_seed(0), device=card)
        batch = to_device(MoleculeStream(model.cfg.d_feat, model.cfg.n_classes, 16).next(),
                          card)
    opt = adamw(lr=LR)
    one = make_train_step(functional_loss(model, common.loss_for(bundle.family, model)), opt)
    mesh = make_local_mesh(model_parallel, n_devices=data * model_parallel)
    step = sharded_step_for(bundle.family, model, opt, mesh)
    clone = lambda: tree_map(lambda t: t.clone(), model.param_tree())  # noqa: E731
    want, wm = one(init_state(clone(), opt), batch)
    got, gm = step.step_(step.shard(init_state(clone(), opt)), batch)
    assert all(t.is_cuda for s in leaves(got) for _, _, t in s.local())
    whole = gather_state(got, card)
    rows = plan_for(bundle.family, model)["rows"]
    if rows in ("split", "in_batch") and data == 1:
        assert _equal_bits(gm["loss"], wm["loss"])
        assert all(_equal_bits(x, y) for x, y in zip(leaves(whole), leaves(want)))
        return
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= LOSS_REL * abs(float(wm["loss"]))
    for x, y in zip(leaves(whole["params"]), leaves(want["params"])):
        d = (x.float() - y.float()).abs()
        assert float(d.max()) <= 2 * LR and float((d > 1e-5).float().mean()) <= 0.01


def _split_model(arch: str, card, **changes):
    model, cfg, _ = get_arch(arch).make_reduced()
    model = type(model)(dataclasses.replace(cfg, vocab=256, seq_shard_activations=True,
                                            **changes))
    return model.init_params(torch.Generator(card).manual_seed(0), device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["model", "data"])
def test_collectives_on_card_are_ordered_sums_and_transposes(card, axis):
    """``parallel.collectives`` over a (2, 2) mesh of the card's devices:
    reduce-scatter and all-reduce give the float32 sum in member order
    bit for bit, all-gather the concatenation, and each backward its
    transpose."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import collectives as coll

    mesh = make_local_mesh(2, n_devices=4)
    gen = torch.Generator(card).manual_seed(0)
    xs = [torch.randn(3, 8, 5, generator=gen, device=card).to(torch.bfloat16)
          .requires_grad_(True) for _ in range(4)]
    out = coll.reduce_scatter(xs, mesh, axis, 1)
    up = [torch.randn(3, 4, 5, generator=gen, device=card).to(torch.bfloat16) for _ in range(4)]
    gx = torch.autograd.grad(out, xs, up)
    for g in coll.groups(mesh, axis):
        total = (xs[g[0]].float() + xs[g[1]].float()).to(torch.bfloat16)
        for a, i in enumerate(g):
            assert _equal_bits(out[i], total[:, 4 * a:4 * a + 4])
            assert _equal_bits(gx[i], torch.cat([up[q] for q in g], 1))
    red = coll.all_reduce([x.detach() for x in xs], mesh, axis)
    for g in coll.groups(mesh, axis):
        for i in g:
            assert _equal_bits(red[i], (xs[g[0]].float() + xs[g[1]].float()).to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)], ids=["1x2", "1x4", "2x2"])
@pytest.mark.parametrize("arch,changes", [
    ("llama3.2-1b", {}), ("gemma2-9b", {}),
    ("kimi-k2-1t-a32b", {"expert_axis": "model"}),
    ("phi3.5-moe-42b-a6.6b", {"expert_axis": "model"})], ids=["llama", "gemma2", "kimi", "phi"])
def test_model_split_on_card_matches_one_device(card, arch, changes, shape):
    """The ``"model"`` plan on the card (float32 reduced models, the
    vocabulary split, the residual stream sequence-sharded): the loss within
    1e-5 relative and each gradient leaf within 1e-4 of its largest of the
    one-device step on the card; the gradient twice bit for bit; no host
    sync under the audit's watch (RoPE's float64 angles are allowed)."""
    from repro_torch.analysis.audit import watch_call
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel.sharded_step import gather_state, sharded_step_for

    model = _split_model(arch, card, **changes)
    batch = to_device(TokenStream(vocab=256, batch=8, seq=16, seed=0).next(), card)
    one = make_train_step(functional_loss(model, model.loss_fn), adamw(lr=LR))
    loss, grads = one.grads(model.param_tree(), batch)
    step = sharded_step_for("lm", model, adamw(lr=LR),
                            make_local_mesh(shape[1], n_devices=shape[0] * shape[1]))
    state = step.shard(init_state(tree_map(lambda t: t.clone(), model.param_tree()),
                                  adamw(lr=LR)))
    step.grads(state, batch)  # RoPE's frequency table is made once per device
    with warnings.catch_warnings():
        # the first switch to sync debug mode in a process warns that the
        # mode is a prototype, which the watch would count as a sync
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)
    (l_sh, g_sh), problems = watch_call("split_grads", step.grads, state, batch)
    assert [p for p in problems if p.check != "f64"] == []  # no host sync
    l_again, g_again = step.grads(state, batch)
    assert _equal_bits(l_sh, l_again)
    assert abs(float(l_sh) - float(loss)) <= LOSS_REL * abs(float(loss))
    g_sh, g_again = gather_state(g_sh, card), gather_state(g_again, card)
    for k, g in grads.items():
        assert _equal_bits(g_sh[k], g_again[k]), k
        assert float((g_sh[k] - g).abs().max()) <= 1e-4 * float(g.abs().max()), k


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_expert_parallel_routing_on_card_equals_one_device(card, shape):
    """The reduced Phi's MoE block (bf16, a capacity that binds) expert-
    parallel over the card's mesh devices: expert ids, capacity, pairs kept
    and dropped per expert equal to one device's, the output bit for bit."""
    import pathlib
    import sys

    from repro_torch.launch.mesh import make_local_mesh

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    model = _split_model("phi3.5-moe-42b-a6.6b", card, expert_axis="model",
                         dtype=torch.bfloat16, moe_capacity_factor=0.5)
    tokens = torch.randint(0, 256, (4, 32), generator=torch.Generator(card).manual_seed(0),
                           device=card)
    got = chip_smoke.moe_split_against_one(
        torch, model, tokens, make_local_mesh(shape[1], n_devices=shape[0] * shape[1]))
    assert got["capacity_equal"] and got["ids_equal"] and got["loads_equal"]
    assert got["drops_equal"] and sum(got["drops"]) > 0
    assert got["out_bits_equal"], got


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("arch,changes", [
    ("wide-deep", dict(vocab=65_536, n_sparse=4, embed_dim=8)), ("din", dict(vocab=65_536)),
    ("two-tower-retrieval", {}), ("dlrm-rm2", {})], ids=["wide-deep", "din", "two-tower", "dlrm"])
def test_split_tables_on_card_match_one_device(card, arch, changes, shape):
    """The ``"split"`` / ``"in_batch"`` plans with every table the specs
    split over "model" in its pieces on the card (float32 reduced models;
    DIN's and Wide&Deep's single tables at 65,536 rows, where they split):
    each lookup on each mesh device equal to the one-device lookup of its
    rows bit for bit, the loss within 1e-5 relative and each gradient leaf
    within 1e-4 of its largest (a leaf whose one-device gradient lies
    further than that from a float64 copy's, DIN's last attention bias
    whose exact gradient is 0, within 1e-4 of the tree's largest:
    ``tests/test_torch_row_split.py``), every gradient in pieces, the
    step's gradient twice bit for bit."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel.sharded_step import gather_state, sharded_step_for
    from repro_torch.parallel.sharding import Placement, ShardedTensor

    model, cfg, _ = get_arch(arch).make_reduced()
    model = type(model)(dataclasses.replace(cfg, **changes))
    model.init_params(torch.Generator(card).manual_seed(0), device=card)
    batch = to_device(ClickStream(model.cfg, batch=64, seed=0).next(), card)
    mesh = make_local_mesh(shape[1], n_devices=shape[0] * shape[1])
    specs = model.param_specs(mesh)
    placed = tree_map(lambda s, t: ShardedTensor.place(t, Placement(mesh, s)), specs,
                      model.param_tree())
    params = [tree_map(lambda st: st.gather_region(st.model_region(i), d), placed)
              for i, d in enumerate(mesh.devices)]
    step_rows = -(-64 // shape[0])
    shards = [{k: v[s * step_rows:(s + 1) * step_rows] for k, v in batch.items()}
              for s in range(shape[0])]
    got = model.split_lookups(params, shards, mesh, specs)
    for name, (key, ids) in model._lookup_ids().items():
        table = getattr(model, key).detach()
        for r, rows in enumerate(got[name]):
            i = ids(shards[r // shape[1]])
            want = R.embedding_lookup(table, i) if table.ndim == 3 else table[i.long()]
            assert _equal_bits(rows, want), (name, r)
    one = make_train_step(functional_loss(model, common.loss_for("recsys", model)), adamw(lr=LR))
    loss, grads = one.grads(model.param_tree(), batch)
    m64 = R.cast_model(model, torch.float64, card)
    _, g64 = make_train_step(functional_loss(m64, common.loss_for("recsys", m64)),
                             adamw(lr=LR)).grads(m64.param_tree(), batch)
    step = sharded_step_for("recsys", model, adamw(lr=LR), mesh)
    state = step.shard(init_state(tree_map(lambda t: t.clone(), model.param_tree()),
                                  adamw(lr=LR)))
    l_sh, g_sh = step.grads(state, batch)
    l_again, g_again = step.grads(state, batch)
    assert _equal_bits(l_sh, l_again)
    assert all(isinstance(g, ShardedTensor) for g in leaves(g_sh))
    assert abs(float(l_sh) - float(loss)) <= LOSS_REL * abs(float(loss))
    g_sh, g_again = gather_state(g_sh, card), gather_state(g_again, card)
    tree_top = max(float(g.abs().max()) for g in leaves(grads))
    for (path, g), (_, x), (_, y), r in zip(leaves_with_paths(grads), leaves_with_paths(g_sh),
                                            leaves_with_paths(g_again), leaves(g64)):
        assert _equal_bits(x, y), path
        gap = float((x - g).abs().max())
        if gap <= 1e-4 * float(g.abs().max()):
            continue
        noise = float((g.double() - r).abs().max()) > 1e-4 * float(r.abs().max())
        assert noise and gap <= 1e-4 * tree_top, path
