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

Last, the in-place ``apply_`` against the functional ``apply`` (every
optimizer, with and without compression, bit for bit), the sharded train
step of each family on simulated meshes against the one-device step, the
reference's four-device step mirrored, the port's sharded step held to the
reference's own jit step on its simulated 4-device mesh (a subprocess,
~40 s: the reduced Llama and the expert-parallel Phi split over "model"),
and the launcher over a mesh (these ~60 s of the file's time).
"""

from __future__ import annotations

import dataclasses

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
from repro_torch.optim import adafactor, adamw, make_optimizer
from repro_torch.pytree import leaves, tree_map
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


# ------------------------------------------------ in place and sharded

def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return a.contiguous().numpy().tobytes() == b.contiguous().numpy().tobytes()


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


@pytest.mark.parametrize("compression", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("opt_kind", ["adamw", "adafactor", "adafactor-dense"])
def test_in_place_apply_equals_the_functional_one(opt_kind, compression, monkeypatch):
    """``apply_`` (the loop's, in place) against ``apply`` (the reference's
    functional update) over three steps of the reduced Kimi (stacked MoE
    leaves of 8 layers scanned slice by slice, bf16 and float32 leaves;
    AdamW's leaves updated 1,000 elements at a time): parameters, moments,
    residual and counts bit for bit, and ``apply_`` writes into the tensors
    it was given."""
    from repro_torch.optim import optimizers

    monkeypatch.setattr(optimizers, "CHUNK", 1000)
    model, cfg, batch_fn = registry()["kimi-k2-1t-a32b"].make_reduced()
    model = type(model)(dataclasses.replace(cfg, n_layers=8, dtype=torch.bfloat16))
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    opt = {"adamw": adamw(lr=LR), "adafactor": adafactor(lr=LR),
           "adafactor-dense": adafactor(lr=LR, scan_leading_dim=False)}[opt_kind]
    step = make_train_step(functional_loss(model, model.loss_fn), opt,
                           compression=compression)
    a = init_state(_clone(model.param_tree()), opt, compression)
    b = init_state(_clone(model.param_tree()), opt, compression)
    held = leaves(b)
    for i in range(3):
        _, grads = step.grads(a["params"], batch_fn(torch.Generator().manual_seed(i)))
        a = step.apply(a, grads)
        assert step.apply_(b, grads) is b
    assert all(x is y for x, y in zip(leaves(b), held))
    assert int(b["step"]) == 3
    for x, y in zip(leaves(a), leaves(b)):
        assert _bits_equal(x, y)


# reduced configs of every family and their row plans
SHARDED_ARCHS = ["llama3.2-1b", "phi3.5-moe-42b-a6.6b", "two-tower-retrieval", "dlrm-rm2",
                 "pna"]
SHARDED_MESHES = [((2,), ("data",)), ((2, 2), ("data", "model")),
                  ((1, 2), ("data", "model"))]


def _family_batch(bundle, model):
    cfg = model.cfg
    if bundle.family == "lm":
        from repro_torch.data.pipeline import TokenStream

        return to_device(TokenStream(vocab=cfg.vocab, batch=8, seq=16, seed=0).next(), "cpu")
    if bundle.family == "recsys":
        return to_device(ClickStream(cfg, batch=16, seed=0).next(), "cpu")
    from repro_torch.data.pipeline import batched_molecules
    from repro_torch.models.gnn import PNAModel

    # the dst-partitioned layout the node plan splits: 80 nodes in 8 blocks
    flat = batched_molecules(np.random.default_rng(0), 8, 10, 20, cfg.d_feat, cfg.n_classes)
    src, dstl, valid = PNAModel.partition_edges(flat["edge_src"], flat["edge_dst"], 80, 8)
    part = {k: v for k, v in flat.items() if k not in ("edge_src", "edge_dst")}
    part.update(edge_src=src, edge_dst_local=dstl, edge_valid=valid)
    return to_device(part, "cpu")


@pytest.mark.parametrize("shape,names", SHARDED_MESHES, ids=["2", "2x2", "1x2"])
@pytest.mark.parametrize("arch", SHARDED_ARCHS)
def test_sharded_step_matches_the_one_device_step(arch, shape, names):
    """Two steps of ``parallel.sharded_step`` on a simulated mesh against
    the one-device step from the same state: bit for bit in loss,
    parameters and moments where one data shard computes it all (data axes
    of 1 under the ``"split"`` and ``"in_batch"`` plans, the tables split
    over ``"model"`` on (1, 2): each row has one owner and the replicated
    weights' other copies add nothing); loss within 1e-5 relative and each
    parameter within 2 * lr a step, at most 1% of a leaf beyond 1e-5, where
    rows are split, an LM's layers are split over ``"model"`` or PNA's
    nodes over every device (the ``"model"`` and ``"node"`` plans sum
    partial products in another order)."""
    from repro_torch.launch.simdevices import simulated_mesh
    from repro_torch.parallel.sharded_step import gather_state, plan_for, sharded_step_for

    bundle = registry()[arch]
    model, cfg, _ = bundle.make_reduced()
    if bundle.family == "gnn":
        model = type(model)(dataclasses.replace(cfg, graph_level=True))
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = _family_batch(bundle, model)
    opt = adamw(lr=LR)
    one = make_train_step(functional_loss(model, common.loss_for(bundle.family, model)), opt)
    mesh = simulated_mesh(int(np.prod(shape)), shape, names)
    step = sharded_step_for(bundle.family, model, opt, mesh)
    want = init_state(_clone(model.param_tree()), opt)
    got = step.shard(init_state(_clone(model.param_tree()), opt))
    rows = plan_for(bundle.family, model)["rows"]
    exact = rows in ("split", "in_batch") and mesh.size("data") == 1
    for i in range(2):
        want, wm = one(want, batch)
        got, gm = step.step_(got, batch)
        whole = gather_state(got, "cpu")
        if exact:
            assert _bits_equal(gm["loss"], wm["loss"])
            for x, y in zip(leaves(whole), leaves(want)):
                assert _bits_equal(x, y)
            continue
        assert abs(float(gm["loss"]) - float(wm["loss"])) <= LOSS_REL * abs(float(wm["loss"]))
        for x, y in zip(leaves(whole["params"]), leaves(want["params"])):
            d = (x.float() - y.float()).abs()
            assert float(d.max()) <= 2 * LR * (i + 1)
            assert float((d > 1e-5).float().mean()) <= 0.01


def test_the_reference_four_device_step_mirrored():
    """``tests/test_multidevice.py``'s step: the reduced Llama with
    ``batch_axes=("data",)`` on a (4,) mesh, parameters replicated
    (``P()``), the batch replicated (``P(None, None)``): a finite loss, the
    one-device step's bits."""
    from repro_torch.launch.simdevices import simulated_mesh
    from repro_torch.parallel.sharded_step import gather_state, make_sharded_train_step
    from repro_torch.parallel.sharding import P

    model, cfg, batch_fn = registry()["llama3.2-1b"].make_reduced()
    model = type(model)(dataclasses.replace(cfg, batch_axes=("data",)))
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = batch_fn(torch.Generator().manual_seed(1))
    opt = adamw(lr=1e-3)
    loss_fn = functional_loss(model, common.loss_for("lm", model))
    specs = tree_map(lambda _: P(), model.param_tree())
    step = make_sharded_train_step(loss_fn, opt, simulated_mesh(4), specs,
                                   {"tokens": P(None, None)})
    state, metrics = step.step_(step.shard(init_state(_clone(model.param_tree()), opt)), batch)
    assert np.isfinite(float(metrics["loss"]))
    want, wm = make_train_step(loss_fn, opt)(init_state(_clone(model.param_tree()), opt), batch)
    assert _bits_equal(metrics["loss"], wm["loss"])
    for x, y in zip(leaves(gather_state(state, "cpu")), leaves(want)):
        assert _bits_equal(x, y)


# the reference's sharded step on its simulated 4-device host mesh: the
# reduced Llama (batch_axes=("data",)) on (4,) with everything replicated,
# as tests/test_multidevice.py runs it, and on (2, 2) and (1, 4) with the
# model's param_specs and the batch's rows over "data"; the reduced Phi with
# expert_axis="model" on (2, 2) and (1, 4) likewise; each writes the loss,
# the gradients (jit of jax.grad over the same sharded inputs) and the new
# parameters of one AdamW step
_SHARDED_CASES = (
    ("llama3.2-1b", {}, (("4", (4,), ("data",)), ("2x2", (2, 2), ("data", "model")),
                         ("1x4", (1, 4), ("data", "model")))),
    ("phi3.5-moe-42b-a6.6b", {"expert_axis": "model"},
     (("2x2", (2, 2), ("data", "model")), ("1x4", (1, 4), ("data", "model")))),
)
_JAX_SHARDED_STEP = """
    import dataclasses
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import common
    from repro.configs.registry import registry
    from repro.optim import adamw
    from repro.train.step import init_state, make_train_step

    out = {}
    for arch, changes, cases in %r:
        model, cfg, batch_fn = registry()[arch].make_reduced()
        model = type(model)(dataclasses.replace(cfg, batch_axes=("data",), **changes))
        params = model.init_params(jax.random.PRNGKey(0))
        batch = batch_fn(jax.random.PRNGKey(1))
        loss_fn = common.loss_for("lm", model)
        out[arch + "/tokens"] = np.asarray(batch["tokens"])
        out.update({arch + "/init/" + k: np.asarray(v) for k, v in params.items()})
        for name, shape, axes in cases:
            # Mesh, not make_mesh: newer jax makes explicit-axis meshes,
            # whose row-split gather needs an out_sharding the reference
            # never gives
            mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), axes)
            if name == "4":
                specs, bspec = {k: P() for k in params}, P(None, None)
            else:
                specs, bspec = model.param_specs(mesh), P("data", None)
            with mesh:
                p = jax.device_put(params, {k: NamedSharding(mesh, s)
                                            for k, s in specs.items()})
                b = jax.device_put(batch, {"tokens": NamedSharding(mesh, bspec)})
                grads = jax.jit(jax.grad(loss_fn))(p, b)
                step = jax.jit(make_train_step(loss_fn, adamw(lr=1e-3)), donate_argnums=(0,))
                state, metrics = step(init_state(p, adamw(lr=1e-3)), b)
            key = arch + "/" + name
            out[key + "/loss"] = np.asarray(metrics["loss"])
            out.update({key + "/grad/" + k: np.asarray(v) for k, v in grads.items()})
            out.update({key + "/param/" + k: np.asarray(v) for k, v in state["params"].items()})
%s
    np.savez(sys.argv[1], **out)
    print("JAX_SHARDED_OK")
"""

# the reduced PNA (node level, the dst-partitioned layout: 64 nodes in 8
# blocks, nodes and blocks over every axis, batch_axes ("data", "model"),
# as the GNN cells' partition lays them out) and the reduced DLRM (vocab
# 1,000, so that "model" divides its tables' rows; rows over "data") on
# (2, 2) with their param_specs, in the same subprocess; the leaves keyed
# by their paths ("bot_w/0")
_ROW_CASES = (("pna", "gnn"), ("dlrm-rm2", "recsys"))
_JAX_ROW_SPLIT = """
    from jax.tree_util import tree_flatten_with_path
    from repro.models.gnn import PNAModel

    def named(tree):
        flat, _ = tree_flatten_with_path(tree)
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                np.asarray(v) for path, v in flat}

    mesh = Mesh(np.array(jax.devices()[:4]).reshape((2, 2)), ("data", "model"))
    rng = np.random.default_rng(3)
    for arch, family in %r:
        model, cfg, batch_fn = registry()[arch].make_reduced()
        if family == "gnn":
            model = type(model)(dataclasses.replace(cfg, batch_axes=("data", "model")))
            n, e = 64, 256
            src, dstl, valid = PNAModel.partition_edges(rng.integers(0, n, e),
                                                        rng.integers(0, n, e), n, 8)
            batch = {"x": rng.normal(size=(n, cfg.d_feat)).astype(np.float32),
                     "edge_src": src, "edge_dst_local": dstl, "edge_valid": valid,
                     "labels": rng.integers(0, cfg.n_classes, n).astype(np.int32),
                     "label_mask": (rng.random(n) < 0.75).astype(np.float32)}
            rows = ("data", "model")
        else:
            model = type(model)(dataclasses.replace(cfg, vocab=1000, batch_axes=("data",)))
            batch = {k: np.asarray(v) for k, v in batch_fn(jax.random.PRNGKey(1)).items()}
            rows = "data"
        bspec = {k: P(rows, *([None] * (v.ndim - 1))) for k, v in batch.items()}
        params = model.init_params(jax.random.PRNGKey(0))
        loss_fn = common.loss_for(family, model)
        out.update({arch + "/batch/" + k: v for k, v in batch.items()})
        out.update({arch + "/init/" + k: v for k, v in named(params).items()})
        specs = model.param_specs(mesh)
        with mesh:
            p = jax.device_put(params, jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                                    is_leaf=lambda x: isinstance(x, P)))
            b = jax.device_put(batch, {k: NamedSharding(mesh, s) for k, s in bspec.items()})
            grads = jax.jit(jax.grad(loss_fn))(p, b)
            step = jax.jit(make_train_step(loss_fn, adamw(lr=1e-3)), donate_argnums=(0,))
            state, metrics = step(init_state(p, adamw(lr=1e-3)), b)
        key = arch + "/2x2"
        out[key + "/loss"] = np.asarray(metrics["loss"])
        out.update({key + "/grad/" + k: v for k, v in named(grads).items()})
        out.update({key + "/param/" + k: v for k, v in named(state["params"]).items()})
""" % (_ROW_CASES,)
_JAX_SHARDED_STEP = _JAX_SHARDED_STEP % (_SHARDED_CASES, _JAX_ROW_SPLIT)


def _unflat(ref: dict, prefix: str) -> dict:
    """The tree under ``prefix`` of the reference's path-keyed arrays."""
    out: dict = {}
    for k, v in ref.items():
        if not k.startswith(prefix):
            continue
        name, *index = k[len(prefix):].split("/")
        if index:
            lst = out.setdefault(name, [])
            lst.extend([None] * (int(index[0]) + 1 - len(lst)))
            lst[int(index[0])] = v
        else:
            out[name] = v
    return out


def _held_to_reference(loss, grads, params, ref: dict, key: str) -> list:
    """What a port step's loss, gradients (whole) and new parameters miss of
    the reference's: the loss within 1e-5 relative, each gradient leaf
    within 1e-4 of its largest |value|, each new parameter within 2 lr, at
    most 1% of a leaf beyond 1e-5."""
    from repro_torch.pytree import leaves_with_paths, path_key

    out = []
    want = float(ref[key + "/loss"])
    if abs(float(loss) - want) > LOSS_REL * abs(want):
        out.append((key, "loss"))
    for p, g in leaves_with_paths(grads):
        jg = torch.from_numpy(ref[f"{key}/grad/{path_key(p)}"])
        if float((g - jg).abs().max()) > 1e-4 * float(jg.abs().max()):
            out.append((key, "grad", path_key(p)))
    for p, x in leaves_with_paths(params):
        d = (x - torch.from_numpy(ref[f"{key}/param/{path_key(p)}"])).abs()
        if float(d.max()) > 2 * 1e-3 or float((d > 1e-5).float().mean()) > 0.01:
            out.append((key, "param", path_key(p)))
    return out


def test_sharded_step_holds_to_the_reference_four_device_step(tmp_path):
    """The port's sharded step against the reference's jit step on its
    simulated 4-device mesh (one subprocess, ~40 s), over JAX's own
    parameters and batch: the reduced Llama on (4,), everything replicated
    (the reference's ``tests/test_multidevice.py``), and on (2, 2) and
    (1, 4) with ``param_specs`` and the rows split over ``"data"``; the
    reduced Phi with ``expert_axis="model"`` on (2, 2) and (1, 4).  On the
    (data, model) meshes the port runs its ``"model"`` plan (the layers
    split over "model", the MoE expert-parallel with its capacity over the
    whole batch), as GSPMD partitions the reference's.  The loss within
    1e-5 relative, each gradient leaf within 1e-4 of its largest |value|,
    each new parameter within 2 lr, at most 1% of a leaf beyond 1e-5.  A
    copy of one gradient with 0.1% more on the piece one shard holds (the
    piece with the leaf's largest value) must fail those checks.  Then, on
    (2, 2), the reduced PNA in the dst-partitioned layout under the
    ``"node"`` plan (the nodes and blocks over every device, the halo
    all-gathered a layer) and the reduced DLRM (vocab 1,000) under the
    ``"split"`` plan with its tables in their "model" pieces, as GSPMD
    partitions the reference's, within the same bounds."""
    from multidevice_shim import run_simulated_mesh

    from repro_torch.launch.simdevices import simulated_mesh
    from repro_torch.models.params import load_jax_params
    from repro_torch.parallel.sharded_step import (
        gather_state,
        make_sharded_train_step,
        plan_for,
    )
    from repro_torch.parallel.sharding import P, ShardedTensor

    path = tmp_path / "jax_sharded.npz"
    run = run_simulated_mesh(_JAX_SHARDED_STEP, 4, str(path))
    assert "JAX_SHARDED_OK" in run.stdout, run.stdout + "\n" + run.stderr
    ref = dict(np.load(path))
    opt = adamw(lr=1e-3)
    mutated = 0
    for arch, changes, cases in _SHARDED_CASES:
        model, cfg, _ = registry()[arch].make_reduced()
        model = type(model)(dataclasses.replace(cfg, batch_axes=("data",), **changes))
        init = f"{arch}/init/"
        load_jax_params(model, {k[len(init):]: v for k, v in ref.items() if k.startswith(init)},
                        device="cpu")
        batch = {"tokens": torch.from_numpy(ref[arch + "/tokens"]).long()}
        loss_fn = functional_loss(model, common.loss_for("lm", model))
        for name, shape, axes in cases:
            mesh = simulated_mesh(4, shape, axes)
            if name == "4":
                step = make_sharded_train_step(
                    loss_fn, opt, mesh, tree_map(lambda _: P(), model.param_tree()),
                    {"tokens": P(None, None)})
            else:
                step = make_sharded_train_step(loss_fn, opt, mesh, model.param_specs(mesh),
                                               {"tokens": P("data", None)},
                                               **plan_for("lm", model))
                assert step.rows == "model"
            state = step.shard(init_state(_clone(model.param_tree()), opt))
            loss, grads = step.grads(state, batch)
            whole = gather_state(grads, "cpu")
            if name != "4" and not mutated:
                # the mutated copy: one shard's piece of wq's gradient off by 0.1%
                g = grads["wq"]
                top = max(g.pieces, key=lambda pc: float(next(iter(
                    g.pieces[pc].values())).abs().max()))
                bad = ShardedTensor(g.placement, g.shape, g.dtype, {
                    pc: {d: t * (1.001 if pc == top else 1.0) for d, t in by.items()}
                    for pc, by in g.pieces.items()})
                off = dict(whole, wq=bad.gather("cpu"))
                assert ((f"{arch}/{name}", "grad", "wq")
                        in _held_to_reference(loss, off, {}, ref, f"{arch}/{name}"))
                mutated += 1
            params = gather_state(step.apply_(state, grads), "cpu")["params"]
            assert _held_to_reference(loss, whole, params, ref, f"{arch}/{name}") == []
    assert mutated == 1
    mesh = simulated_mesh(4, (2, 2), ("data", "model"))
    for arch, family in _ROW_CASES:
        model, cfg, _ = registry()[arch].make_reduced()
        changes = ({"batch_axes": ("data", "model")} if family == "gnn"
                   else {"vocab": 1000, "batch_axes": ("data",)})
        model = type(model)(dataclasses.replace(cfg, **changes))
        load_jax_params(model, _unflat(ref, f"{arch}/init/"), device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in _unflat(ref, f"{arch}/batch/").items()}
        step = make_sharded_train_step(functional_loss(model, common.loss_for(family, model)),
                                       opt, mesh, model.param_specs(mesh), None,
                                       **plan_for(family, model))
        assert step.rows == {"gnn": "node", "recsys": "split"}[family]
        state = step.shard(init_state(_clone(model.param_tree()), opt))
        loss, grads = step.grads(state, batch)
        assert all(isinstance(g, ShardedTensor) for g in leaves(grads))
        whole = gather_state(grads, "cpu")
        params = gather_state(step.apply_(state, grads), "cpu")["params"]
        assert _held_to_reference(loss, whole, params, ref, f"{arch}/2x2") == []


def test_launcher_trains_over_a_mesh_and_resumes_under_another(tmp_path, capsys):
    """``launch.train --mesh 2x2`` on CPU devices checkpoints every step;
    a second run under ``--mesh 4x1`` resumes from its last checkpoint."""
    from repro_torch.launch.train import main as train_main

    args = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--checkpoint-every",
            "1", "--checkpoint-dir", str(tmp_path)]
    train_main(args + ["--steps", "2", "--mesh", "2x2"])
    assert "on a 2x2 mesh of cpu devices" in capsys.readouterr().out
    train_main(args + ["--steps", "3", "--mesh", "4x1"])
    out = capsys.readouterr().out
    assert "[restore] resumed from step 2" in out and "over 1 steps" in out


@pytest.mark.parametrize("opt_kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_sharded_step_with_microbatches_and_compression(opt_kind, shape):
    """The reduced Llama (float32) with 2 microbatches and int8
    compression, AdamW or Adafactor (whose leaves are gathered onto the
    lead device for their whole-dim means), two steps under the model
    split, within the bounds of the test above on (1, 2) and (2, 2)."""
    from repro_torch.launch.simdevices import simulated_mesh
    from repro_torch.parallel.sharded_step import gather_state, sharded_step_for

    model, _, _ = registry()["llama3.2-1b"].make_reduced()
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = _family_batch(registry()["llama3.2-1b"], model)
    opt = adamw(lr=LR) if opt_kind == "adamw" else adafactor(lr=LR)
    one = make_train_step(functional_loss(model, model.loss_fn), opt, microbatches=2,
                          compression=True)
    mesh = simulated_mesh(shape[0] * shape[1], shape, ("data", "model"))
    step = sharded_step_for("lm", model, opt, mesh, microbatches=2, compression=True)
    want = init_state(_clone(model.param_tree()), opt, compression=True)
    got = step.shard(init_state(_clone(model.param_tree()), opt, compression=True))
    for i in range(2):
        want, wm = one(want, batch)
        got, gm = step.step_(got, batch)
    whole = gather_state(got, "cpu")
    assert sorted(whole) == sorted(want) == ["opt", "params", "residual", "step"]
    assert int(whole["step"]) == int(want["step"]) == 2
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= LOSS_REL * abs(float(wm["loss"]))
    for x, y in zip(leaves(whole["params"]), leaves(want["params"])):
        d = (x.float() - y.float()).abs()
        assert float(d.max()) <= 2 * LR * 2 and float((d > 1e-5).float().mean()) <= 0.01
