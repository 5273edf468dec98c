"""The GNN family of the port (``repro_torch.models.gnn``,
``repro_torch.configs.pna``) against the JAX package's, on the CPU.

The reduced PNA (2 layers, 16 wide, float32) holds JAX's own parameters
(``load_jax_params``) and takes the same numpy batches.  Both run IEEE
float32 and sum in another order, so:

  * forwards (flat and dst-partitioned layouts) within 1e-5 (rtol and atol,
    ``tests/test_arch_smoke.py:95``'s bound for the two layouts);
  * the loss within 1e-5 relative; every gradient leaf within 1e-4 of the
    leaf's largest |gradient| (as the LM's: ``tests/test_torch_lm_train.py``);
  * 5 AdamW steps: losses within 1e-5 relative, parameters within 2·lr a
    step, at most 1% of a leaf more than 1e-5 off (PR 23's bounds);
  * ``partition_edges`` bit for bit.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import pna as jpna
from repro.configs.registry import all_cells as jax_all_cells
from repro.configs.registry import registry as jax_registry
from repro.models.gnn import PNAConfig as JPNAConfig
from repro.models.gnn import PNAModel as JPNAModel
from repro.optim import adamw as j_adamw
from repro.train.step import init_state as j_init_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import common, pna
from repro_torch.configs.registry import all_cells, get_arch, registry
from repro_torch.data.pipeline import batched_molecules
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import make_stream, train_model
from repro_torch.models import gnn
from repro_torch.models.gnn import PNAConfig, PNAModel
from repro_torch.models.params import load_jax_params
from repro_torch.optim import adamw
from repro_torch.pytree import leaves, leaves_with_paths
from repro_torch.train.step import functional_loss, init_state, make_train_step, to_device

TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_REL = 1e-5
GRAD_REL = 1e-4
LR = 3e-3
SMALL = dict(name="t", n_layers=2, d_hidden=16, d_feat=8, n_classes=3)
DTYPES = {jnp.int32: torch.int32, jnp.bool_: torch.bool, jnp.float32: torch.float32}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**kw):
    """(JAX model, JAX params, port model holding them on the CPU)."""
    cfg = {**SMALL, **kw}
    jm, tm = JPNAModel(JPNAConfig(**cfg)), PNAModel(PNAConfig(**cfg))
    params = jm.init_params(jax.random.PRNGKey(0))
    load_jax_params(tm, jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


def _node_batch(seed: int, n: int = 64, e: int = 300, f: int = 8, classes: int = 3,
                n_live: int | None = None) -> dict:
    """A node-classification batch: edges among the first ``n_live`` nodes
    (the rest are padding of degree 0), a mask over 70% of the nodes."""
    rng = np.random.default_rng(seed)
    n_live = n if n_live is None else n_live
    return {
        "x": rng.normal(size=(n, f)).astype(np.float32),
        "edge_src": rng.integers(0, n_live, e).astype(np.int32),
        "edge_dst": rng.integers(0, n_live, e).astype(np.int32),
        "labels": rng.integers(0, classes, n).astype(np.int32),
        "label_mask": (rng.random(n) < 0.7).astype(np.float32),
    }


def _graph_batch(seed: int, n_pad: int = 96, f: int = 8, classes: int = 3) -> dict:
    """8 molecules of 10 nodes (``batched_molecules``), padded to ``n_pad``
    nodes whose ``graph_id`` lies outside [0, 8) (dropped by the readout)."""
    b = batched_molecules(np.random.default_rng(seed), 8, 10, 20, f, classes)
    pad = n_pad - b["x"].shape[0]
    b["x"] = np.concatenate([b["x"], np.zeros((pad, f), np.float32)])
    b["graph_id"] = np.concatenate([b["graph_id"], np.full(pad, 8, np.int32)])
    return b


def _partitioned(batch: dict, s_blocks: int = 8, e_loc: int | None = None) -> dict:
    out = {k: v for k, v in batch.items() if k not in ("edge_src", "edge_dst")}
    ps, pd, pv = JPNAModel.partition_edges(batch["edge_src"], batch["edge_dst"],
                                           batch["x"].shape[0], s_blocks, e_loc)
    out.update(edge_src=ps, edge_dst_local=pd, edge_valid=pv)
    return out


def _jax(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b: dict) -> dict:
    return to_device(b, "cpu")


def _grads(tm, batch: dict):
    step = make_train_step(functional_loss(tm, tm.loss_fn), optimizer=None)
    return step.grads(tm.param_tree(), _torch(batch))


def _check_grads(tm, jm, params, batch, grad_rel: float = GRAD_REL) -> None:
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(params, _jax(batch))
    loss, grads = _grads(tm, batch)
    assert abs(float(loss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    for g, w in zip(leaves(grads), jax.tree.leaves(jgrads)):
        w = np.asarray(w)
        assert bool(torch.isfinite(g).all()) and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=grad_rel * max(float(np.abs(w).max()), 1e-30))


# ------------------------------------------------------------------ model

def test_param_shapes_and_init_match_jax():
    """The four cell heads and the base: the reference's tree (names, shapes,
    dtypes); ``init_params`` draws zeros for ``b_*`` and normal /
    sqrt(fan-in) otherwise, reproducible from the generator's seed."""
    jb, tb = jax_registry()["pna"], registry()["pna"]
    for name in [None, *common.GNN_SHAPES]:
        jm = jb.model if name is None else jb.model_for(name)
        tm = tb.model if name is None else tb.model_for(name)
        want = jm.abstract_params()
        got = tm.abstract_params()
        assert list(got) == list(want)
        for k, t in got.items():
            assert tuple(t.shape) == want[k].shape and t.device.type == "meta"
            assert DTYPES[want[k].dtype.type] == t.dtype
        assert dataclasses.asdict(tm.cfg) | {"dtype": None} == \
            dataclasses.asdict(jm.cfg) | {"dtype": None}
    m = PNAModel(dataclasses.replace(pna.BASE, d_hidden=64)).init_params(
        torch.Generator().manual_seed(0), device="cpu")
    again = PNAModel(m.cfg).init_params(torch.Generator().manual_seed(0), device="cpu")
    for name, p in m.param_tree().items():
        assert torch.equal(p, again.param_tree()[name])
        if name.startswith("b_"):
            assert not p.any()
        else:
            std = float(p.std()) * np.sqrt(p.shape[-2])
            assert abs(std - 1.0) < 0.05, (name, std)


@pytest.mark.parametrize("layout", ["flat", "partitioned"])
@pytest.mark.parametrize("graph_level", [False, True], ids=["nodes", "graphs"])
def test_forward_matches_jax(layout, graph_level):
    jm, params, tm = _pair(graph_level=graph_level)
    batch = _graph_batch(1) if graph_level else _node_batch(1, n_live=54)
    if layout == "partitioned":
        batch = _partitioned(batch)
    want = np.asarray(jm.forward(params, _jax(batch)))
    with torch.no_grad():
        got = tm.forward(_torch(batch))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_layouts_agree():
    """``tests/test_arch_smoke.py``'s layout check in the port: the flat edge
    list and its dst-partitioned packing give the same logits within 1e-5."""
    _, _, tm = _pair()
    batch = _node_batch(2)
    with torch.no_grad():
        flat = tm.forward(_torch(batch))
        part = tm.forward(_torch(_partitioned(batch)))
    np.testing.assert_allclose(flat.numpy(), part.numpy(), **TOL)


@pytest.mark.parametrize("e_loc", [None, 24, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_partition_edges_bit_equal(seed, e_loc):
    """The port's copy of the host converter gives the reference's arrays bit
    for bit, overflow past ``e_loc`` dropped included."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, 256, 900), rng.integers(0, 256, 900)
    got = PNAModel.partition_edges(src, dst, 256, 8, e_loc)
    want = JPNAModel.partition_edges(src, dst, 256, 8, e_loc)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["flat-masked", "flat-unmasked", "partitioned-masked",
                                  "graphs-flat", "graphs-partitioned"])
def test_loss_and_grads_match_jax(case):
    graph_level = case.startswith("graphs")
    jm, params, tm = _pair(graph_level=graph_level)
    batch = _graph_batch(3) if graph_level else _node_batch(3, n_live=54)
    if case == "flat-unmasked":
        del batch["label_mask"]
    if "partitioned" in case:
        batch = _partitioned(batch)
    _check_grads(tm, jm, params, batch)


def test_empty_segments_and_degree_0_and_1_nodes():
    """Isolated nodes (empty segments: max / min fill 0), degree-1 nodes
    (variance exactly 0, where ``maximum(var, 0)`` ties and passes half the
    gradient in both packages): finite forward, gradients as JAX's.

    The gradients are held within 1e-3 of a leaf's largest, not 1e-4: at a
    node of degree 2 or 3 whose messages nearly agree, ``var = sq / cnt -
    mean²`` cancels (a few-ulp difference of ``m`` between the packages'
    matmuls becomes a large share of ``var``), and the std's backward
    multiplies it by 0.5 / sqrt(var + 1e-6), up to 500 (read: 1.09e-4)."""
    jm, params, tm = _pair()
    n = 32
    src = np.array([1, 2, 3, 4, 5, 6, 6, 7, 7, 7, 0, 9], np.int32)
    dst = np.array([0, 0, 1, 2, 3, 4, 4, 5, 5, 5, 6, 8], np.int32)
    rng = np.random.default_rng(4)
    batch = {"x": rng.normal(size=(n, 8)).astype(np.float32), "edge_src": src,
             "edge_dst": dst, "labels": rng.integers(0, 3, n).astype(np.int32),
             "label_mask": np.ones(n, np.float32)}
    deg = np.bincount(dst, minlength=n)
    assert (deg == 0).sum() > 10 and (deg == 1).sum() >= 4
    with torch.no_grad():
        got = tm.forward(_torch(batch))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.forward(params, _jax(batch))), **TOL)
    _check_grads(tm, jm, params, batch, grad_rel=1e-3)
    _check_grads(tm, jm, params, _partitioned(batch, s_blocks=4), grad_rel=1e-3)


def test_segment_ops_match_jax():
    """``segment_sum`` / ``max`` / ``min``: JAX's values (ids out of range
    dropped, empty segments at 0 / -inf / +inf) and gradients (a tie at
    the max shares the gradient evenly)."""
    rng = np.random.default_rng(5)
    vals = rng.normal(size=(40, 3)).astype(np.float32)
    vals[7] = vals[3]  # a tie in segment 2
    ids = rng.integers(0, 9, 40).astype(np.int32)
    ids[[3, 7]] = 2
    ids[[0, 1]] = [-1, 12]  # dropped
    n = 10
    for tfn, jfn in ((gnn.segment_sum, jax.ops.segment_sum),
                     (gnn.segment_max, jax.ops.segment_max),
                     (gnn.segment_min, jax.ops.segment_min)):
        want = np.asarray(jfn(jnp.asarray(vals), jnp.asarray(ids), num_segments=n))
        t = torch.tensor(vals, requires_grad=True)
        got = tfn(t, torch.as_tensor(ids), n)
        np.testing.assert_array_equal(np.isfinite(got.detach().numpy()), np.isfinite(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got.detach().numpy()[fin], want[fin], rtol=1e-6, atol=1e-6)
        w = rng.normal(size=want.shape).astype(np.float32)
        jg = jax.grad(lambda v: jnp.sum(jnp.where(jnp.isfinite(jfn(
            v, jnp.asarray(ids), num_segments=n)), jfn(v, jnp.asarray(ids), num_segments=n),
            0.0) * w))(jnp.asarray(vals))
        tg, = torch.autograd.grad(torch.sum(torch.where(torch.isfinite(got), got, 0.0)
                                            * torch.as_tensor(w)), t)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)


def test_train_steps_match_jax():
    """5 AdamW steps of the reduced PNA on the same numpy batches."""
    jm, params, tm = _pair()
    jopt, topt = j_adamw(lr=LR), adamw(lr=LR)
    jstep = jax.jit(j_make_train_step(jm.loss_fn, jopt))
    tstep = make_train_step(functional_loss(tm, common.loss_for("gnn", tm)), topt)
    js, ts = j_init_state(params, jopt), init_state(tm.param_tree(), topt)
    for i in range(5):
        b = _node_batch(10 + i)
        js, jmet = jstep(js, _jax(b))
        ts, tmet = tstep(ts, _torch(b))
        want = float(jmet["loss"])
        assert abs(float(tmet["loss"]) - want) <= LOSS_REL * abs(want)
    for got, want in zip(leaves(ts["params"]), jax.tree.leaves(js["params"])):
        d = np.abs(got.numpy() - np.asarray(want))
        assert d.max() <= 2 * LR * 5 and (d > 1e-5).mean() <= 0.01


# ---------------------------------------------------------------- configs

def test_reduced_config_and_batch():
    """The reduced config is the reference's; its batch is drawn from a
    ``torch.Generator`` with the reference's keys, shapes and dtypes."""
    (_, jcfg, jfn), (tm, tcfg, tfn) = jpna._make_reduced(), pna._make_reduced()
    assert dataclasses.asdict(tcfg) | {"dtype": None} == dataclasses.asdict(jcfg) | {"dtype": None}
    want = jfn(jax.random.PRNGKey(0))
    got = tfn(torch.Generator().manual_seed(0))
    assert list(got) == list(want)
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape
        assert t.dtype == {"int32": torch.int32, "float32": torch.float32}[str(want[k].dtype)]
    tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert torch.isfinite(tm.loss_fn(got))


def test_gnn_cells_match_jax():
    """The four cells' dst-partitioned input specs, kinds and notes equal
    JAX's in shape and dtype, and each cell's partition equals JAX's on the
    three meshes of ``torch_sharding_common``."""
    from torch_sharding_common import MESHES, meshes, spec_tuples

    jb, tb = jax_registry()["pna"], get_arch("pna")
    assert tb.family == jb.family == "gnn" and list(tb.cells) == list(jb.cells)
    assert common.GNN_EDGE_BLOCKS == 512
    for name, cell in tb.cells.items():
        jcell = jb.cells[name]
        assert (cell.kind, cell.note, cell.skip) == (jcell.kind, jcell.note, jcell.skip)
        want, got = jcell.inputs(), cell.inputs()
        assert list(got) == list(want)
        for key, spec in got.items():
            assert spec.shape == want[key].shape
            assert spec.dtype == DTYPES[want[key].dtype.type]
        for names, shape in MESHES:
            jmesh, tmesh = meshes(names, shape)
            assert spec_tuples(cell.partition(tmesh)) == spec_tuples(
                jcell.input_partition(jmesh))
    assert tb.cells["minibatch_lg"].inputs()["x"].shape == (169_984, 602)


def test_all_cells_equal_jax():
    assert all_cells() == jax_all_cells() and len(all_cells()) == 40


def test_sharding_knobs_raise_with_their_item():
    """``param_specs`` equals JAX's (replicated); a config with
    ``batch_axes`` gives the same logits bit for bit, and inside a sharded
    step its row spec must name the active mesh's axes (the name is kept
    from when the port raised here)."""
    from repro_torch.launch.simdevices import simulated_mesh
    from repro_torch.parallel.sharding import active_mesh
    from torch_sharding_common import MESHES, meshes, spec_tuples

    jm, _, tm = _pair()
    for names, shape in MESHES:
        jmesh, tmesh = meshes(names, shape)
        assert spec_tuples(tm.param_specs(tmesh)) == spec_tuples(jm.param_specs(jmesh))
    sharded = PNAModel(dataclasses.replace(tm.cfg, batch_axes=("data",))).load_param_tree(
        tm.param_tree())
    batch = _torch(_node_batch(0))
    want = tm.forward(batch)
    assert torch.equal(sharded.forward(batch), want)
    with active_mesh(simulated_mesh(2)):
        assert torch.equal(sharded.forward(batch), want)
    with active_mesh(simulated_mesh(2, axis_names=("pod",))), \
            pytest.raises(ValueError, match="lacks"):
        sharded.forward(batch)


# --------------------------------------------------- checkpoints, launcher

def _pna_states():
    jm, params, tm = _pair(graph_level=True)
    jstate = j_init_state(params, j_adamw())
    jstate["opt"]["m"] = jax.tree.map(lambda p: p + 0.5, jstate["opt"]["m"])
    jstate["step"] = jnp.int32(3)
    return jstate, init_state(tm.param_tree(), adamw()), tm


def test_jax_pna_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    jstate, tstate, _ = _pna_states()
    JCheckpointManager(tmp_path / "c").save(3, jstate, extra={"stream": {"step": 3}})
    got, extra = CheckpointManager(tmp_path / "c").restore(tstate, device="cpu")
    assert extra == {"stream": {"step": 3}}
    jflat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    tflat = leaves_with_paths(got)
    assert len(jflat) == len(tflat)
    for (_, want), (_, have) in zip(jflat, tflat):
        np.testing.assert_array_equal(have.numpy(), np.asarray(want))
    assert int(got["step"]) == 3


def test_port_pna_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    jstate, tstate, tm = _pna_states()
    step = make_train_step(functional_loss(tm, tm.loss_fn), adamw())
    stream = make_stream("gnn", tm, tm.cfg, reduced=True)
    for _ in range(2):
        tstate, _ = step(tstate, to_device(stream.next(), "cpu"))
    CheckpointManager(tmp_path / "c").save(2, tstate, extra={"stream": stream.state()})
    got, extra = JCheckpointManager(tmp_path / "c").restore(jstate)
    assert extra == {"stream": {"step": 2}}
    for have, (_, want) in zip(jax.tree.leaves(got), leaves_with_paths(tstate)):
        np.testing.assert_array_equal(np.asarray(have), want.numpy())


def test_molecule_stream_trains_the_graph_level_head():
    """The launcher's GNN stream holds 8 graph labels a batch, so it trains
    the graph-level head (reduced and full); its loss pairs one logit row
    with each graph."""
    bundle = get_arch("pna")
    full, _ = train_model(bundle, reduced=False)
    assert full.cfg == bundle.model_for("molecule").cfg and full.cfg.graph_level
    model, cfg = train_model(bundle, reduced=True)
    assert cfg.graph_level and cfg.d_feat == 8 and cfg.n_classes == 3
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    stream = make_stream("gnn", model, cfg, reduced=True)
    batch = to_device(stream.next(), "cpu")
    with torch.no_grad():
        assert model.forward(batch).shape == (8, 3)
        assert torch.isfinite(model.loss_fn(batch))
    assert stream.state() == {"step": 1}


def test_pna_launcher_trains_reduced_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch pna --reduced --device
    cpu``: finite, falling losses over 20 steps and a checkpoint."""
    train_main(["--arch", "pna", "--reduced", "--steps", "20", "--checkpoint-every", "10",
                "--device", "cpu", "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0]) for line in out.splitlines()
              if "loss=" in line]
    assert len(losses) == 2 and all(np.isfinite(losses)) and losses[1] < losses[0], out
    assert (tmp_path / "step_000000020").is_dir()
