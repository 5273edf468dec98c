"""PNA's message passing over node shards and the recsys tables' lookups
over their "model" rows (``PNAModel.split_loss``, the recsys models'
``split_loss`` and ``split_lookups``, the sharded step's ``"node"``,
``"split"`` and ``"in_batch"`` plans) on simulated CPU meshes, against the
one-device port.  The file imports no jax (the reference's partitioned
step is held in ``tests/test_torch_train.py``); ~15 s serial.

Tolerances: lookups bit for bit (a planted ``-0.0`` row included); logits
within 1e-5 of the largest |logit|, the loss within 1e-5 relative, each
gradient leaf within 1e-4 of its largest |value| (the split sums partial
products in another order; PNA's gradient on a float64 copy, where its
float32 one is ill-conditioned: PERF.md §2).  A recsys leaf whose exact
gradient is 0 (DIN's last attention bias: a softmax does not move when
every logit moves alike) is rounding noise on one device too: where the
one-device float32 leaf lies more than 1e-4 from the float64 copy's, the
split's leaf is held within 1e-4 of the largest |value| of the whole
gradient tree instead.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.configs import common
from repro_torch.configs.registry import registry
from repro_torch.data.pipeline import ClickStream
from repro_torch.launch.simdevices import simulated_mesh
from repro_torch.models.gnn import PNAModel
from repro_torch.models.params import cast_model
from repro_torch.models.recsys import embedding_lookup
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharded_step import gather_state, plan_for, sharded_step_for
from repro_torch.parallel.sharding import Placement, ShardedTensor
from repro_torch.pytree import leaves, leaves_with_paths, path_key, tree_map, unflatten
from repro_torch.train.step import functional_loss, init_state, to_device

LOGIT_REL = 1e-5
LOSS_REL = 1e-5
GRAD_REL = 1e-4
PNA_MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]
RECSYS_MESHES = [(1, 2), (2, 2)]
# DIN's item table and Wide&Deep's wide table split over "model" only from
# 65,536 rows (the reference's specs); Wide&Deep's 40 stacked fields are
# cut to 4 of width 8 so that its tables stay small at that vocabulary
RECSYS_CASES = {
    "wide-deep": dict(vocab=65_536, n_sparse=4, embed_dim=8),
    "din": dict(vocab=65_536),
    "two-tower-retrieval": {},
    "dlrm-rm2": {},
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return simulated_mesh(shape[0] * shape[1], shape, ("data", "model"))


def _rank_params(model, mesh):
    """Each mesh device's tree: its "model" pieces, whole over the data axes."""
    specs = model.param_specs(mesh)
    placed = tree_map(lambda s, t: ShardedTensor.place(t, Placement(mesh, s)), specs,
                      model.param_tree())
    return [tree_map(lambda st: st.gather_region(st.model_region(i), dev), placed)
            for i, dev in enumerate(mesh.devices)], specs


def _one_device(model, family: str, batch: dict):
    """The one-device loss and gradients (autograd over the tree)."""
    p0 = model.param_tree()
    live = [p.detach().requires_grad_(True) for p in leaves(p0)]
    loss = functional_loss(model, common.loss_for(family, model))(unflatten(p0, live), batch)
    return loss.detach(), unflatten(p0, list(torch.autograd.grad(loss, live)))


def _sharded(model, family: str, batch: dict, mesh):
    step = sharded_step_for(family, model, adamw(), mesh)
    state = step.shard(init_state(tree_map(lambda t: t.clone(), model.param_tree()), adamw()))
    loss, grads = step.grads(state, batch)
    return step, loss, grads


def _grads_within(got, want, rel=GRAD_REL, ref=None) -> dict:
    """Each leaf's largest gap over its largest |value|, where above ``rel``;
    with ``ref`` (a float64 copy's one-device gradient), a leaf whose
    one-device gradient lies more than ``rel`` from it (noise: the module
    note) is held within ``rel`` of the tree's largest |value| instead."""
    out = {}
    refs = leaves(ref) if ref is not None else [None] * len(leaves(want))
    tree_top = max(float(w.abs().max()) for w in leaves(want))
    for (path, g), (_, w), r in zip(leaves_with_paths(gather_state(got, "cpu")),
                                    leaves_with_paths(want), refs):
        gap = float((g.double() - w.double()).abs().max())
        if gap <= rel * float(w.abs().max()):
            continue
        if r is not None and float((w.double() - r).abs().max()) > rel * float(r.abs().max()) \
                and gap <= rel * tree_top:
            continue
        out[path_key(path)] = gap / float(w.abs().max())
    return out


# ------------------------------------------------------------------- PNA


def _pna(graph_level: bool, dtype=torch.float32):
    model, cfg, batch_fn = registry()["pna"].make_reduced()
    model = type(model)(dataclasses.replace(cfg, graph_level=graph_level))
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    flat = batch_fn(torch.Generator().manual_seed(1))
    n = flat["x"].shape[0]  # 64 nodes in 8 blocks: 1, 2 or 4 node shards
    src, dstl, valid = PNAModel.partition_edges(flat["edge_src"].numpy(),
                                                flat["edge_dst"].numpy(), n, 8)
    batch = {k: v for k, v in flat.items() if k not in ("edge_src", "edge_dst")}
    batch.update(edge_src=torch.from_numpy(src), edge_dst_local=torch.from_numpy(dstl),
                 edge_valid=torch.from_numpy(valid))
    if graph_level:  # 5 graphs whose nodes span the blocks and shards
        del batch["label_mask"]
        batch["graph_id"] = (torch.arange(n, dtype=torch.int32) * 5 // n).flip(0)
        batch["labels"] = torch.randint(0, cfg.n_classes, (5,),
                                        generator=torch.Generator().manual_seed(2),
                                        dtype=torch.int32)
    else:  # a mask that keeps 3 of 4 nodes
        batch["label_mask"] = (torch.arange(n) % 4 != 0).float()
    if dtype != torch.float32:
        model = cast_model(model, dtype, "cpu")
    return model, batch, flat


def _split_logits(model, batch, mesh, graph_level: bool) -> torch.Tensor:
    params = [model.param_tree()] * mesh.n_devices
    out = model.split_forward(params, batch, mesh)
    return out[0] if graph_level else torch.cat(out)


@pytest.mark.parametrize("shape", PNA_MESHES, ids=["2x1", "1x2", "2x2", "1x4"])
@pytest.mark.parametrize("graph_level", [False, True], ids=["node", "graph"])
def test_pna_over_node_shards_matches_one_device(graph_level, shape):
    """The node-shard forward's logits, and the ``"node"`` plan's loss
    (float32) and gradients (a float64 copy) against the one-device port."""
    model, batch, _ = _pna(graph_level)
    mesh = _mesh(shape)
    assert plan_for("gnn", model)["rows"] == "node"
    with torch.no_grad():
        want = model.forward(batch)
        got = _split_logits(model, batch, mesh, graph_level)
    assert float((got - want).abs().max()) <= LOGIT_REL * float(want.abs().max())
    loss, _ = _one_device(model, "gnn", batch)
    step, l_sh, _ = _sharded(model, "gnn", batch, mesh)
    assert step.rows == "node"
    assert abs(float(l_sh) - float(loss)) <= LOSS_REL * abs(float(loss))
    model64, _, _ = _pna(graph_level, torch.float64)
    _, want64 = _one_device(model64, "gnn", batch)
    _, _, g64 = _sharded(model64, "gnn", batch, mesh)
    assert all(isinstance(g, ShardedTensor) for g in leaves(g64))
    assert _grads_within(g64, want64) == {}


def test_pna_flat_batch_on_two_node_shards_raises():
    """A flat edge list crosses every node shard: the node plan raises and
    names the layout it needs; on one device it runs as the one-device
    step."""
    model, _, flat = _pna(False)
    step = sharded_step_for("gnn", model, adamw(), _mesh((2, 1)))
    state = step.shard(init_state(model.param_tree(), adamw()))
    with pytest.raises(ValueError, match="partition_edges"):
        step.grads(state, flat)
    one = sharded_step_for("gnn", model, adamw(), simulated_mesh(1, (1, 1), ("data", "model")))
    loss, _ = one.grads(one.shard(init_state(model.param_tree(), adamw())), flat)
    want, _ = _one_device(model, "gnn", flat)
    assert torch.equal(loss, want)


def test_pna_node_shards_must_divide_the_blocks():
    model, batch, _ = _pna(False)
    with pytest.raises(ValueError, match="partition_edges"):
        model.split_forward([model.param_tree()] * 3, batch,
                            simulated_mesh(3, (3,), ("data",)))


def test_pna_a_wrong_halo_fails(monkeypatch):
    """One shard's piece of the gathered ``h`` off by 1e-3 on one device:
    the logits leave the 1e-5 bound, so the check sees a wrong halo."""
    model, batch, _ = _pna(False)
    mesh = _mesh((2, 2))
    with torch.no_grad():
        want = model.forward(batch)
    real = coll.all_gather

    def off(xs, mesh_, axis, dim, probe=False):
        out = real(xs, mesh_, axis, dim, probe)
        k = xs[0].shape[0]
        out[1] = torch.cat([out[1][:k], out[1][k:2 * k] + 1e-3, out[1][2 * k:]])
        return out

    monkeypatch.setattr(coll, "all_gather", off)
    with torch.no_grad():
        got = _split_logits(model, batch, mesh, False)
    assert float((got - want).abs().max()) > LOGIT_REL * float(want.abs().max())


def test_pna_halo_is_gathered_each_layer():
    """The collectives a node-shard step calls on (2, 2): a float32
    all-gather of ``h`` (N x d) a layer, its reduce-scatter in the backward
    pass, the readout's all-reduce of a sum and a count."""
    model, batch, _ = _pna(False)
    mesh = _mesh((2, 2))
    params = [tree_map(lambda t: t.detach().requires_grad_(True), model.param_tree())
              for _ in range(4)]
    with coll.tally() as moved:
        loss = model.split_loss(params, batch, mesh)
        torch.autograd.grad(loss, [t for p in params for t in leaves(p)], allow_unused=True)
    n, d, layers = batch["x"].shape[0], model.cfg.d_hidden, model.cfg.n_layers
    halo = layers * n * d * 4 * 3 / 4
    assert moved["all-gather"] == halo and moved["reduce-scatter"] == halo
    assert moved["all-reduce"] == 2 * (2 * 2 * 4 * 3 / 4)


# ----------------------------------------------------------------- recsys


def _recsys(arch: str):
    model, cfg, _ = registry()[arch].make_reduced()
    model = type(model)(dataclasses.replace(cfg, **RECSYS_CASES[arch]))
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = to_device(ClickStream(model.cfg, batch=16, seed=0).next(), "cpu")
    return model, batch


def _plant_negative_zero(model, batch) -> dict:
    """A ``-0.0`` row in every table at an id the batch reads: (lookup
    name, the batch row and field that reads it)."""
    out = {}
    with torch.no_grad():
        for name, (key, ids) in model._lookup_ids().items():
            table, i = getattr(model, key), ids(batch)
            if table.ndim == 3:
                table[0, int(i[0, 0])] = -0.0
                out[name] = (0, 0)
            else:
                table[int(i.reshape(len(i), -1)[0, 0])] = -0.0
                out[name] = (0, 0) if i.ndim == 2 else (0,)
    return out


def _rows(batch: dict, d: int) -> list:
    n = next(iter(batch.values())).shape[0]
    step = -(-n // d)
    return [{k: v[s * step:(s + 1) * step] for k, v in batch.items()} for s in range(d)]


@pytest.mark.parametrize("shape", RECSYS_MESHES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("arch", list(RECSYS_CASES))
def test_split_lookups_are_bit_for_bit(arch, shape):
    """Every lookup of ``split_loss`` on each mesh device equals the
    one-device lookup of its data shard's rows bit for bit, a planted
    ``-0.0`` row's sign included, and every table the specs split over
    "model" is read in pieces on this mesh."""
    model, batch = _recsys(arch)
    planted = _plant_negative_zero(model, batch)
    mesh = _mesh(shape)
    params, specs = _rank_params(model, mesh)
    shards = _rows(batch, shape[0])
    got = model.split_lookups(params, shards, mesh, specs)
    split = {k for k, s in specs.items() if not isinstance(s, list) and "model" in s.names()}
    assert split == {key for key, _ in model._lookup_ids().values()}
    for name, (key, ids) in model._lookup_ids().items():
        table = getattr(model, key).detach()
        for r, rows in enumerate(got[name]):
            i = ids(shards[r // shape[1]])
            want = embedding_lookup(table, i) if table.ndim == 3 else table[i.long()]
            assert torch.equal(rows.view(torch.int32), want.view(torch.int32)), (name, r)
            if r // shape[1] == 0:
                assert bool(torch.signbit(rows[planted[name]]).all()), (name, r)


@pytest.mark.parametrize("shape", RECSYS_MESHES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("arch", list(RECSYS_CASES))
def test_split_tables_match_one_device(arch, shape):
    """The sharded step with the tables in "model" pieces against the
    one-device port: the loss within 1e-5, each gradient leaf within 1e-4;
    every table gradient comes back in its pieces, and no leaf the specs
    split over "model" is gathered whole (each device computes with its
    pieces: ``compute_bytes``)."""
    model, batch = _recsys(arch)
    mesh = _mesh(shape)
    loss, want = _one_device(model, "recsys", batch)
    _, ref = _one_device(cast_model(model, torch.float64, "cpu"), "recsys", batch)
    gathered = []
    real = ShardedTensor.gather

    def gather(self, device):
        gathered.append(self.placement.spec)
        return real(self, device)

    ShardedTensor.gather = gather
    try:
        step, l_sh, g_sh = _sharded(model, "recsys", batch, mesh)
    finally:
        ShardedTensor.gather = real
    assert not [s for s in gathered if "model" in s.names()]
    assert abs(float(l_sh) - float(loss)) <= LOSS_REL * abs(float(loss))
    assert _grads_within(g_sh, want, ref=ref) == {}
    specs = model.param_specs(mesh)
    m = shape[1]
    whole, per_model_shard = 0, [0] * m
    for (path, g), (_, t) in zip(leaves_with_paths(g_sh), leaves_with_paths(model.param_tree())):
        spec = specs[path[0]] if len(path) == 1 else specs[path[0]][path[1]]
        split = "model" in spec.names()
        assert isinstance(g, ShardedTensor)
        n = t.numel() * t.element_size()
        whole += n
        if t.ndim < 2:
            assert not split
            per_model_shard = [x + n for x in per_model_shard]
            continue
        rows = [b[-2].stop - b[-2].start for b in
                (g.placement.bounds(g.shape, pc) for pc in g.pieces)]
        assert (max(rows) < t.shape[-2]) == split, path
        v = t.shape[-2]
        for j in range(m):
            lo, hi = coll.piece_bounds(v, m, j) if split else (0, v)
            per_model_shard[j] += (hi - lo) * n // v
    assert step.compute_bytes == per_model_shard * shape[0]
    assert max(per_model_shard) < whole
