"""The port's mesh and placement helpers (``repro_torch.parallel.sharding``,
``launch.mesh``, ``launch.simdevices``) against the reference's
``repro.parallel.sharding`` / ``repro.launch.mesh``, on the CPU (~15 s).

* every arch's parameter specs, both optimizers' state specs, the LM KV
  cache's specs and every cell's input partition equal the reference's
  leaf for leaf on the 16 × 16, 2 × 16 × 16 and (2, 2) meshes (the
  reference's spec functions read only a mesh's axis names and sizes, so
  they get a stand-in mesh and the port a mesh of ``meta`` devices);
* ``P`` equals as JAX's ``PartitionSpec`` does; a placement's pieces tile
  the tensor (uneven dims padded as GSPMD pads them);
* a checkpoint saved under a (2, 2) mesh restores under (4,) — the
  reference's elastic reshard (``tests/test_multidevice.py``) — in both
  packages' hands, and a sharded train state restored so steps on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs.registry import registry as jax_registry
from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import registry
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.simdevices import simulated_mesh
from repro_torch.optim import adafactor, adamw
from repro_torch.parallel.sharded_step import gather_state, sharded_step_for
from repro_torch.parallel.sharding import (
    P,
    Placement,
    ShardedTensor,
    ShardMesh,
    abstract_with_sharding,
    active_mesh,
    batch_spec,
    divisible_or_none,
    fsdp_axes,
    maybe_constrain,
    named,
    shard_tree,
)
from repro_torch.pytree import leaves, tree_map
from repro_torch.train.step import init_state, make_train_step
from torch_sharding_common import MESHES, meshes, spec_tuples

LR = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ spec parity


@pytest.mark.parametrize("names,shape", MESHES, ids=["16x16", "2x16x16", "2x2"])
def test_specs_match_the_reference_for_every_arch(names, shape):
    jmesh, tmesh = meshes(names, shape)
    jreg, treg = jax_registry(), registry()
    assert list(jreg) == list(treg)
    n = 0
    for arch, jb in jreg.items():
        tb = treg[arch]
        for cname, jcell in jb.cells.items():
            jm, tm = jb.model_for(cname), tb.model_for(cname)
            want, got = jm.param_specs(jmesh), tm.param_specs(tmesh)
            assert spec_tuples(got) == spec_tuples(want), (arch, cname)
            for jopt, topt in ((j_adamw(), adamw()), (j_adafactor(), adafactor())):
                assert spec_tuples(topt.state_specs(got)) == \
                    spec_tuples(jopt.state_specs(want)), (arch, cname)
            assert spec_tuples(tb.cells[cname].partition(tmesh)) == \
                spec_tuples(jcell.input_partition(jmesh)), (arch, cname)
            if jb.family == "lm":
                for b in (1, 32, 128):
                    assert spec_tuples(tm.cache_specs(tmesh, b)) == \
                        spec_tuples(jm.cache_specs(jmesh, b)), (arch, b)
            n += 1
    assert n == 40


def test_p_equals_as_partition_spec_does():
    cases = [(("data",), None), ("data", None), ("data",), (None,), (),
             (("pod", "data"), "model"), ((), None)]
    for a in cases:
        for b in cases:
            assert (P(*a) == P(*b)) == (JP(*a) == JP(*b)), (a, b)
        assert tuple(P(*a)) == tuple(JP(*a))
    assert hash(P(("data",))) == hash(P("data"))
    assert P("data", None) == ("data", None)
    with pytest.raises(TypeError):
        P(3)


def test_helpers_follow_the_reference():
    mesh = ShardMesh(("meta",) * 8, ("pod", "data", "model"), (2, 2, 2))
    assert fsdp_axes(mesh) == ("pod", "data")
    assert batch_spec(mesh, None) == P(("pod", "data"), None)
    assert divisible_or_none(12, mesh, ("pod", "data")) == ("pod", "data")
    assert divisible_or_none(6, mesh, ("pod", "data")) is None
    assert divisible_or_none(6, mesh, "model") == ("model",)
    assert named(mesh, P("model")) == Placement(mesh, P("model"))
    tree = shard_tree(mesh, {"a": P(None, "model"), "b": [P(), P("data")]})
    assert tree["a"].spec == P(None, "model") and tree["b"][1].mesh is mesh
    abstract = abstract_with_sharding(
        {"a": torch.empty((4, 6), device="meta"),
         "b": [torch.empty((), dtype=torch.int32, device="meta"),
               torch.empty((5,), dtype=torch.bfloat16, device="meta")]}, tree)
    assert abstract["a"].device_bytes == 4 * 3 * 4
    assert abstract["b"][0].device_bytes == 4 and abstract["b"][1].device_bytes == 3 * 2
    with pytest.raises(ValueError, match="lacks"):
        Placement(mesh, P("expert"))


def test_placement_pieces_tile_the_tensor():
    """Pieces over (2, 3): the first dim over "data", the second over
    "model" (7 columns: 3, 3, 1); each device's share is reckoned padded."""
    mesh = simulated_mesh(6, (2, 3), ("data", "model"))
    w = torch.arange(4 * 7, dtype=torch.float32).reshape(4, 7)
    pl = Placement(mesh, P("data", "model"))
    st = ShardedTensor.place(w, pl)
    assert len(st.pieces) == 6
    assert sorted(t.shape[1] for _, _, t in st.local()) == [1, 1, 3, 3, 3, 3]
    assert torch.equal(st.gather("cpu"), w)
    assert st.device_bytes() == 2 * 3 * 4 and pl.device_shape((4, 7)) == (2, 3)
    st.scatter_(w * 2)
    assert torch.equal(st.gather("cpu"), w * 2)
    rep = ShardedTensor.place(w, Placement(mesh, P()))
    assert len(rep.pieces) == 1 and rep.held_bytes() == {torch.device("cpu"): 4 * 7 * 4}


def test_mesh_takes_model_axes_and_meta_devices():
    m = ShardMesh(("cpu",) * 4, ("data", "model"), (2, 2))
    assert m.sizes == {"data": 2, "model": 2} and m.coords(3) == {"data": 1, "model": 1}
    prod = make_production_mesh()
    assert prod.sizes == {"data": 16, "model": 16} and prod.lead.type == "meta"
    multi = make_production_mesh(multi_pod=True)
    assert multi.sizes == {"pod": 2, "data": 16, "model": 16} and multi.n_devices == 512
    with pytest.raises(ValueError, match="mixes device types"):
        ShardMesh(("cpu", "meta"), ("data",))
    with pytest.raises(ValueError, match="meta mesh"):
        sharded_step_for("lm", registry()["llama3.2-1b"].make_reduced()[0], adamw(), prod)
    sim = simulated_mesh(4, (2, 2), ("data", "model"))
    assert sim == m


def test_make_local_mesh_spans_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_local_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    m = make_local_mesh(2, n_devices=4)
    assert m.sizes == {"data": 2, "model": 2} and m.devices == (torch.device("cuda", 0),) * 4
    assert make_local_mesh().sizes == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="device count 3 not divisible by model_parallel 2"):
        make_local_mesh(2, n_devices=3)


def test_maybe_constrain_checks_only_inside_a_step():
    x = torch.zeros((4, 3))
    assert maybe_constrain(x, P("expert", None)) is x
    with active_mesh(simulated_mesh(2)):
        assert maybe_constrain(x, P("data", None)) is x
        with pytest.raises(ValueError, match="lacks"):
            maybe_constrain(x, P("model"))
        with pytest.raises(ValueError, match="more entries"):
            maybe_constrain(x, P("data", None, None))


# ---------------------------------------------------------------- reshard


def test_elastic_reshard_in_both_formats(tmp_path):
    """The reference's test: ``w`` saved under (2, 2) with P("data",
    "model"), restored under (4,) with P("data", None).  The port's save
    restores in the reference's manager and the reference's in the
    port's."""
    w = torch.arange(64.0).reshape(8, 8)
    mesh_a = simulated_mesh(4, (2, 2), ("data", "model"))
    mesh_b = simulated_mesh(4)
    w_a = ShardedTensor.place(w, Placement(mesh_a, P("data", "model")))
    CheckpointManager(tmp_path / "port").save(1, {"w": w_a})
    back, _ = CheckpointManager(tmp_path / "port").restore(
        {"w": w}, placements={"w": Placement(mesh_b, P("data", None))})
    assert back["w"].placement.spec == P("data", None) and len(back["w"].pieces) == 4
    assert torch.equal(back["w"].gather("cpu"), w)
    jback, _ = JCheckpointManager(tmp_path / "port").restore({"w": w.numpy()})
    np.testing.assert_array_equal(np.asarray(jback["w"]), w.numpy())
    JCheckpointManager(tmp_path / "jax").save(1, {"w": w.numpy()})
    tback, _ = CheckpointManager(tmp_path / "jax").restore(
        {"w": w}, placements={"w": Placement(mesh_b, P("data", None))})
    assert torch.equal(tback["w"].gather("cpu"), w)


def _drop_model(spec_tree):
    """The same specs with the "model" axis dropped (a (4,) data mesh)."""
    return tree_map(lambda s: P(*[None if e == "model" else e for e in s]), spec_tree)


def test_train_state_saved_under_2x2_restores_under_4_and_steps_on(tmp_path):
    """A reduced Llama stepped under (2, 2), saved, restored under (4,)
    (the same specs without "model"), steps on: the restored pieces equal
    the saved state bit for bit, and the step stays within the training
    bound of the one-device step from the same state."""
    model, cfg, batch_fn = registry()["llama3.2-1b"].make_reduced()
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    opt = adamw(lr=LR)
    a = sharded_step_for("lm", model, opt, simulated_mesh(4, (2, 2), ("data", "model")))
    state = a.shard(init_state(tree_map(lambda t: t.clone(), model.param_tree()), opt))
    state, _ = a.step_(state, batch_fn(torch.Generator().manual_seed(1)))
    saved = gather_state(state, "cpu")
    CheckpointManager(tmp_path).save(1, state)
    mesh_b = simulated_mesh(4)
    b = sharded_step_for("lm", model, opt, mesh_b)
    assert b.placements["params"]["wq"].spec == _drop_model(
        a.param_specs)["wq"] == P(None, "data", None)
    restored, _ = CheckpointManager(tmp_path).restore(state, placements=b.placements)
    for x, y in zip(leaves(gather_state(restored, "cpu")), leaves(saved)):
        assert torch.equal(x, y)
    batch = batch_fn(torch.Generator().manual_seed(2))
    got, m = b.step_(restored, batch)
    one = make_train_step(a.loss_fn, opt)
    want, wm = one(saved, batch)
    assert abs(float(m["loss"]) - float(wm["loss"])) <= 1e-5 * abs(float(wm["loss"]))
    for x, y in zip(leaves(gather_state(got, "cpu")["params"]), leaves(want["params"])):
        d = (x.float() - y.float()).abs()
        assert float(d.max()) <= 2 * LR and float((d > 1e-5).float().mean()) <= 0.01


def test_dataclass_replace_keeps_specs():
    """``batch_axes`` changes no parameter spec (the reference's
    ``_with_batch_axes`` rebuilds the model with it before asking)."""
    tm = registry()["gemma2-9b"].model
    mesh = meshes(*MESHES[0])[1]
    again = type(tm)(dataclasses.replace(tm.cfg, batch_axes=("data",)))
    assert spec_tuples(again.param_specs(mesh)) == spec_tuples(tm.param_specs(mesh))
