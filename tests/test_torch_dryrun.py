"""The port's dry run (``repro_torch.launch.dryrun``) on ``meta`` production
meshes, against the reference's ``repro.launch.dryrun`` (~40 s).

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices
before jax initialises, so the reference's ``_model_flops`` of every cell is
computed in ONE subprocess that prints JSON, never in a pytest worker.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.registry import all_cells, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel.sharding import Placement

ROOT = pathlib.Path(__file__).resolve().parents[1]

_REFERENCE = """
import json
import repro.launch.dryrun as d
from repro.configs.registry import all_cells, get_arch
out = {}
for arch, shape in all_cells():
    bundle = get_arch(arch)
    cell = bundle.cells[shape]
    if cell.skip:
        out[arch + "/" + shape] = {"skip": cell.skip}
        continue
    out[arch + "/" + shape] = {"flops": d._model_flops(bundle, bundle.model_for(shape), cell,
                                                       cell.inputs())}
print("REF " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    line = next(x for x in out.stdout.splitlines() if x.startswith("REF "))
    return json.loads(line[4:])


def test_model_flops_equal_the_reference_for_every_cell(reference):
    assert len(reference) == len(all_cells()) == 40
    for arch, shape in all_cells():
        bundle = get_arch(arch)
        cell = bundle.cells[shape]
        want = reference[f"{arch}/{shape}"]
        if cell.skip:
            assert want == {"skip": cell.skip}
            continue
        got = dryrun.model_flops(bundle, bundle.model_for(shape), cell, cell.inputs())
        assert got == want["flops"], (arch, shape)


def _check_record(rec: dict, want: dict, mesh) -> None:
    """A cell's record: the reference's keys, its skips with its reasons,
    its ``model_flops``; per-device parameter bytes the sum of each leaf's
    piece; a train cell's gradients, optimizer state, activations and
    collectives; an LM serving cell's KV cache."""
    arch, shape = rec["arch"], rec["shape"]
    if "skip" in want:
        assert rec == {"arch": arch, "shape": shape, "status": "skipped",
                       "reason": want["skip"]}
        return
    bundle = get_arch(arch)
    model = bundle.model_for(shape)
    assert rec["status"] == "reckoned" and rec["model_flops"] == want["flops"]
    assert rec["mesh"] == mesh.sizes and rec["n_devices"] == mesh.n_devices
    assert rec["kind"] == bundle.cells[shape].kind and rec["note"] == bundle.cells[shape].note
    mem = rec["per_device_bytes"]
    specs = model.param_specs(mesh)
    params = sum(Placement(mesh, specs[n] if i is None else specs[n][i]).device_bytes(*s)
                 for n, i, s in model._leaves())
    assert mem["params"] == params and params <= model.param_bytes()
    assert rec["device_flops"] > 0
    assert mem["total"] == sum(v for k, v in mem.items() if k != "total")
    if rec["kind"] == "train":
        assert mem["grads"] == params and mem["opt_state"] > 0 and mem["activations"] > 0
        assert rec["collective_bytes"]["total"] >= 0
    if rec["kind"] in ("prefill", "decode") and bundle.family == "lm":
        assert mem["kv_cache"] > 0


def test_train_cells_reckon_on_the_multi_pod_mesh(reference):
    mesh = make_production_mesh(multi_pod=True)
    cells = [(a, s) for a, s in all_cells() if get_arch(a).cells[s].kind == "train"]
    assert len(cells) == 13
    for arch, shape in cells:
        _check_record(dryrun.reckon_cell(arch, shape, mesh), reference[f"{arch}/{shape}"],
                      mesh)


def test_per_device_bytes_of_llama_train_4k():
    """Llama-3.2-1B's ``train_4k`` on 16 x 16 by hand: its AdamW moments
    are twice its parameters in float32 (each leaf's piece); remat keeps
    at least every layer's input, (16 rows x 4,096 x 2,048) bf16 over the
    16 model shards of the sequence-sharded residual stream."""
    rec = dryrun.reckon_cell("llama3.2-1b", "train_4k", make_production_mesh())
    mem = rec["per_device_bytes"]
    mesh = make_production_mesh()
    model = get_arch("llama3.2-1b").model
    specs = model.param_specs(mesh)
    moments = sum(2 * Placement(mesh, specs[n]).device_bytes(shape, torch.float32)
                  for n, _, (shape, _) in model._leaves())
    assert mem["opt_state"] == moments + 4  # m, v and the int32 step
    assert rec["plan"]["remat"] and rec["plan"]["input_split"] == {"tokens": 16}
    assert mem["activations"] >= 16 * 16 * 4096 * 2048 * 2 / 16
    coll = rec["collective_bytes"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert math.isclose(coll["total"], sum(v for k, v in coll.items() if k != "total"))


def test_llama_train_4k_fits_a_device_under_the_model_split():
    """The model split (the port's ``"model"`` plan) reckons Llama
    ``train_4k`` on 16 x 16 under 80 GB a device, where gathering each
    layer whole reckoned 157.7 GB: each model shard keeps its 2 of 32
    heads' scores, a sixteenth of the vocabulary's logits and a sixteenth
    of each layer's input.  The tensor-parallel activation collectives
    are counted (the sequence's all-gather before each column-parallel
    product, the reduce-scatter after each row-parallel one, the loss's
    all-reduces), the whole-leaf gather is gone, and the FLOPs a device
    does are its share of the model's (within the attention and the remat
    recompute)."""
    mesh = make_production_mesh()
    rec = dryrun.reckon_cell("llama3.2-1b", "train_4k", mesh)
    mem = rec["per_device_bytes"]
    assert mem["total"] < 80e9 and mem["activations"] < 20e9
    coll = rec["collective_bytes"]
    for key in ("all-gather (activations)", "reduce-scatter (activations)",
                "all-reduce (activations)"):
        assert coll[key] > 0, key
    assert "all-gather (port step)" not in coll
    assert rec["plan"]["port_step_rows"] == "model"
    share = rec["model_flops"] / mesh.n_devices
    assert share < rec["device_flops"] < 2 * share


def test_cli_reckons_every_cell_on_16x16(reference, tmp_path, capsys):
    """``--all`` writes a record for each of the 40 cells (``_check_record``)."""
    dryrun.main(["--all", "--out", str(tmp_path)])
    assert "ALL CELLS OK" in capsys.readouterr().out
    mesh = make_production_mesh()
    for arch, shape in all_cells():
        rec = json.loads((tmp_path / f"{arch}__{shape}__singlepod.json").read_text())
        _check_record(rec, reference[f"{arch}/{shape}"], mesh)
    rec = json.loads((tmp_path / "pna__ogb_products__singlepod.json").read_text())
    assert rec["plan"]["input_split"]["x"] == 256


def test_ogb_products_reckons_the_halo():
    """PNA's ``ogb_products`` train cell on 16 x 16 under the ``"node"``
    plan: each device all-gathers ``h`` (N x 75 float32) once a layer,
    255/256 of it, and reduce-scatters as much in the backward pass (~5.86
    GB a step over 4 layers); the readout's all-reduces are a sum and a
    count.  The halo is the step's activation collectives."""
    mesh = make_production_mesh()
    rec = dryrun.reckon_cell("pna", "ogb_products", mesh)
    model = get_arch("pna").model_for("ogb_products")
    n = get_arch("pna").cells["ogb_products"].inputs()["x"].shape[0]
    halo = n * model.cfg.d_hidden * 4 * (mesh.n_devices - 1) / mesh.n_devices
    assert rec["plan"]["port_step_rows"] == "node"
    h = rec["plan"]["halo"]
    assert h["all-gather per layer"] == h["reduce-scatter per layer"] == halo
    assert 0 < h["all-reduce (readout)"] < 1e3
    coll = rec["collective_bytes"]
    layers = model.cfg.n_layers
    assert coll["all-gather (activations)"] == coll["reduce-scatter (activations)"] == \
        layers * halo
    assert 5.8e9 < h["total"] < 5.9e9
    assert rec["plan"]["compute_param_bytes"] == model.param_bytes()


@pytest.mark.parametrize("arch", ["wide-deep", "din", "two-tower-retrieval", "dlrm-rm2"])
def test_recsys_train_cells_compute_with_their_table_pieces(arch):
    """A recsys ``train_batch`` cell on 16 x 16 is traced with each table
    at its "model" piece (a sixteenth of its rows): the parameter bytes a
    device computes with equal its pieces' (``per_device_bytes``), below
    the whole model's; the lookups' combine over "model" is an activation
    all-reduce, and the two tower all-gathers its item rows over the data
    axes."""
    mesh = make_production_mesh()
    rec = dryrun.reckon_cell(arch, "train_batch", mesh)
    model = get_arch(arch).model_for("train_batch")
    specs = model.param_specs(mesh)
    tables = [(n, s) for n, i, s in model._leaves() if i is None and "model" in specs[n].names()]
    assert tables
    for name, (shape, dt) in tables:
        piece = Placement(mesh, specs[name]).device_bytes(shape, dt)
        assert piece * 16 == math.prod(shape) * dt.itemsize, name
    assert rec["plan"]["compute_param_bytes"] == rec["per_device_bytes"]["params"]
    assert rec["per_device_bytes"]["params"] < model.param_bytes() / 8
    assert rec["plan"]["port_step_rows"] == ("in_batch" if arch.startswith("two") else "split")
    coll = rec["collective_bytes"]
    assert coll["all-reduce (activations)"] > 0
    assert (coll.get("all-gather (activations)", 0) > 0) == arch.startswith("two")
