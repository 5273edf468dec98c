"""Dry run of the port: reckon every (architecture × input shape) cell on a
production mesh without a device — the counterpart of
``repro.launch.dryrun``, which lowers and compiles each cell on 512 fake
XLA host devices.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]

Torch has no such compile.  The mesh is ``meta`` devices
(``launch.mesh.make_production_mesh``); the models are built on ``meta``
already, so each cell is TRACED on ``meta`` under the reference's shard
plan: one device's share of the batch (each input's dim 0 split over the
axes its ``Cell.partition`` names there, when they divide it; a train
cell's microbatch of that) goes through the cell's step with
``FlopCounterMode`` counting the matmul FLOPs and ``saved_tensors_hooks``
the bytes kept for the backward pass.  An LM train cell runs the port's
own plan (``parallel.sharded_step.plan_for``: ``"model"``): its data
shard's microbatch goes through ``LMModel.split_loss`` on a meta mesh of
the production mesh's axes with every data axis 1 and the same
``"model"`` axis, model shard 0 computing its heads, columns, vocabulary
and sequence share for every model shard (``probe``): its FLOPs, saved
bytes and the collectives it calls (``parallel.collectives.tally``) are
one device's.  The MoE's capacity is then
counted over one data shard's microbatch, the slots a device owns.  A PNA
train cell runs the ``"node"`` plan: ``PNAModel.split_loss`` over the
whole production mesh, device 0 computing its node rows and edge blocks
(the nodes and the 512 blocks split over every device) for every device,
with ``h`` all-gathered a layer (the halo: its all-gather and, in the
backward pass, its reduce-scatter are tallied per layer under ``halo``,
beside the readout's all-reduces).  A recsys train cell runs its model's
``split_loss`` on the production mesh likewise: each table at its
``"model"`` piece (``plan.compute_param_bytes``: the parameter bytes the
device computes with), the lookups' combine over ``"model"`` and the two
tower's item all-gather over the data axes tallied as activation
collectives.
An LM is traced at 2 and 4 layers and extrapolated to its depth (the
reference's own probe scheme, ``probe_lm_cell``), so a 61-layer cell
traces in about a second.  Per cell it emits JSON with the
reference's keys where they mean the same (``arch``, ``shape``, ``kind``,
``mesh``, ``n_devices``, ``status``, ``note``, ``model_flops``) and:

* ``per_device_bytes``: parameters, gradients, optimizer state (its
  ``state_specs``), the microbatch accumulator, activations kept for the
  backward pass (under remat: each layer's input, the unremat'd rest, and
  one layer recomputed at a time), the KV cache of a prefill / decode cell;
  from the specs and the shapes, a dim its axes do not divide reckoned
  padded, as GSPMD pads it;
* ``device_flops``: one compute device's matmul FLOPs (forward, backward
  and the remat recompute, times the microbatches);
* ``collective_bytes``: what the plan implies one device moves, by kind,
  ring-reckoned (a group of n moves (n − 1) / n of the whole, an
  all-reduce twice that): the ``all-gather`` of every parameter's pieces
  over the data axes at use (each layer's again in the backward pass
  under remat, per microbatch), the ``reduce-scatter`` of sharded
  gradients per microbatch, the ``all-reduce`` of gradients a leaf's spec
  replicates over data axes; and an LM train cell's activation
  collectives, as its traced step calls them, per microbatch (``…
  (activations)``: the all-gather of the sequence before each
  column-parallel product, the reduce-scatter after each row-parallel one
  and their transposes in the backward pass, once more for the remat
  recompute; the embedding's and the loss's; ``all-to-all (MoE tokens)``:
  the dispatch and the combine, forward and backward); a PNA train cell's
  halo and readout, a recsys train cell's lookup combines and item
  gather, likewise.

``model_flops`` is the reference's ``_model_flops`` (``dryrun.py:90-131``)
line for line, its quirks kept: a GNN cell counts ``edge_src.shape[0]``,
the 512 edge blocks of the partitioned layout, as its edges.  What cannot
match: XLA's ``memory_analysis`` (buffer assignment, liveness, fusion
temporaries: the port reckons what a plan holds, not what a compiler
allocates), its loop-corrected HLO cost (elementwise work, the
optimizer's arithmetic and the bytes accessed are not counted here), and
its parsed HLO collectives (the port's parameter collectives are
reckoned from the specs, its activation collectives tallied off the
traced split step).  The reference's supermetric
variant of ``retrieval_cand`` is not lowered.  A cell the reference skips
(``cell.skip``) is skipped with the same reason.  Nothing is allocated on
any device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import traceback
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import common
from repro_torch.configs.registry import all_cells, get_arch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim import make_optimizer
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import (
    P,
    Placement,
    ShardMesh,
    abstract_with_sharding,
    dp_axes,
    shard_tree,
)
from repro_torch.parallel.sharded_step import plan_for
from repro_torch.pytree import leaves, leaves_with_paths, tree_map
from repro_torch.serve.queue import now

__all__ = ["model_flops", "reckon_cell", "reckon_lm_step", "main"]

PREFILL_CHUNK = 2048  # the reference's Sarathi-style chunked prefill


# ------------------------------------------------------------------ flops


def _numel(shape) -> int:
    return math.prod(int(s) for s in shape)


def _first_rows(batch: dict) -> int:
    """``jax.tree.leaves(batch)[0].shape[0]``: the first key in sorted order."""
    return batch[sorted(batch)[0]].shape[0]


def model_flops(bundle, model, cell, batch: dict) -> float:
    """Analytic useful-FLOPs reference (6*N*D rule and analogues): the
    reference's ``_model_flops``."""
    cfg = model.cfg
    if bundle.family == "lm":
        n_act = cfg.n_active_params()
        if cell.kind == "train":
            toks = batch["tokens"].shape[0] * (batch["tokens"].shape[1] - 1)
            return 6.0 * n_act * toks
        if cell.kind == "prefill":
            toks = batch["tokens"].shape[0] * batch["tokens"].shape[1]
            return 2.0 * n_act * toks
        toks = batch["token"].shape[0]
        return 2.0 * n_act * toks
    if bundle.family == "gnn":
        # dominant: per-edge message MLP + per-node update MLP, fwd+bwd (x3)
        x = batch["x"]
        e = batch["edge_src"].shape[0]
        n = x.shape[0]
        d = cfg.d_hidden
        per_layer = e * (2 * d) * d * 2 + n * (13 * d) * d * 2
        fwd = cfg.n_layers * per_layer + n * x.shape[1] * d * 2
        return 3.0 * fwd
    # recsys: embedding gathers dominate bytes, MLPs dominate flops
    model_params = sum(_numel(shape) for _, _, (shape, _) in model._leaves()
                       if len(shape) == 2)  # MLP mats only (tables are gathered)
    if "candidates" in batch:
        # two-tower candidate scoring: ONE user-tower pass + a dot per candidate
        n = batch["candidates"].shape[0]
        e_dim = batch["candidates"].shape[1]
        user_rows = batch["user_ids"].shape[0]
        return 2.0 * model_params * user_rows + 2.0 * n * e_dim * user_rows
    rows = _first_rows(batch)
    mult = 6.0 if cell.kind == "train" else 2.0
    return mult * model_params * rows


# ------------------------------------------------------------------- bytes


def _dp_size(mesh: ShardMesh) -> int:
    return math.prod(mesh.size(a) for a in dp_axes(mesh))


def _placed(mesh: ShardMesh, shapes, specs) -> list:
    """``(path, AbstractLeaf)`` of a tree of shapes laid out by its specs."""
    return leaves_with_paths(abstract_with_sharding(shapes, shard_tree(mesh, specs)))


def _collectives(mesh, params: list, *, train: bool, remat: bool, microbatches: int,
                 layer_keys: set, activations: dict | None = None) -> dict:
    """Ring-reckoned bytes one device moves under the plan (module note);
    ``params``: ``_placed``'s leaves."""
    gather = scatter = reduce = 0.0
    dp = dp_axes(mesh)
    for path, a in params:
        piece = a.device_bytes
        named = a.placement.spec.names()
        d = math.prod(mesh.size(x) for x in dp if x in named)  # FSDP split
        used = piece * d  # the device's "model" piece, gathered over the data axes
        uses = 1
        if train:
            uses = microbatches * (2 if remat and path[0] in layer_keys else 1)
        gather += uses * used * (d - 1) / d
        if not train:
            continue
        scatter += microbatches * used * (d - 1) / d
        r = math.prod(mesh.size(x) for x in dp if x not in named)
        if r > 1:
            reduce += 2.0 * piece * (r - 1) / r
    out = {"all-gather": gather, "reduce-scatter": scatter, "all-reduce": reduce}
    for kind, n in (activations or {}).items():
        key = "all-to-all (MoE tokens)" if kind == "all-to-all" else f"{kind} (activations)"
        out[key] = n
    out["total"] = sum(out.values())
    return out


# ------------------------------------------------------------------- trace


def _trace(model, fn, grad: bool, params=None) -> dict:
    """Forward (and backward) of ``fn()`` on meta: matmul FLOPs forward and
    in all, the bytes saved for the backward pass (``params``, by default
    the model's, and their views excluded), and the collectives' bytes
    forward and in all (``collectives.tally``)."""
    params = list(model.parameters()) if params is None else params
    ids = {id(p) for p in params}
    saved = [0]

    def pack(t):
        if id(t) not in ids and id(t._base) not in ids:
            saved[0] += t.numel() * t.element_size()
        return t

    with FlopCounterMode(display=False) as fc, collectives.tally() as moved:
        if grad:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                out = fn()
            fwd, fwd_moved = fc.get_total_flops(), dict(moved)
            out.backward()
        else:
            with torch.no_grad():
                fn()
            fwd, fwd_moved = fc.get_total_flops(), dict(moved)
        total = fc.get_total_flops()
    for p in params:
        p.grad = None
    out = {"fwd": float(fwd), "total": float(total), "saved": float(saved[0])}
    for kind in moved:
        out["fwd moved " + kind] = fwd_moved.get(kind, 0.0)
        out["moved " + kind] = moved[kind]
    return out


def _probe_mesh(mesh: ShardMesh) -> ShardMesh:
    """The production mesh's axes with every data axis 1: one data shard
    and all its model shards, on meta."""
    shape = tuple(1 if a in dp_axes(mesh) else n for a, n in zip(mesh.axis_names, mesh.shape))
    return ShardMesh((torch.device("meta"),) * math.prod(shape), mesh.axis_names, shape)


def _device_tree(m, mesh: ShardMesh, specs) -> tuple[dict, list]:
    """Mesh device 0's parameter tree on meta, each leaf its piece over the
    axes that are not data axes (whole over the data axes: what it computes
    with), and the tree's leaves."""
    dp = set(dp_axes(mesh))

    def piece(spec, a):
        axes = P(*spec).axes(a.ndim)
        pl = Placement(mesh, P(*[tuple(x for x in ax if x not in dp) or None for ax in axes]))
        b = pl.bounds(tuple(a.shape), pl.piece_of(0, a.ndim))
        return torch.empty(tuple(x.stop - x.start for x in b), dtype=a.dtype, device="meta",
                           requires_grad=True)

    tree = tree_map(piece, specs, m.abstract_params())
    return tree, leaves(tree)


def _split_probe(m, mesh: ShardMesh, specs: dict, batch: dict) -> dict:
    """``m.split_loss`` traced on ``_probe_mesh(mesh)`` over one data
    shard's microbatch, device 0 standing for every model shard
    (``split_loss(probe=True)``): one device's FLOPs, saved bytes and
    collectives."""
    probe = _probe_mesh(mesh)
    tree, flat = _device_tree(m, probe, specs)
    return _trace(m, lambda: m.split_loss([tree] * probe.n_devices, [batch["tokens"]], probe,
                                          specs, probe=True),
                  grad=True, params=flat)


def _mesh_probe(model, mesh: ShardMesh, batch) -> dict:
    """A PNA or recsys train cell's ``split_loss`` traced on the production
    mesh, device 0 standing for every device (``probe``): ``batch`` the
    whole graph (PNA) or each data shard's rows (recsys).  One device's
    FLOPs, saved bytes and collectives, and the parameter bytes it
    computes with."""
    specs = model.param_specs(mesh)
    tree, flat = _device_tree(model, mesh, specs)
    out = _trace(model, lambda: model.split_loss([tree] * mesh.n_devices, batch, mesh, specs,
                                                 probe=True), grad=True, params=flat)
    out["compute_param_bytes"] = sum(t.numel() * t.element_size() for t in flat)
    return out


def _lm_probe(model, cell, batch: dict, mb: int, mesh: ShardMesh) -> dict:
    """The LM traced at 2 and 4 layers, remat off, extrapolated to its depth
    (per layer = (P4 - P2) / 2, fixed = P2 - 2 * per layer); remat adds
    each layer's forward (and its collectives) again and keeps each layer's
    input (its sequence share under ``seq_shard_activations``) instead of
    its activations.  A train cell traces one model shard of the split
    step (``_split_probe``)."""
    cfg = model.cfg
    specs = model.param_specs(mesh)
    msize = mesh.size("model") if "model" in mesh.axis_names else 1
    probes = {}
    for n_layers in (2, 4):
        m = type(model)(dataclasses.replace(cfg, n_layers=n_layers, remat=False,
                                            attn_q_chunk=None))
        if cell.kind == "train":
            probes[n_layers] = _split_probe(m, mesh, specs, batch)
        elif cell.kind == "prefill":
            probes[n_layers] = _trace(
                m, lambda: m.prefill(batch["tokens"], chunk=PREFILL_CHUNK), grad=False)
        else:
            seq = common.LM_SHAPES[cell.shape_name]["seq"]
            cache = {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
                     for k, s in m.init_cache_shapes(batch["token"].shape[0], seq).items()}
            probes[n_layers] = _trace(m, lambda: m.decode_step(cache, batch["token"], 0),
                                      grad=False)
    keys = set(probes[2]) | set(probes[4])
    per = {k: (probes[4].get(k, 0.0) - probes[2].get(k, 0.0)) / 2 for k in keys}
    fixed = {k: probes[2].get(k, 0.0) - 2 * per[k] for k in keys}
    L = cfg.n_layers
    at = {k: fixed[k] + L * per[k] for k in keys}
    flops, saved = at["total"], at["saved"]
    moved = {k[6:]: at[k] for k in keys if k.startswith("moved ")}
    remat = cell.kind == "train" and cfg.remat
    if remat:
        flops += L * per["fwd"]
        for kind in moved:
            moved[kind] += L * per["fwd moved " + kind]
        rows, seq = batch["tokens"].shape[0], batch["tokens"].shape[1] - 1
        x_bytes = rows * seq * cfg.d_model * cfg.dtype.itemsize
        if cfg.seq_shard_activations:
            x_bytes /= msize
        saved = fixed["saved"] + L * x_bytes + per["saved"]
    return {"flops": mb * flops, "saved": saved, "remat": remat,
            "moved": {k: mb * v for k, v in moved.items()}}


def _train_bytes(model, mesh, specs, params: list, mb: int, saved: float,
                 optimizer: str | None = None) -> dict:
    """One device's parameters, gradients, optimizer state, microbatch
    accumulator and saved activations for a train step."""
    cfg = model.cfg
    mem = {"params": sum(a.device_bytes for _, a in params)}
    opt = make_optimizer(optimizer or getattr(cfg, "optimizer", "adamw"))
    mem["grads"] = mem["params"]
    mem["opt_state"] = sum(a.device_bytes for _, a in _placed(
        mesh, opt.init(model.abstract_params()), opt.state_specs(specs)))
    mem["accumulator"] = 0
    if mb > 1:
        acc = getattr(torch, getattr(cfg, "grad_accum_dtype", "float32"))
        mem["accumulator"] = sum(a.placement.device_bytes(a.shape, acc) for _, a in params)
    mem["activations"] = int(saved)
    return mem


def reckon_lm_step(model, mesh: ShardMesh, rows: int, seq: int, microbatches: int = 1,
                   optimizer: str = "adamw") -> dict:
    """One device's bytes of ``model``'s train step over ``mesh`` (the
    ``"model"`` plan) at ``rows`` x ``seq`` tokens, reckoned as a train
    cell is (``_train_bytes``; the activations of one model shard of one
    data shard's microbatch, traced on meta): what a card run of the same
    step is held beside."""
    shards = _dp_size(mesh)
    per = -(-rows // (shards * microbatches))
    batch = {"tokens": torch.empty((per, seq + 1), dtype=torch.int32, device="meta")}
    probed = type(model)(model.cfg)  # on meta, whatever holds ``model``'s weights
    traced = _lm_probe(probed, _TrainCell, batch, microbatches, mesh)
    specs = probed.param_specs(mesh)
    params = _placed(mesh, probed.abstract_params(), specs)
    mem = _train_bytes(probed, mesh, specs, params, microbatches, traced["saved"], optimizer)
    mem["total"] = sum(mem.values())
    return mem


class _TrainCell:
    kind = "train"


def reckon_cell(arch: str, shape_name: str, mesh: ShardMesh) -> dict:
    """One cell's record (module note)."""
    bundle = get_arch(arch)
    cell = bundle.cells[shape_name]
    if cell.skip:
        return {"arch": arch, "shape": shape_name, "status": "skipped", "reason": cell.skip}
    t0 = now()
    model = bundle.model_for(shape_name)
    cfg = model.cfg
    inputs = cell.inputs()
    part = cell.partition(mesh)
    # each input's dim 0 split over the axes its partition names there
    split = {}
    for k, spec in part.items():
        axes = P(*spec).axes(len(inputs[k].shape))[0] if len(spec) else ()
        n = math.prod(mesh.size(a) for a in axes)
        if n > 1 and inputs[k].shape[0] % n == 0:
            split[k] = n
    rows = {k: s.shape[0] // split.get(k, 1) for k, s in inputs.items() if len(s.shape)}
    mb = getattr(cfg, "microbatches", 1) if cell.kind == "train" else 1
    if any(r % mb for r in rows.values()):
        mb = 1
    batch = {k: torch.empty(((rows[k] // mb,) + tuple(s.shape[1:])) if k in rows else (),
                            dtype=s.dtype, device="meta") for k, s in inputs.items()}

    extra: dict = {}
    if bundle.family == "lm":
        traced = _lm_probe(model, cell, batch, mb, mesh)
    elif cell.kind == "train":
        if bundle.family == "gnn":
            # the node plan reads the whole graph and splits it itself
            mb, shards = 1, {k: torch.empty(tuple(s.shape), dtype=s.dtype, device="meta")
                             for k, s in inputs.items()}
        else:  # every data shard's rows alike: one data shard's
            shards = [batch] * _dp_size(mesh)
        t = _mesh_probe(model, mesh, shards)
        moved = {k[6:]: mb * v for k, v in t.items() if k.startswith("moved ")}
        traced = {"flops": mb * t["total"], "saved": t["saved"], "remat": False,
                  "moved": moved}
        extra["compute_param_bytes"] = t["compute_param_bytes"]
        if bundle.family == "gnn":
            layers = model.cfg.n_layers
            extra["halo"] = {
                "all-gather per layer": moved.get("all-gather", 0.0) / layers,
                "reduce-scatter per layer": moved.get("reduce-scatter", 0.0) / layers,
                "all-reduce (readout)": moved.get("all-reduce", 0.0),
                "total": sum(moved.values())}
    else:
        t = _trace(model, lambda: model.forward(batch), grad=False)
        traced = {"flops": t["total"], "saved": 0.0, "remat": False}

    specs = model.param_specs(mesh)
    params = _placed(mesh, model.abstract_params(), specs)
    train = cell.kind == "train"
    mem = (_train_bytes(model, mesh, specs, params, mb, traced["saved"]) if train
           else {"params": sum(a.device_bytes for _, a in params)})
    if bundle.family == "lm" and cell.kind in ("prefill", "decode"):
        b = inputs["tokens" if cell.kind == "prefill" else "token"].shape[0]
        seq = common.LM_SHAPES[shape_name]["seq"]
        mem["kv_cache"] = sum(a.device_bytes for _, a in _placed(
            mesh, model.init_cache_shapes(b, seq), model.cache_specs(mesh, b)))
    mem["total"] = sum(mem.values())
    layer_keys = set(model._layer_params()[1]) if bundle.family == "lm" else set()
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": cell.kind,
        "mesh": mesh.sizes,
        "n_devices": mesh.n_devices,
        "status": "reckoned",
        "note": cell.note,
        "plan": {"input_split": split, "microbatches": mb, "remat": traced["remat"],
                 "port_step_rows": (plan_for(bundle.family, model)["rows"]
                                    if cell.kind == "train" else None), **extra},
        "per_device_bytes": mem,
        "device_flops": traced["flops"],
        "collective_bytes": _collectives(mesh, params, train=train,
                                         remat=traced["remat"], microbatches=mb,
                                         layer_keys=layer_keys,
                                         activations=traced.get("moved")),
        "model_flops": model_flops(bundle, model, cell, inputs),
        "seconds": round(now() - t0, 3),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    failures = []
    for multi_pod in meshes:
        mesh = make_production_mesh(multi_pod=multi_pod)
        tag = "multipod" if multi_pod else "singlepod"
        for arch, shape in cells:
            fname = outdir / f"{arch.replace('/', '_')}__{shape}__{tag}.json"
            try:
                rec = reckon_cell(arch, shape, mesh)
            except Exception as e:  # noqa: BLE001 - every cell is reported
                failures.append((arch, shape, tag, repr(e)))
                fname.write_text(json.dumps({"arch": arch, "shape": shape, "status": "failed",
                                             "error": traceback.format_exc()}, indent=2))
                print(f"{arch} x {shape} [{tag}] FAILED: {e}", flush=True)
                continue
            fname.write_text(json.dumps(rec, indent=2))
            if rec["status"] == "skipped":
                print(f"{arch} x {shape} [{tag}] skipped: {rec['reason']}", flush=True)
                continue
            mem = rec["per_device_bytes"]
            print(f"{arch} x {shape} [{tag}] total={mem['total'] / 2**30:.2f}GiB "
                  f"params={mem['params'] / 2**30:.2f}GiB "
                  f"act={mem.get('activations', 0) / 2**30:.2f}GiB "
                  f"flops={rec['device_flops']:.3e} model_flops={rec['model_flops']:.3e} "
                  f"coll={rec['collective_bytes']['total'] / 2**30:.3f}GiB", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nALL CELLS OK")


if __name__ == "__main__":
    main()
