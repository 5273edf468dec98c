"""The sharded train step of the port: the counterpart of
``jax.jit(make_train_step(...))`` over a state and a batch that carry
``NamedSharding``s (the reference's ``tests/test_multidevice.py``).  The
reference leans on GSPMD, whose rule is that a partitioned program
computes the one-device program's function.  The port has no partitioner,
so this module keeps that rule by hand:

* **State in pieces.**  Every leaf of the train state (parameters,
  optimizer state, the int8 residual, the step counts) is a
  :class:`~repro_torch.parallel.sharding.ShardedTensor`: the pieces its
  spec names, each on its own device (``state_specs``: the parameters'
  specs, the optimizer's ``state_specs`` of them, ``P()`` for a count).
* **Rows** (``rows=``), per family (``plan_for``):

  - ``"model"`` — every LM, dense or MoE: the reference's FSDP + TP plan.
    Mesh device ``r`` (``"model"`` the mesh's last axis) is data shard
    ``r // m`` and model shard ``r % m``.  Each parameter is gathered over
    the data axes its spec splits it over (the FSDP split), each device
    keeping its ``"model"`` piece (``ShardedTensor.model_region``): no
    leaf the spec splits over ``"model"`` is gathered whole.  The batch is
    cut into microbatches of consecutive rows, as on one device, and each
    microbatch's rows are split over the data shards; ``split`` (the
    model's ``split_loss``) runs every mesh device's part of the forward
    at once, its layers split over ``"model"`` with the collectives of
    ``parallel.collectives`` (and the MoE's routing over the whole
    microbatch), and one backward gives each device's gradient of its
    pieces.  Those are summed over the devices that hold a piece's region
    in mesh order 0 … R−1 in float32 (float64 for a float64 copy; the
    reduce-scatter over the data axes, plus the model shards' partial
    sums of a leaf the spec keeps whole over ``"model"``; a device whose
    copy the loss does not reach adds nothing) and cast: the gradient
    comes back as ``ShardedTensor``s in the parameters' pieces.
  - ``"split"`` — the loss is a mean of independent per-row terms (the CTR
    models' BCE).  On a mesh whose ``"model"`` axis is larger than 1 the
    tables compute in their ``"model"`` pieces: the model's
    ``split_loss`` (``models.recsys``'s note: lookups piece by piece,
    combined over ``"model"``), each leaf gathered over the data axes
    only and the gradient summed and returned in pieces as under
    ``"model"`` (no table, and no table gradient, is ever whole).
    Otherwise the batch's rows are split over the data axes, shard
    ``s`` on ``shard_devices(mesh)[s]``; each shard gathers every
    parameter whole (a copy, no arithmetic; once a step per distinct
    device) and runs the one-device loss and backward on its rows, and
    the loss and gradients are ``sum_s (rows_s / rows) * x_s``, summed in
    shard order 0 … S−1 in float32 (float64 for a float64 copy) on the
    lead device, the gradients then cast to their parameter's dtype.
  - ``"in_batch"`` — the two-tower loss is an in-batch softmax over a
    (B, B) logit matrix, so rows interact through the item column: each
    shard embeds its rows, the item rows are all-gathered (float32, in
    shard order), each shard takes its rows' softmax over every column,
    the item rows' gradients are summed over the shards in shard order in
    float32 (the reduce-scatter), and each shard runs its towers' backward.
    On a mesh whose ``"model"`` axis is larger than 1, the towers' lookups
    are split as ``"split"``'s, and the gather and its transpose are
    ``parallel.collectives``' over the data axes.
  - ``"node"`` — PNA: the nodes and the edge blocks of the partitioned
    layout split over every mesh device (``PNAModel.split_loss``: the halo
    all-gather of ``h`` a layer, block-local segment ops, the readout's
    all-reduces), the replicated weights' partial gradients summed in mesh
    order as under ``"model"``.

  With one compute shard (``"split"`` or ``"in_batch"`` on a mesh whose
  data axes are 1 and whose ``"model"`` axis is 1 or absent) the loss and
  gradients are that shard's own: storage-only sharding gives the
  one-device step's bits.
* **Updated in place, piece by piece** (the port's counterpart of
  ``donate_argnums=(0,)``).  The optimizer's ``prepare`` runs once over the
  whole gradient tree on the lead device (the step count, the learning
  rate, AdamW's global-norm clip: one sum per leaf, a leaf in pieces
  summing its pieces' squares in piece order).  An elementwise optimizer
  (AdamW) then updates each piece on its own device from its piece of the
  gradient and the step's scalars; Adafactor's row and column means, the
  mean of ``vr`` and the RMS clip reach over whole dims, so its leaf is
  gathered onto the lead device, updated by the same ``leaf`` code and
  written back into its pieces.  Either way each element goes through the
  one-device operations.  The int8 residual is one scale per whole leaf,
  so it is gathered, updated and written back the same way.

Nothing here reads a value to the host; on a CUDA mesh nothing runs on the
CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.optim import Optimizer, int8_error_feedback
from repro_torch.parallel.sharding import (
    P,
    ShardedTensor,
    ShardMesh,
    active_mesh,
    dp_axes,
    n_shards,
    shard_devices,
    shard_tree,
)
from repro_torch.pytree import leaves, tree_map, unflatten

__all__ = [
    "ROWS",
    "state_specs",
    "shard_state",
    "gather_state",
    "plan_for",
    "ShardedTrainStep",
    "make_sharded_train_step",
    "sharded_step_for",
]

ROWS = ("model", "split", "in_batch", "node")


def state_specs(optimizer: Optimizer, param_specs, compression: bool = False) -> dict:
    """The specs of ``train.step.init_state``'s tree."""
    out = {"params": param_specs, "opt": optimizer.state_specs(param_specs), "step": P()}
    if compression:
        out["residual"] = param_specs
    return out


def shard_state(state, placements):
    """``state`` (whole tensors) laid out by ``placements`` (the same tree of
    ``Placement``s): a tree of ``ShardedTensor``s."""
    return tree_map(lambda pl, t: ShardedTensor.place(t, pl), placements, state)


def gather_state(state, device):
    """A tree of ``ShardedTensor``s (or whole tensors) as whole tensors on
    ``device``."""
    return tree_map(lambda s: _whole(s, device), state)


def _whole(x, device) -> torch.Tensor:
    return x.gather(device) if isinstance(x, ShardedTensor) else x.to(device)


def plan_for(family: str, model) -> dict:
    """How a model of ``family`` splits its rows (see the module note):
    ``rows``, ``split`` (the model's loss over a mesh) and, for the
    in-batch softmax, ``towers`` and ``head``."""
    if family == "lm":
        return {"rows": "model", "split": model.split_loss}
    if family == "gnn":
        return {"rows": "node", "split": model.split_loss}
    if model.cfg.kind == "two_tower":
        from repro_torch.train.step import functional_loss

        return {"rows": "in_batch", "towers": functional_loss(model, model.towers),
                "head": model.in_batch_terms, "split": model.split_loss}
    return {"rows": "split", "split": model.split_loss}


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or wider where it is (a float64 copy of a model)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _splits_rows(spec) -> bool:
    spec = P(*spec) if not isinstance(spec, P) else spec
    return bool(spec) and spec[0] is not None


@dataclasses.dataclass
class ShardedTrainStep:
    """``step_(state, batch) -> (state, {"loss"})`` over a state of
    ``ShardedTensor``s (``shard``), updated in place; ``grads`` and
    ``apply_`` are its two parts."""

    loss_fn: Callable
    optimizer: Optimizer
    mesh: ShardMesh
    param_specs: Any
    # the batch's specs: a dict of ``P`` (``Cell.partition``), one ``P`` for
    # every key, or None for every key's rows over the data axes
    batch_spec: Any = None
    rows: str = "split"
    towers: Callable | None = None  # in_batch: towers(params, batch) -> (u, i)
    head: Callable | None = None    # in_batch: head(u, items, first) -> row terms
    # the loss over a mesh: split(params per mesh device, rows per data shard
    # (the batch under "node"), mesh, specs); "split" / "in_batch" use it on
    # a mesh whose "model" axis is larger than 1
    split: Callable | None = None
    microbatches: int = 1
    compression: bool = False

    def __post_init__(self):
        if self.rows not in ROWS:
            raise ValueError(f"rows must be one of {ROWS}, got {self.rows!r}")
        if self.rows == "in_batch" and (self.towers is None or self.head is None):
            raise ValueError("rows='in_batch' needs towers and head")
        if self.rows in ("model", "node") and self.split is None:
            raise ValueError(f"rows={self.rows!r} needs split")
        if self.rows == "node" and self.microbatches != 1:
            raise ValueError("rows='node' splits a graph's nodes, not its batch: "
                             "microbatches must be 1")
        if self._splits_model() and self.split is None:
            raise ValueError(f"rows={self.rows!r} on a mesh split over 'model' needs split")
        if not dp_axes(self.mesh):
            raise ValueError(f"mesh {self.mesh.axis_names} has no data axis")
        if self.mesh.lead.type == "meta":
            raise ValueError("a meta mesh holds nothing: it is for the dry run")
        self.placements = shard_tree(
            self.mesh, state_specs(self.optimizer, self.param_specs, self.compression))
        # the parameter bytes each mesh device computes with (its "model"
        # pieces, whole over the data axes; under a row split, every leaf
        # whole on each shard), set by each step
        self.compute_bytes: list | None = None

    # ------------------------------------------------------------------ state

    def shard(self, state) -> dict:
        """``train.step.init_state``'s tree laid out over the mesh."""
        return shard_state(state, self.placements)

    # ------------------------------------------------------------------ rows

    def _row_shards(self, batch: dict) -> list[tuple[torch.device, dict, int]]:
        """``(device, the shard's batch, its rows)`` of every compute shard."""
        keys = list(batch)
        rows = batch[keys[0]].shape[0]
        spec = self.batch_spec
        split = spec is None or (_splits_rows(spec) if not isinstance(spec, dict)
                                 else any(_splits_rows(spec[k]) for k in keys))
        if not split or n_shards(self.mesh) == 1:
            dev = self.mesh.lead if not split else shard_devices(self.mesh)[0]
            return [(dev, {k: v.to(dev) for k, v in batch.items()}, rows)]
        s = n_shards(self.mesh)
        step = -(-rows // s)
        out = []
        for i, dev in enumerate(shard_devices(self.mesh)):
            lo, hi = min(rows, i * step), min(rows, (i + 1) * step)
            if hi > lo:
                out.append((dev, {k: self._piece(k, v, lo, hi).to(dev)
                                  for k, v in batch.items()}, hi - lo))
        return out

    def _piece(self, key: str, v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        spec = self.batch_spec
        if isinstance(spec, dict) and not _splits_rows(spec[key]):
            return v
        return v[lo:hi]

    def _gathered(self, state, dev, cache: dict) -> tuple[Any, list]:
        """The parameters whole on ``dev``, gathered once per distinct device
        (shards of one card read one copy; ``cache`` holds it for a step)."""
        if dev not in cache:
            cache[dev] = gather_state(state["params"], dev)
        return cache[dev], leaves(cache[dev])

    # ----------------------------------------------------------------- grads

    def _splits_model(self) -> bool:
        """The step computes in pieces (module note): ``"model"``, ``"node"``,
        or a row plan on a mesh whose ``"model"`` axis is larger than 1."""
        mesh = self.mesh
        return self.rows in ("model", "node") or (
            "model" in mesh.axis_names and mesh.size("model") > 1)

    def grads(self, state, batch: dict) -> tuple[torch.Tensor, Any]:
        """(loss on the lead device, gradients): where the step computes in
        pieces (``"model"``, ``"node"``, a row plan over a ``"model"`` axis
        larger than 1) a tree of ``ShardedTensor``s in the parameters'
        pieces (``gather_state`` makes them whole), else whole tensors on
        the lead device; each in its parameter's dtype (float32 means over
        several microbatches in pieces, as ``TrainStep`` gives them)."""
        if self._splits_model():
            with active_mesh(self.mesh):
                return self._model_grads(state, batch)
        shards = self._row_shards(batch)
        with active_mesh(self.mesh):
            if self.rows == "in_batch" and len(shards) > 1:
                return self._in_batch_grads(state, shards)
            return self._row_grads(state, shards)

    def _row_grads(self, state, shards) -> tuple[torch.Tensor, Any]:
        from repro_torch.train.step import TrainStep

        self._whole_bytes(state, len(shards))
        lead = self.mesh.lead
        local = TrainStep(self.loss_fn, self.optimizer, self.microbatches)
        total = sum(n for _, _, n in shards)
        loss = acc = None
        cache: dict = {}
        for dev, b, n in shards:
            params, _ = self._gathered(state, dev, cache)
            l, g = local.grads(params, b)
            del params
            if len(shards) == 1:
                return l.to(lead), tree_map(lambda x: x.to(lead), g)
            w = torch.full((), n / total, dtype=torch.float32, device=lead)
            part = [_wide(x.to(lead)) * w for x in leaves(g)]
            del g
            acc = part if acc is None else [a + x for a, x in zip(acc, part)]
            loss = l.to(lead) * w if loss is None else loss + l.to(lead) * w
        dts = [s.dtype for s in leaves(state["params"])]
        return loss, unflatten(state["params"], [a.to(dt) for a, dt in zip(acc, dts)])

    def _microbatches(self, batch: dict) -> list:
        """What ``split`` takes for each microbatch: under ``"node"`` the
        batch itself; else the microbatch's rows (consecutive, as on one
        device) cut over the data shards (the last shorter or empty), a
        list of token tensors under ``"model"``, of batch dicts under a row
        plan (a key whose spec keeps its rows whole goes whole)."""
        if self.rows == "node":
            return [batch]
        keys = list(batch)
        rows = batch[keys[0]].shape[0]
        mbs = self.microbatches
        if rows % mbs:
            raise ValueError(f"batch size {rows} not divisible by microbatches {mbs}")
        per = rows // mbs
        d_shards = n_shards(self.mesh)
        step = -(-per // d_shards)
        out = []
        for mb in range(mbs):
            shards = []
            for s in range(d_shards):
                lo, hi = mb * per + min(per, s * step), mb * per + min(per, (s + 1) * step)
                shards.append({k: self._piece(k, v, lo, hi) for k, v in batch.items()})
            out.append([b["tokens"] for b in shards] if self.rows == "model" else shards)
        return out

    def _model_grads(self, state, batch: dict) -> tuple[torch.Tensor, Any]:
        """The plans that compute in pieces (module note): (loss on the lead
        device, the gradient as ``ShardedTensor``s in the parameters'
        pieces)."""
        mesh, lead = self.mesh, self.mesh.lead
        flat = leaves(state["params"])
        regions = [[s.model_region(i) for s in flat] for i in range(mesh.n_devices)]
        # each device's pieces, gathered over the data axes once per
        # (device, region) (a region that is one piece held on the device is
        # that piece, uncopied): the devices of one card read one copy, and
        # each device's leaves are its own autograd leaves
        cache: dict = {}
        live, self.compute_bytes = [], []
        for i, dev in enumerate(mesh.devices):
            row, held = [], 0
            for li, s in enumerate(flat):
                key = (dev, li, regions[i][li])
                if key not in cache:
                    cache[key] = s.region(regions[i][li], dev)
                t = cache[key]
                held += t.numel() * t.element_size()
                row.append(t.detach().requires_grad_(True))
            live.append(row)
            self.compute_bytes.append(held)
        del cache
        every = [t for row in live for t in row]
        n_leaves = len(flat)
        # for each leaf, each piece: the mesh devices whose region holds it
        # and the piece's slice of their gradient
        parts_of = []
        for li, s in enumerate(flat):
            per_piece = {}
            for piece in s.pieces:
                b = s.placement.bounds(s.shape, piece)
                per_piece[piece] = [
                    (i, tuple(slice(x.start - lo, x.stop - lo) for x, (lo, _) in zip(b, reg)))
                    for i, reg in ((i, regions[i][li]) for i in range(mesh.n_devices))
                    if all(x.start >= lo and x.stop <= hi for x, (lo, hi) in zip(b, reg))]
            parts_of.append(per_piece)
        acc: list = [{} for _ in flat]
        loss = None
        parts = self._microbatches(batch)
        mbs = len(parts)
        for shards in parts:
            with torch.enable_grad():
                l = self.split([unflatten(state["params"], row) for row in live], shards,
                               mesh, self.param_specs)
                g = torch.autograd.grad(l, every, allow_unused=True)
            l = l.detach()
            loss = l if loss is None else loss + l
            # the piece's sum over the devices that hold its region, in mesh
            # order, in the wide dtype (then over the microbatches); a device
            # whose copy the loss does not reach (a model shard past the
            # first of a recsys head) adds nothing
            for li, s in enumerate(flat):
                for piece, by_dev in s.pieces.items():
                    dev0 = next(iter(by_dev))
                    total = None
                    for i, rel in parts_of[li][piece]:
                        gi = g[i * n_leaves + li]
                        if gi is None:
                            continue
                        x = _wide(gi[rel].to(dev0))
                        total = x if total is None else total + x
                    if total is None:
                        b = s.placement.bounds(s.shape, piece)
                        total = torch.zeros(tuple(x.stop - x.start for x in b),
                                            dtype=torch.promote_types(s.dtype, torch.float32),
                                            device=dev0)
                    prev = acc[li].get(piece)
                    acc[li][piece] = total if prev is None else prev + total
            del g
        out = []
        for li, s in enumerate(flat):
            # one microbatch: the parameter's dtype, as on one device; more:
            # the float32 mean of the microbatches, as ``TrainStep`` gives it
            dt = s.dtype if mbs == 1 else torch.promote_types(s.dtype, torch.float32)
            pieces = {}
            for piece, by_dev in s.pieces.items():
                total = acc[li][piece]
                total = (total if mbs == 1 else total / mbs).to(dt)
                pieces[piece] = {d: total if j == 0 else total.to(d, copy=True)
                                 for j, d in enumerate(by_dev)}
            out.append(ShardedTensor(s.placement, s.shape, dt, pieces))
        if mbs > 1:
            loss = loss / mbs
        return loss.to(lead), unflatten(state["params"], out)

    def _whole_bytes(self, state, n: int) -> None:
        """``compute_bytes`` of a row split: every leaf whole on each of
        ``n`` compute shards."""
        whole = sum(math.prod(s.shape) * s.dtype.itemsize for s in leaves(state["params"]))
        self.compute_bytes = [whole] * n

    def _in_batch_grads(self, state, shards) -> tuple[torch.Tensor, Any]:
        self._whole_bytes(state, len(shards))
        lead = self.mesh.lead
        total = sum(n for _, _, n in shards)
        fwd = []
        cache: dict = {}
        for dev, b, _ in shards:
            params, flat = self._gathered(state, dev, cache)
            live = [p.detach().requires_grad_(True) for p in flat]
            with torch.enable_grad():
                u, i = self.towers(unflatten(params, live), b)
            fwd.append((live, u, i))
            del params, flat
        items = [_wide(i.detach()) for _, _, i in fwd]  # the all-gather
        loss = d_items = None
        d_users = []
        first = 0
        for (dev, _, n), (_, u, _) in zip(shards, fwd):
            every = torch.cat([it.to(dev) for it in items]).requires_grad_(True)
            ul = u.detach().requires_grad_(True)
            with torch.enable_grad():
                part = torch.sum(self.head(ul, every, first)) / total
                gu, gi = torch.autograd.grad(part, [ul, every])
            d_users.append(gu)
            loss = part.detach().to(lead) if loss is None else loss + part.detach().to(lead)
            d_items = gi.to(lead) if d_items is None else d_items + gi.to(lead)
            del every, gi
            first += n
        acc = None
        first = 0
        for (dev, _, n), (live, u, i), gu in zip(shards, fwd, d_users):
            gi = d_items[first:first + n].to(dev).to(i.dtype)  # the reduce-scatter
            g = torch.autograd.grad([u, i], live, [gu, gi], allow_unused=True,
                                    materialize_grads=True)
            part = [_wide(x.to(lead)) for x in g]
            acc = part if acc is None else [a + x for a, x in zip(acc, part)]
            first += n
        del fwd
        dts = [s.dtype for s in leaves(state["params"])]
        return loss, unflatten(state["params"], [a.to(dt) for a, dt in zip(acc, dts)])

    # ----------------------------------------------------------------- apply

    @torch.no_grad()
    def apply_(self, state, grads) -> dict:
        """Compression, the optimizer and the step counts, written into
        ``state``'s pieces in place; returns ``state``."""
        lead = self.mesh.lead
        opt = self.optimizer
        if self.compression:
            out = []
            for g, r in zip(leaves(grads), leaves(state["residual"])):
                deq, new_r = int8_error_feedback([_whole(g, lead)], [r.gather(lead)])
                r.scatter_(new_r[0])
                out.append(deq[0])
            grads = unflatten(grads, out)
        sc = opt.prepare(grads, {"step": state["opt"]["step"].gather(lead)})
        for p, g, s in zip(leaves(state["params"]), leaves(grads),
                           opt.split(state["opt"], state["params"])):
            if opt.elementwise:
                self._pieces_(p, g, s, sc)
            else:
                new_p, new_s = opt.leaf(p.gather(lead), _whole(g, lead),
                                        {k: v.gather(lead) for k, v in s.items()}, sc)
                p.scatter_(new_p)
                for k, v in new_s.items():
                    s[k].scatter_(v)
        state["opt"]["step"].scatter_(sc["step"])
        state["step"].scatter_(state["step"].gather(lead) + 1)
        return state

    def _pieces_(self, p: ShardedTensor, g, s: dict, sc: dict) -> None:
        """One elementwise update of every piece of ``p`` on its device, from
        the gradient's piece (``g`` whole, or in ``p``'s pieces)."""
        for piece, by_dev in p.pieces.items():
            b = p.placement.bounds(p.shape, piece)
            for dev, pt in by_dev.items():
                gp = g.pieces[piece][dev] if isinstance(g, ShardedTensor) else g[b].to(dev)
                self.optimizer.leaf_(pt, gp, {k: v.pieces[piece][dev] for k, v in s.items()},
                                     {k: v.to(dev) for k, v in sc.items()})

    def step_(self, state, batch: dict) -> tuple[dict, dict]:
        loss, grads = self.grads(state, batch)
        return self.apply_(state, grads), {"loss": loss}


def make_sharded_train_step(loss_fn: Callable, optimizer: Optimizer, mesh: ShardMesh,
                            param_specs, batch_spec=None, **kw) -> ShardedTrainStep:
    """The sharded step of ``loss_fn(params, batch)``; ``kw``: ``rows``,
    ``towers``, ``head``, ``split`` (``plan_for``), ``microbatches``,
    ``compression``."""
    return ShardedTrainStep(loss_fn, optimizer, mesh, param_specs, batch_spec, **kw)


def sharded_step_for(family: str, model, optimizer: Optimizer, mesh: ShardMesh,
                     **kw) -> ShardedTrainStep:
    """``make_sharded_train_step`` for a port model of ``family``: its loss,
    its ``param_specs(mesh)`` and its plan (``plan_for``)."""
    from repro_torch.configs.common import loss_for
    from repro_torch.train.step import functional_loss

    loss_fn = functional_loss(model, loss_for(family, model))
    return make_sharded_train_step(loss_fn, optimizer, mesh, model.param_specs(mesh),
                                   **plan_for(family, model), **kw)
