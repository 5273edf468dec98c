"""PNA (Principal Neighbourhood Aggregation, arXiv:2004.05718) of the port —
``repro.models.gnn`` in PyTorch.

Message passing over an edge-index (src, dst) representation: gathers
``h[src]`` / ``h[dst]`` and segment reductions over the destinations.
Aggregators: mean / max / min / std; scalers: identity / amplification /
attenuation (log-degree over the train-set average log-degree).  Update:
h' = U([h || concat(scaled aggregations)]).  Full-graph and sampled-subgraph
node classification, and batched small graphs with a graph-level readout
(``graph_id`` segment mean + classifier).

``PNAModel`` is a ``models.params.ParamModule``: the reference's flat tree
under its names, built on ``meta`` and placed by ``init_params`` (the
reference's distribution: zeros for ``b_*``, normal / sqrt(fan-in)
otherwise) or ``load_jax_params``; ``forward(batch)`` and
``loss_fn(batch)`` take the batch alone.  Float32 products run in IEEE
float32 (``check_ieee_fp32``).

Segment reductions follow the reference's ``jax.ops.segment_*``:

* an id outside ``[0, n)`` is dropped (JAX's scatter mode), through a drop
  row past the last segment, so no write on the card is out of range;
* ``segment_sum`` adds each segment's rows in their order, one add at a
  time, on either device, so a sum never depends on the order of atomic
  adds and a step run twice gives the same bits: on a CUDA tensor
  ``index_put_(accumulate=True)`` (it sorts the ids stably and adds each
  run of equal ids in one thread; ``index_add_`` would add atomically), on
  the CPU ``index_add_`` (a serial loop over the rows; ``index_put_``
  there adds from several threads).  The gathers ``h[src]`` / ``h[dst]``
  (``take_rows``) take their backward, a scatter-add, from the same
  ``segment_sum``;
* ``segment_max`` / ``segment_min`` are ``scatter_reduce`` (``amax`` /
  ``amin``, ``include_self=False``) from a -inf / +inf start, so an empty
  segment keeps the reference's filler before the ``isfinite`` fill.  Their
  backward shares a gradient evenly among ties, as JAX's does.

The std's ``maximum(var, 0)`` is ``torch.maximum`` with a tensor: at a tie
(a degree-1 node's variance is exactly 0) both it and ``jnp.maximum`` pass
half the gradient, where ``clamp_min`` would pass all of it.  A quotient
with a constant on either side is one tensor division (torch would
multiply by a reciprocal).

``param_specs`` is the reference's (every weight replicated: the sharded
objects are the node and edge rows, ``Cell.partition``); ``batch_axes``
pins the node and edge rows, which ``maybe_constrain`` checks inside a
sharded step.
``partition_edges`` is a host (numpy) function, a copy of the reference's
(``tests/test_torch_copies.py`` pins it).

**Over node shards** (``split_loss`` / ``split_forward``, the sharded
step's ``"node"`` plan): the counterpart of the reference's partitioned
forward under ``Cell.partition``, which splits the nodes and the edge
blocks over every mesh axis.  The node shards are the mesh devices in mesh
order, R of them; device ``r`` holds node rows ``[r N / R, (r + 1) N /
R)`` and edge blocks ``[r S / R, (r + 1) S / R)``.  A block holds every
edge into its nodes, so the degrees, the scalers and the segment ops are
the device's own, over its blocks' edges in the one-device order.  Each
layer all-gathers ``h`` over every axis (the halo, ``parallel.collectives``;
its transpose reduce-scatters the gradient in mesh order), gathers ``hs``
from it and ``hd`` from the device's rows, and updates the device's rows.
The readout's sums go through ``all_reduce``: the masked loss's sum and
count (node level), the pooled ``(G, d)`` sums and counts (graph level: a
graph's nodes may span shards).  The weights are replicated, so each
device's gradient of them is a partial.  R must divide the blocks and the
nodes, and a flat batch splits over one node shard only: otherwise it
raises (``partition_edges`` makes the layout).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.distances import check_ieee_fp32
from repro_torch.models.params import ParamModule
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import P, maybe_constrain

__all__ = ["PNAConfig", "PNAModel"]

_AGGS = ("mean", "max", "min", "std")
_SCALERS = ("identity", "amplification", "attenuation")


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str
    n_layers: int
    d_hidden: int
    d_feat: int
    n_classes: int
    avg_log_deg: float = 3.0
    graph_level: bool = False
    dtype: Any = torch.float32
    optimizer: str = "adamw"
    microbatches: int = 1
    batch_axes: tuple | None = None  # mesh axes for node/edge row sharding


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.float32:
        check_ieee_fp32(a)
    return a @ b


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _in_range(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``ids`` as int64, any id outside [0, n) sent to the drop row ``n``."""
    ids = ids.long()
    return torch.where((ids >= 0) & (ids < n), ids, n)


def segment_sum(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(vals, ids, num_segments=n)``: (n, ...), each
    segment's rows added in their order (see the module note)."""
    out = torch.zeros((n + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    idx = _in_range(ids, n)
    if vals.is_cuda:
        out.index_put_((idx,), vals, accumulate=True)
    else:
        out.index_add_(0, idx, vals)
    return out[:n]


class _TakeRows(torch.autograd.Function):
    """``h[idx]`` whose backward is ``segment_sum`` of the gradient."""

    @staticmethod
    def forward(ctx, h, idx):
        ctx.save_for_backward(idx)
        ctx.n = h.shape[0]
        return h[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return segment_sum(grad, idx, ctx.n), None


def take_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (int64, in range) of ``h``; the backward adds each row's
    gradients in order, on either device."""
    return _TakeRows.apply(h, idx)


def _segment_extreme(vals: torch.Tensor, ids: torch.Tensor, n: int, reduce: str) -> torch.Tensor:
    fill = float("-inf") if reduce == "amax" else float("inf")
    out = torch.full((n + 1,) + tuple(vals.shape[1:]), fill, dtype=vals.dtype,
                     device=vals.device)
    idx = _in_range(ids, n).reshape((-1,) + (1,) * (vals.ndim - 1)).expand_as(vals)
    return out.scatter_reduce(0, idx, vals, reduce, include_self=False)[:n]


def segment_max(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_max``: -inf in an empty segment."""
    return _segment_extreme(vals, ids, n, "amax")


def segment_min(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_min``: +inf in an empty segment."""
    return _segment_extreme(vals, ids, n, "amin")


def _finite_or_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(a), a, torch.zeros((), dtype=a.dtype, device=a.device))


class PNAModel(ParamModule):
    """PNA over a ``PNAConfig``; see the module note."""

    def param_shapes(self) -> dict:
        c = self.cfg
        d = c.d_hidden
        n_mix = len(_AGGS) * len(_SCALERS)  # 12
        return {
            "w_in": ((c.d_feat, d), c.dtype),
            "w_msg": ((c.n_layers, 2 * d, d), c.dtype),
            "b_msg": ((c.n_layers, d), c.dtype),
            "w_upd": ((c.n_layers, (1 + n_mix) * d, d), c.dtype),
            "b_upd": ((c.n_layers, d), c.dtype),
            "w_out": ((d, c.n_classes), c.dtype),
        }

    def _zero_init(self, name: str) -> bool:
        return name.startswith("b_")

    def param_specs(self, mesh) -> dict:
        """GNN weights are tiny (75-wide): replicated, as in the reference;
        the sharded objects are the node and edge arrays (``Cell.partition``)."""
        return {k: P(*([None] * len(s))) for k, (s, _) in self.param_shapes().items()}

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        """The reference pins node / edge rows over ``batch_axes`` here."""
        axes = self.cfg.batch_axes
        if axes is None:
            return t
        return maybe_constrain(t, P(tuple(axes), *([None] * (t.ndim - 1))))

    # ----------------------------------------------------------------- forward

    def forward(self, batch: dict) -> torch.Tensor:
        """Two edge layouts:

        FLAT: edge_src (E,), edge_dst (E,) global ids.

        DST-PARTITIONED (DistDGL-style): edges presorted by destination and
        packed per node block — edge_src (S, E_loc) global ids,
        edge_dst_local (S, E_loc) ids local to block s, edge_valid
        (S, E_loc).

        Returns node logits (N, C) or graph logits (G, C), float32."""
        if "edge_valid" in batch:
            return self._forward_partitioned(batch)
        return self._forward_flat(batch)

    def _scalers(self, deg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        logd = torch.log1p(deg)[:, None]  # (N, 1)
        avg = _const(c.avg_log_deg, logd)
        s_amp = torch.div(logd, avg)
        s_att = torch.div(avg, torch.clamp_min(logd, 1e-2))
        return s_amp, s_att

    def _update(self, h, w_upd, b_upd, s_cnt, s_sum, a_max, a_min, sq, s_amp, s_att):
        a_mean = s_sum / s_cnt
        a_max = _finite_or_zero(a_max)
        a_min = _finite_or_zero(a_min)
        # +eps inside sqrt: d/dx sqrt(x) -> inf at x=0 (deg<=1 nodes have
        # exactly zero variance, which NaNs the backward pass otherwise)
        var = sq / s_cnt - a_mean * a_mean
        a_std = torch.sqrt(torch.maximum(var, torch.zeros((), dtype=var.dtype,
                                                          device=var.device)) + 1e-6)
        # the scalers: identity (the reference's ``a * 1.0``, the same
        # bits), amplification, attenuation
        mixed = [h] + [t for a in (a_mean, a_max, a_min, a_std)
                       for t in (a, a * s_amp, a * s_att)]
        z = torch.cat(mixed, dim=-1)  # (N, 13d)
        return torch.relu(_mm(z, w_upd) + b_upd) + h

    def _readout(self, h: torch.Tensor, batch: dict) -> torch.Tensor:
        if self.cfg.graph_level:
            gid = batch["graph_id"]
            g = batch["labels"].shape[0]
            pooled = segment_sum(h, gid, g)
            cnt = segment_sum(torch.ones((h.shape[0], 1), dtype=h.dtype, device=h.device),
                              gid, g)
            h = pooled / torch.clamp_min(cnt, 1.0)
        return _mm(h, self.w_out).float()

    def _forward_flat(self, batch: dict) -> torch.Tensor:
        c = self.cfg
        x = batch["x"].to(c.dtype)
        src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
        n = x.shape[0]
        deg = segment_sum(torch.ones(dst.shape, dtype=c.dtype, device=x.device), dst, n)
        s_amp, s_att = self._scalers(deg)
        s_cnt = torch.clamp_min(deg[:, None], 1.0)

        h = _mm(x, self.w_in)
        for layer in range(c.n_layers):
            m_in = torch.cat([self._rows(take_rows(h, src)), self._rows(take_rows(h, dst))],
                             dim=-1)
            m = torch.relu(_mm(m_in, self.w_msg[layer]) + self.b_msg[layer])  # (E, d)
            h = self._update(h, self.w_upd[layer], self.b_upd[layer], s_cnt,
                             segment_sum(m, dst, n), segment_max(m, dst, n),
                             segment_min(m, dst, n), segment_sum(m * m, dst, n), s_amp, s_att)
        return self._readout(h, batch)

    def _forward_partitioned(self, batch: dict) -> torch.Tensor:
        c = self.cfg
        x = batch["x"].to(c.dtype)                 # (N, F)
        src = batch["edge_src"].long()             # (S, E_loc) global ids
        dstl = batch["edge_dst_local"].long()      # (S, E_loc) block-local ids
        valid = batch["edge_valid"]                # (S, E_loc)
        n = x.shape[0]
        s_blocks, e_loc = src.shape
        n_loc = n // s_blocks
        vmask = valid.to(c.dtype)[..., None]       # (S, E_loc, 1)
        # the reference's per-block segment ops (a vmap over blocks with
        # block-local ids) are segment ops over the global ids
        dst = (dstl + (torch.arange(s_blocks, device=x.device) * n_loc)[:, None]).reshape(-1)
        src_flat = src.reshape(-1)

        deg = segment_sum(valid.to(c.dtype).reshape(-1), dst, n)
        s_amp, s_att = self._scalers(deg)
        s_cnt = torch.clamp_min(deg[:, None], 1.0)
        p = self._p()
        h = _mm(x, self.w_in)
        for layer in range(c.n_layers):
            hs = take_rows(h, src_flat).reshape(s_blocks, e_loc, -1)  # halo gather
            hd = take_rows(h, dst).reshape(s_blocks, e_loc, -1)
            h = self._block_layer(h, hs, hd, vmask, dst, self._layer_params(p, layer),
                                  s_cnt, s_amp, s_att)
        return self._readout(h, batch)

    @staticmethod
    def _layer_params(p: dict, layer: int) -> tuple:
        return p["w_msg"][layer], p["b_msg"][layer], p["w_upd"][layer], p["b_upd"][layer]

    def _block_layer(self, h, hs, hd, vmask, dst, lp, s_cnt, s_amp, s_att):
        """One layer of the partitioned forward over blocks (S, E_loc):
        messages from the gathered rows ``hs`` / ``hd``, the segment ops
        over ``dst`` (ids into ``h``'s rows), ``h``'s rows updated."""
        w_msg, b_msg, w_upd, b_upd = lp
        n = h.shape[0]
        s_blocks, e_loc = vmask.shape[:2]
        m_in = torch.cat([hs, hd], dim=-1)
        m = torch.relu(_mm(m_in, w_msg) + b_msg) * vmask
        live = vmask > 0
        flat = m.reshape(s_blocks * e_loc, -1)
        return self._update(
            h, w_upd, b_upd, s_cnt, segment_sum(flat, dst, n),
            segment_max(torch.where(live, m, _const(float("-inf"), vmask)).reshape(flat.shape),
                        dst, n),
            segment_min(torch.where(live, m, _const(float("inf"), vmask)).reshape(flat.shape),
                        dst, n),
            segment_sum(flat * flat, dst, n), s_amp, s_att)

    # ------------------------------------------------------- over node shards

    def split_forward(self, params: list, batch: dict, mesh, specs=None,
                      probe: bool = False) -> list:
        """``forward`` over node shards (the module note): each mesh
        device's logits, its node rows' (N / R, C) at node level, the
        graphs' (G, C) at graph level (the all-reduced pooling; read on
        device 0, ``None`` on the others).  ``params[r]``: device r's tree
        (every leaf whole: the specs replicate it); ``probe`` (meta only:
        the dry run) computes mesh device 0 alone."""
        return self._split_logits(params, batch, mesh, probe)[1]

    def _split_logits(self, params: list, batch: dict, mesh, probe: bool):
        sh, hs = self._split_trunk(params, batch, mesh, probe)
        if not self.cfg.graph_level:
            return sh, sh.each(lambda r, p, h: _mm(h, p["w_out"]).float(), params, hs)
        g = batch["labels"].shape[0]

        def pool(r, h, gid):
            ones = torch.ones((h.shape[0], 1), dtype=h.dtype, device=h.device)
            return torch.cat([segment_sum(h, gid, g), segment_sum(ones, gid, g)], dim=-1)

        pooled = sh.over_all(coll.all_reduce, sh.each(pool, hs, sh.node("graph_id")))
        out = [None] * sh.R
        tot = pooled[0]
        h = tot[:, :-1] / torch.clamp_min(tot[:, -1:], 1.0)
        out[0] = _mm(h, params[0]["w_out"]).float()
        return sh, out

    def split_loss(self, params: list, batch: dict, mesh, specs=None,
                   probe: bool = False) -> torch.Tensor:
        """``loss_fn`` over node shards (the module note), on the mesh's lead
        device: node level, each device's masked sum and count of its rows'
        cross-entropies all-reduced, then divided; graph level, the mean
        over the graphs of the pooled logits."""
        if "edge_valid" not in batch and mesh.n_devices > 1:
            raise ValueError(
                f"a flat edge list cannot be split over {mesh.n_devices} node shards: "
                "give the dst-partitioned layout (PNAModel.partition_edges)")
        if "edge_valid" not in batch:
            from repro_torch.train.step import functional_loss

            return functional_loss(self, self.loss_fn)(params[0], batch).to(mesh.lead)
        sh, logits = self._split_logits(params, batch, mesh, probe)
        if self.cfg.graph_level:
            return _nll_mean(logits[0], batch["labels"].to(logits[0].device), None).to(mesh.lead)
        labels = sh.node("labels")
        mask = sh.node("label_mask") if "label_mask" in batch else None

        def sums(r, lg, lab, mk):
            nll = _nll(lg, lab)
            if mk is None:
                return torch.stack([torch.sum(nll), _const(float(nll.shape[0]), nll)])
            return torch.stack([torch.sum(nll * mk), torch.sum(mk).to(nll.dtype)])

        tot = sh.over_all(coll.all_reduce, sh.each(
            sums, logits, labels, mask if mask is not None else [None] * sh.R))[0]
        return (tot[0] / torch.clamp_min(tot[1], 1.0)).to(mesh.lead)

    def _split_trunk(self, params: list, batch: dict, mesh, probe: bool):
        """The embedding and the layers over node shards: the layout and
        each device's final rows (N / R, d)."""
        c = self.cfg
        sh = _NodeSplit(batch, mesh, probe)
        x = sh.node("x")
        src = sh.block("edge_src")
        dstl = sh.block("edge_dst_local")
        valid = sh.block("edge_valid")

        def local(r, x_r, dl, v):
            s_r, _ = dl.shape
            dst = (dl.long() + (torch.arange(s_r, device=dl.device) * sh.n_loc)[:, None]
                   ).reshape(-1)
            deg = segment_sum(v.to(c.dtype).reshape(-1), dst, x_r.shape[0])
            s_amp, s_att = self._scalers(deg)
            return dst, v.to(c.dtype)[..., None], torch.clamp_min(deg[:, None], 1.0), s_amp, s_att

        loc = sh.each(local, x, dstl, valid)
        hs = sh.each(lambda r, p, x_r: _mm(x_r.to(c.dtype), p["w_in"]), params, x)
        for layer in range(c.n_layers):
            whole = sh.over_all(coll.all_gather, hs, 0)  # the halo

            def step(r, p, h, hw, s_r, lc):
                dst, vmask, s_cnt, s_amp, s_att = lc
                s_b, e_loc = vmask.shape[:2]
                h_s = take_rows(hw, s_r.long().reshape(-1)).reshape(s_b, e_loc, -1)
                h_d = take_rows(h, dst).reshape(s_b, e_loc, -1)
                return self._block_layer(h, h_s, h_d, vmask, dst, self._layer_params(p, layer),
                                         s_cnt, s_amp, s_att)

            hs = sh.each(step, params, hs, whole, src, loc)
        return sh, hs

    @staticmethod
    def partition_edges(src, dst, n_pad: int, s_blocks: int = 512,
                        e_loc: int | None = None):
        """Host-side converter: flat edge list -> dst-partitioned layout.

        Sorts edges by destination block, packs each block's edges into a
        fixed-width row (padding with invalid edges).  Production graph
        loaders emit this directly (one block per node shard)."""
        import numpy as np

        src = np.asarray(src)
        dst = np.asarray(dst)
        n_loc = n_pad // s_blocks
        block = dst // n_loc
        order = np.argsort(block, kind="stable")
        src, dst, block = src[order], dst[order], block[order]
        counts = np.bincount(block, minlength=s_blocks)
        if e_loc is None:
            e_loc = max(1, int(counts.max()))
        out_src = np.zeros((s_blocks, e_loc), np.int32)
        out_dstl = np.zeros((s_blocks, e_loc), np.int32)
        out_valid = np.zeros((s_blocks, e_loc), bool)
        starts = np.concatenate([[0], np.cumsum(counts)])
        for b in range(s_blocks):
            take = min(int(counts[b]), e_loc)  # overflow edges dropped
            sl = slice(starts[b], starts[b] + take)
            out_src[b, :take] = src[sl]
            out_dstl[b, :take] = dst[sl] - b * n_loc
            out_valid[b, :take] = True
        return out_src, out_dstl, out_valid

    def loss_fn(self, batch: dict) -> torch.Tensor:
        """Cross-entropy of the logits, over the nodes ``label_mask`` keeps
        (all nodes, or all graphs, without one)."""
        return _nll_mean(self.forward(batch), batch["labels"], batch.get("label_mask"))


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return logz - gold


def _nll_mean(logits: torch.Tensor, labels: torch.Tensor, mask) -> torch.Tensor:
    nll = _nll(logits, labels)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


class _NodeSplit:
    """Where a node-shard step computes (the module note): R node shards,
    the mesh devices in mesh order, and each one's rows of a batch."""

    def __init__(self, batch: dict, mesh, probe: bool = False):
        self.mesh, self.batch, self.probe = mesh, batch, probe
        self.R = R = mesh.n_devices
        self.N = n = batch["x"].shape[0]
        self.S = s = batch["edge_src"].shape[0]
        if s % R or n % R or n % s:
            raise ValueError(
                f"{R} node shards must divide the {s} edge blocks and the {n} nodes, and "
                f"the blocks the nodes (PNAModel.partition_edges lays them out)")
        self.n_loc = n // s
        self.axes = tuple(mesh.axis_names)

    def each(self, fn, *lists) -> list:
        """``[fn(r, *(l[r] for l in lists))]``; under ``probe`` rank 0's
        result stands for every rank's."""
        if self.probe:
            return [fn(0, *(lst[0] for lst in lists))] * self.R
        return [fn(r, *(lst[r] for lst in lists)) for r in range(self.R)]

    def _rows(self, key: str, total: int) -> list:
        k = total // self.R
        return self.each(lambda r: self.batch[key][r * k:(r + 1) * k].to(self.mesh.devices[r]))

    def node(self, key: str) -> list:
        """Each device's node rows of ``batch[key]``."""
        return self._rows(key, self.N)

    def block(self, key: str) -> list:
        """Each device's edge blocks of ``batch[key]``."""
        return self._rows(key, self.S)

    def over_all(self, fn, xs: list, *args) -> list:
        """The collective ``fn`` over every mesh axis (one group, mesh order)."""
        return fn(xs, self.mesh, self.axes, *args, probe=self.probe)
