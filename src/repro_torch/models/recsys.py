"""RecSys architectures of the port — ``repro.models.recsys`` in PyTorch:
Wide&Deep, DIN, two-tower retrieval, DLRM-RM2.

The hot path is the sparse embedding lookup: stacked tables (T, V, D)
gathered one id per field (``embedding_lookup``) or as a multi-hot bag
(``embedding_bag``).  Each model is an ``nn.Module`` whose parameters are
the reference's tree, under the reference's names: ``tables``, ``wide``,
``item_table`` and the ``*_tables`` as parameters, the MLPs as
``ParameterList``s ``*_w`` / ``*_b`` in the reference's ``(in, out)`` layout,
applied as ``x @ w + b`` (no ``nn.Linear``, which stores ``(out, in)``).

A model is built on the ``meta`` device, so a full configuration costs
nothing until ``init_params`` (the reference's distribution from a
``torch.Generator``) or ``load_jax_params`` (the reference's own numbers)
puts its parameters on a device: the CUDA device unless the caller passes
``device="cpu"``, raising where there is no card (``models.params``, shared
with the LM family).

The two-tower model is the paper-integration point: its item tower fills
the corpus that the supermetric BSS index (``repro_torch.core.flat_index``)
serves exactly (the ``retrieval_cand`` cell scores 1M candidates).  Float32
products run in IEEE float32 (``check_ieee_fp32``): TF32 would move a score
by ~1e-3.  Ids index the tables unchecked inside a pass, as in the
reference: check ids from outside with ``check_ids`` where they are made.

**Over a mesh** (``split_loss``, the sharded step's ``"split"`` and
``"in_batch"`` plans on a mesh whose ``"model"`` axis is larger than 1):
mesh device ``r`` is data shard ``r // m`` and model shard ``r % m``
(``layers.SplitLayout``), and holds rows ``[j V / m, (j + 1) V / m)`` of
each table its spec splits over ``"model"`` (pieces of ``ceil(V / m)``):
the stacked tables, and a single table of at least 65,536 rows (DIN's
``item_table``, Wide&Deep's ``wide``).  A lookup on model shard ``j``
reads the ids in its range and gives ``-0.0`` rows for the rest
(``take_piece``); the pieces are combined over ``"model"`` by
``parallel.collectives.all_reduce``.  Each row has one owner, and
``x + (-0.0)`` is ``x`` for every ``x`` (a ``-0.0`` row included, where
a ``+0.0`` filler would give ``+0.0``), so the combined rows equal one
device's lookup bit for bit in any order.  The MLPs, DIN's attention and
DLRM's interaction run on each data shard's rows over replicated weights
(the specs keep them ``P(None, ...)``), once, on the data shard's model
shard 0, where the loss is read (its other model shards would compute the
same values; ``_TableSplit.heads``).  The backward pass adds a piece's gradient rows on the
device that holds it, in batch order (``index_put_(accumulate=True)``, as a
one-device lookup's backward adds them), so no table gradient is formed
whole.  The two tower's item rows are then
all-gathered over the data axes for the in-batch softmax, as the
one-device-per-shard plan gathers them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from repro_torch.core.distances import check_ieee_fp32
from repro_torch.models import layers
from repro_torch.models.params import ParamModule, _is_leaf, cast_model, check_ids, load_jax_params
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import P, maybe_constrain

__all__ = [
    "RecsysConfig",
    "WideDeepModel",
    "DINModel",
    "TwoTowerModel",
    "DLRMModel",
    "bce_loss",
    "embedding_lookup",
    "embedding_bag",
    "take_piece",
    "bce_terms",
    "check_ids",
    "load_jax_params",
    "cast_model",
    "pruned_block_keys",
    "lexsort_rows",
]


def embedding_lookup(tables: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tables (T, V, D), idx (B, T) one id per field -> (B, T, D)."""
    t = tables.shape[0]
    return tables[torch.arange(t, device=tables.device)[None, :], idx.long()]


def embedding_bag(
    table: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor | None = None,
    combine: str = "mean",
) -> torch.Tensor:
    """table (V, D), idx (B, L) multi-hot bag -> (B, D): gather + masked
    reduce (the reference's formulation of nn.EmbeddingBag)."""
    e = table[idx.long()]  # (B, L, D)
    if valid is not None:
        e = e * valid[..., None].to(e.dtype)
        denom = torch.clamp_min(valid.sum(dim=-1, keepdim=True), 1).to(e.dtype)
    else:
        denom = torch.tensor(idx.shape[1], dtype=e.dtype, device=e.device)
    s = e.sum(dim=1)
    return s / denom if combine == "mean" else s


class _PieceRows(torch.autograd.Function):
    """Rows ``flat`` of a (n, D) table piece, ``-0.0`` where ``flat`` is past
    the piece (a drop row of its own for each such id); the backward adds
    each row's gradients into the piece in batch order by
    ``index_put_(accumulate=True)``, the op of a one-device lookup's
    backward (sorted by id, each run of equal ids added in order, on the
    card; on the CPU as ordered as the one-device lookup's own, serial in
    one thread), the drop rows discarded.  One drop row for all would be
    one run of every other shard's ids, added by one thread on the card."""

    @staticmethod
    def forward(ctx, table, flat):
        n = table.shape[0]
        ctx.save_for_backward(flat)
        ctx.n = n
        rows = table[torch.clamp_max(flat, n - 1)]
        neg0 = torch.full((), -0.0, dtype=table.dtype, device=table.device)
        return torch.where((flat < n)[..., None], rows, neg0)

    @staticmethod
    def backward(ctx, grad):
        (flat,) = ctx.saved_tensors
        d = grad.shape[-1]
        out = torch.zeros((ctx.n + flat.numel(), d), dtype=grad.dtype, device=grad.device)
        out.index_put_((flat.reshape(-1),), grad.reshape(-1, d), accumulate=True)
        return out[:ctx.n], None


def take_piece(piece: torch.Tensor, ids: torch.Tensor, v0: int) -> torch.Tensor:
    """The rows of ``ids`` that lie in a table's row piece ``[v0, v0 + Vp)``,
    ``-0.0`` rows for the others: ``piece`` (Vp, D) with ids of any shape,
    or a stacked piece (T, Vp, D) with ids (B, T), one per field (the
    module note).  With the whole table (``v0 = 0``) it is the lookup of
    ``embedding_lookup`` / ``table[ids]``, bit for bit."""
    vp, d = piece.shape[-2], piece.shape[-1]
    local = ids.long() - v0
    here = (local >= 0) & (local < vp)
    n = vp
    if piece.ndim == 3:
        n = piece.shape[0] * vp
        local = local + torch.arange(piece.shape[0], device=ids.device) * vp
    drop = n + torch.arange(local.numel(), device=ids.device).reshape(local.shape)
    flat = torch.where(here, local, drop)
    return _PieceRows.apply(piece.reshape(n, d), flat)


def _mlp_shapes(dims: Sequence[int], dtype) -> list:
    return [((dims[i], dims[i + 1]), dtype) for i in range(len(dims) - 1)]


def _mlp_apply(x, ws, bs, final_act=False):
    if x.dtype == torch.float32:
        check_ieee_fp32(x)
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = x @ w + b
        if i < len(ws) - 1 or final_act:
            x = torch.relu(x)
    return x


def _constrain_rows(x, batch_axes):
    """The reference pins an embedding lookup's row sharding here
    (``maybe_constrain`` checks the spec inside a sharded step)."""
    if batch_axes is None:
        return x
    return maybe_constrain(x, P(tuple(batch_axes), *([None] * (x.ndim - 1))))


def _fp32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a.float() @ b.float()`` in IEEE float32 (a float64 copy of a model,
    which the reference has no counterpart of, multiplies in float64)."""
    dt = torch.promote_types(a.dtype, torch.float32)
    a = a.to(dt)
    if dt == torch.float32:
        check_ieee_fp32(a)
    return a @ b.to(dt)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                      # wide_deep | din | two_tower | dlrm
    n_sparse: int = 26
    n_dense: int = 0
    embed_dim: int = 64
    vocab: int = 1_000_000         # rows per table (the 10^6 regime of the
                                   # public DLRM / Criteo literature)
    mlp: tuple = (1024, 512, 256)
    bot_mlp: tuple = ()
    attn_mlp: tuple = (80, 40)
    hist_len: int = 100
    tower_mlp: tuple = (1024, 512, 256)
    n_user_fields: int = 8
    n_item_fields: int = 4
    dtype: torch.dtype = torch.bfloat16
    optimizer: str = "adamw"
    microbatches: int = 1
    batch_axes: tuple | None = None


class _RecsysModule(ParamModule):
    def param_specs(self, mesh) -> dict:
        """The reference's specs: stacked tables (T, V, D) and a big single
        table (>= 65,536 rows) row-sharded over ``"model"``, the rest
        replicated (the tables too on a mesh without a "model" axis, where
        the reference's raise)."""
        model = "model" if "model" in mesh.axis_names else None

        def spec(v):
            shape, _ = v
            if len(shape) == 3:  # stacked tables (T, V, D): rows over model
                return P(None, model, None)
            if len(shape) == 2 and shape[0] >= 65536:  # big single table
                return P(model, None)
            return P(*([None] * len(shape)))

        return {k: spec(v) if _is_leaf(v) else [spec(x) for x in v]
                for k, v in self.param_shapes().items()}

    def split_loss(self, params: list, batches: list, mesh, specs: dict,
                   probe: bool = False) -> torch.Tensor:
        """``bce_loss`` over a mesh (the module note): ``params[r]`` mesh
        device r's tree (each table its "model" piece, the rest whole),
        ``batches[s]`` data shard s's rows.  Returns ``sum_s (B_s / B)
        loss_s`` on the mesh's lead device (one data shard: its loss);
        ``probe`` (meta only: the dry run) computes mesh device 0 alone."""
        ts = _TableSplit(self, params, batches, mesh, specs, probe)
        logits = self._split_logits(ts)
        means = ts.heads(lambda r, lg, b: torch.mean(bce_terms(lg, b["label"].float())),
                         logits, ts.batch)
        return ts.weighted(means)

    def split_forward(self, params: list, batches: list, mesh, specs: dict) -> list:
        """``forward`` over a mesh: each mesh device's logits of its data
        shard's rows."""
        return self._split_logits(_TableSplit(self, params, batches, mesh, specs))

    def split_lookups(self, params: list, batches: list, mesh, specs: dict) -> dict:
        """Each table's rows as every mesh device reads them for its data
        shard (``{lookup: [rows per mesh device]}``, ``_lookup_ids``'s
        names), combined over ``"model"``: the lookups of ``split_loss``."""
        ts = _TableSplit(self, params, batches, mesh, specs)
        return {name: ts.read(self, name) for name in self._lookup_ids()}


class _TableSplit:
    """Where a recsys ``split_loss`` computes (the module note): the layout
    (``layers.SplitLayout``; no sequence), each mesh device's tree and its
    data shard's batch on its device, and the row count ``V`` of each table
    the specs split over ``"model"``."""

    def __init__(self, model, params: list, batches: list, mesh, specs: dict,
                 probe: bool = False):
        m = mesh.size("model") if "model" in mesh.axis_names else 1
        if "model" in mesh.axis_names and mesh.axis_names[-1] != "model":
            raise ValueError(f"the model axis must be the mesh's last, got {mesh.axis_names}")
        self.n = [next(iter(b.values())).shape[0] for b in batches]
        starts = [sum(self.n[:s]) for s in range(len(batches))]
        self.lay = lay = layers.SplitLayout(
            mesh, m, tuple((b0, b0 + k) for b0, k in zip(starts, self.n)), 1, False, probe)
        if lay.D != len(batches):
            raise ValueError(f"{len(batches)} row shards for {lay.D} data shards")
        self.params = params
        self.batch = lay.each(lambda r: {k: v.to(lay.device(r))
                                         for k, v in batches[r // m].items()})
        self.batch_axes = model.cfg.batch_axes
        self.rows: dict = {}
        for key, (shape, _) in ((k, v) for k, v in model.param_shapes().items() if _is_leaf(v)):
            axes = P(*specs[key]).axes(len(shape))
            at = [i for i, ax in enumerate(axes) if "model" in ax]
            if at and (at != [len(shape) - 2] or axes[at[0]] != ("model",)):
                raise NotImplementedError(f"a recsys table splits over 'model' by its rows "
                                          f"only, not {key} by {specs[key]!r}")
            if at and m > 1:
                self.rows[key] = shape[-2]
        for key, v in model.param_shapes().items():
            if not _is_leaf(v) and any("model" in P(*sp).names() for sp in specs[key]):
                raise NotImplementedError(f"{key} is replicated over 'model' in the "
                                          f"reference's specs, not {specs[key]!r}")

    def first(self, r: int) -> int:
        """The batch row where mesh device r's data shard starts."""
        return self.lay.rows[r // self.lay.m][0]

    def lookup(self, key: str, ids: list) -> list:
        """Each mesh device's rows of table ``key`` for ``ids[r]``: a table
        split over "model" read piece by piece and combined (the module
        note), another read whole on each device as on one."""
        lay = self.lay

        def whole(r, p, i):
            t = p[key]
            return embedding_lookup(t, i) if t.ndim == 3 else t[i.long()]

        if key not in self.rows:
            return lay.each(whole, self.params, ids)
        v = self.rows[key]
        parts = lay.each(lambda r, p, i: take_piece(
            p[key], i, coll.piece_bounds(v, lay.m, r % lay.m)[0]), self.params, ids)
        return lay.over_model(coll.all_reduce, parts)

    def read(self, model, name: str) -> list:
        """The lookup ``name`` of ``model._lookup_ids()`` on every device."""
        key, ids = model._lookup_ids()[name]
        return self.lookup(key, [ids(b) for b in self.batch])

    def heads(self, fn, *lists) -> list:
        """``fn(r, ...)`` on each data shard's model shard 0, where the loss
        is read; the data shard's other model shards hold that result (their
        replicated weights would compute the same values)."""
        m = self.lay.m
        out = self.lay.each(lambda r, *a: fn(r, *a) if r % m == 0 else None, *lists)
        return [out[r - r % m] for r in range(self.lay.R)]

    def constrain(self, xs: list) -> list:
        return [_constrain_rows(x, self.batch_axes) for x in xs]

    def weighted(self, means: list) -> torch.Tensor:
        """``sum_s (B_s / B) means_s`` on the lead device in shard order
        (float32, as the row split sums), read on each data shard's model
        shard 0; one data shard: its own value."""
        lay, lead = self.lay, self.lay.mesh.lead
        if lay.D == 1:
            return means[0].to(lead)
        total, loss = sum(self.n), None
        for s in (s for s in range(lay.D) if self.n[s]):
            w = torch.full((), self.n[s] / total, dtype=torch.float32, device=lead)
            part = means[s * lay.m].to(lead) * w
            loss = part if loss is None else loss + part
        return loss


class WideDeepModel(_RecsysModule):
    """Wide&Deep (arXiv:1606.07792): wide hashed-linear + deep MLP on field
    embeddings, summed logits."""

    def param_shapes(self) -> dict:
        c = self.cfg
        deep_in = c.n_sparse * c.embed_dim
        dims = (deep_in,) + tuple(c.mlp) + (1,)
        return {
            "tables": ((c.n_sparse, c.vocab, c.embed_dim), c.dtype),
            "wide": ((c.vocab, 1), c.dtype),
            "mlp_w": _mlp_shapes(dims, c.dtype),
            "mlp_b": [((d,), c.dtype) for d in dims[1:]],
        }

    def forward(self, batch: dict) -> torch.Tensor:
        c = self.cfg
        idx = batch["sparse_ids"]  # (B, T)
        emb = _constrain_rows(embedding_lookup(self.tables, idx), c.batch_axes)
        return _wide_deep_head(emb, self.wide[idx.long() % c.vocab], self._p())

    def _lookup_ids(self) -> dict:
        return {"tables": ("tables", lambda b: b["sparse_ids"]),
                "wide": ("wide", lambda b: b["sparse_ids"].long() % self.cfg.vocab)}

    def _split_logits(self, ts: _TableSplit) -> list:
        emb = ts.constrain(ts.read(self, "tables"))
        return ts.heads(lambda r, p, e, w: _wide_deep_head(e, w, p), ts.params, emb,
                        ts.read(self, "wide"))


def _wide_deep_head(emb: torch.Tensor, wide_rows: torch.Tensor, p: dict) -> torch.Tensor:
    deep = _mlp_apply(emb.reshape(emb.shape[0], -1), p["mlp_w"], p["mlp_b"])
    wide = wide_rows[..., 0].sum(dim=-1, keepdim=True)
    return (deep + wide).float()[:, 0]


class DINModel(_RecsysModule):
    """Deep Interest Network (arXiv:1706.06978): target attention over the
    user behaviour sequence."""

    def param_shapes(self) -> dict:
        c = self.cfg
        d = c.embed_dim
        attn_dims = (4 * d,) + tuple(c.attn_mlp) + (1,)
        mlp_dims = (2 * d,) + tuple(c.mlp) + (1,)
        return {
            "item_table": ((c.vocab, d), c.dtype),
            "attn_w": _mlp_shapes(attn_dims, c.dtype),
            "attn_b": [((x,), c.dtype) for x in attn_dims[1:]],
            "mlp_w": _mlp_shapes(mlp_dims, c.dtype),
            "mlp_b": [((x,), c.dtype) for x in mlp_dims[1:]],
        }

    def forward(self, batch: dict) -> torch.Tensor:
        hist = batch["hist_ids"].long()      # (B, L)
        target = batch["target_id"].long()   # (B,)
        valid = batch.get("hist_valid")      # (B, L) bool
        eh = _constrain_rows(self.item_table[hist], self.cfg.batch_axes)
        et = _constrain_rows(self.item_table[target], self.cfg.batch_axes)
        return _din_head(eh, et, valid, self._p())

    def _lookup_ids(self) -> dict:
        return {"history": ("item_table", lambda b: b["hist_ids"]),
                "target": ("item_table", lambda b: b["target_id"])}

    def _split_logits(self, ts: _TableSplit) -> list:
        eh = ts.constrain(ts.read(self, "history"))
        et = ts.constrain(ts.read(self, "target"))
        return ts.heads(lambda r, p, h, t, b: _din_head(h, t, b.get("hist_valid"), p),
                        ts.params, eh, et, ts.batch)


def _din_head(eh: torch.Tensor, et: torch.Tensor, valid, p: dict) -> torch.Tensor:
    """DIN's target attention and MLP over the looked-up rows: ``eh`` (B,
    L, D) the history's, ``et`` (B, D) the target's."""
    et = et[:, None, :]
    etb = et.expand_as(eh)
    a_in = torch.cat([eh, etb, eh - etb, eh * etb], dim=-1)
    w = _mlp_apply(a_in, p["attn_w"], p["attn_b"])[..., 0]  # (B, L)
    if valid is not None:
        w = torch.where(valid, w, -1e9)
    # softmax in float32, cast back, as the reference
    w = torch.softmax(w.float(), dim=-1).to(eh.dtype)
    user = torch.einsum("bl,bld->bd", w, eh)
    z = torch.cat([user, et[:, 0]], dim=-1)
    return _mlp_apply(z, p["mlp_w"], p["mlp_b"]).float()[:, 0]


class TwoTowerModel(_RecsysModule):
    """Two-tower retrieval (Yi et al., RecSys'19): user/item towers -> dot;
    trained with in-batch sampled softmax (logQ-free synthetic variant)."""

    def param_shapes(self) -> dict:
        c = self.cfg
        d_emb = 64  # per-field embedding feeding the towers
        u_in = c.n_user_fields * d_emb
        i_in = c.n_item_fields * d_emb
        u_dims = (u_in,) + tuple(c.tower_mlp) + (c.embed_dim,)
        i_dims = (i_in,) + tuple(c.tower_mlp) + (c.embed_dim,)
        return {
            "user_tables": ((c.n_user_fields, c.vocab, d_emb), c.dtype),
            "item_tables": ((c.n_item_fields, c.vocab, d_emb), c.dtype),
            "user_w": _mlp_shapes(u_dims, c.dtype),
            "user_b": [((x,), c.dtype) for x in u_dims[1:]],
            "item_w": _mlp_shapes(i_dims, c.dtype),
            "item_b": [((x,), c.dtype) for x in i_dims[1:]],
        }

    def _tower(self, tables, ws, bs, ids):
        return _tower_head(_constrain_rows(embedding_lookup(tables, ids), self.cfg.batch_axes),
                           ws, bs)

    def _lookup_ids(self) -> dict:
        return {"user_tables": ("user_tables", lambda b: b["user_ids"]),
                "item_tables": ("item_tables", lambda b: b["item_ids"])}

    def split_loss(self, params: list, batches: list, mesh, specs: dict,
                   probe: bool = False) -> torch.Tensor:
        """``loss_fn`` over a mesh (the module note): each device's towers
        over its data shard's rows with split lookups, the item rows
        all-gathered over the data axes in float32 (float64 for a float64
        copy), each device's rows' in-batch terms against every item.
        Returns ``sum_s sum(terms_s) / B`` on the lead device in shard order
        (one data shard: the mean of its terms, as on one device)."""
        ts = _TableSplit(self, params, batches, mesh, specs, probe)
        lay = ts.lay
        u = ts.heads(lambda r, p, e: _tower_head(e, p["user_w"], p["user_b"]), ts.params,
                     ts.constrain(ts.read(self, "user_tables")))
        i = ts.heads(lambda r, p, e: _tower_head(e, p["item_w"], p["item_b"]), ts.params,
                     ts.constrain(ts.read(self, "item_tables")))
        wide = ts.heads(lambda r, x: x.to(torch.promote_types(x.dtype, torch.float32)), i)
        items = lay.over_data(coll.all_gather, wide, 0)
        terms = ts.heads(lambda r, ur, it: self.in_batch_terms(ur, it, ts.first(r)), u, items)
        lead = mesh.lead
        if lay.D == 1:
            return torch.mean(terms[0]).to(lead)
        total, loss = sum(ts.n), None
        for s in (s for s in range(lay.D) if ts.n[s]):
            part = (torch.sum(terms[s * lay.m]) / total).to(lead)
            loss = part if loss is None else loss + part
        return loss

    def user_embed(self, user_ids: torch.Tensor) -> torch.Tensor:
        return self._tower(self.user_tables, self.user_w, self.user_b, user_ids)

    def item_embed(self, item_ids: torch.Tensor) -> torch.Tensor:
        return self._tower(self.item_tables, self.item_w, self.item_b, item_ids)

    def forward(self, batch: dict) -> torch.Tensor:
        if "candidates" in batch:  # retrieval scoring: precomputed item matrix
            u = self.user_embed(batch["user_ids"])  # (B, E)
            return _fp32_product(u, batch["candidates"].T)
        u, i = self.towers(batch)
        return _fp32_product(u, i.T) * 20.0  # temperature

    def towers(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """(user rows, item rows) of a training batch."""
        return self.user_embed(batch["user_ids"]), self.item_embed(batch["item_ids"])

    def in_batch_terms(self, u: torch.Tensor, items: torch.Tensor,
                       first: int = 0) -> torch.Tensor:
        """Each row's ``logz - gold`` of the in-batch softmax: ``u``'s rows
        (the batch's rows ``first``, ``first + 1``, …) against every row of
        ``items``, each row's own item its label."""
        logits = _fp32_product(u, items.T) * 20.0
        labels = first + torch.arange(logits.shape[0], device=logits.device)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, None])[:, 0]
        return logz - gold

    def loss_fn(self, batch: dict) -> torch.Tensor:
        """The (B, B) in-batch softmax's mean over the batch's rows."""
        return torch.mean(self.in_batch_terms(*self.towers(batch)))

    def forward_retrieval_pruned(
        self, batch: dict, *, block: int = 128, budget_blocks: int = 3136,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Supermetric-pruned candidate scoring (the paper's technique in the
        serving graph).  batch adds the BSS index arrays:
            pivots (P, E) fp32, pair_idx (M, 2) int, deltas (M,) fp32,
            boxes (B_blocks, M, 4) fp32.
        Only the ``budget_blocks`` blocks with the smallest planar lower
        bound are gathered and scored.  The bound is the reference's own
        plain arithmetic, in its order (delta floored at 1e-12, no
        degenerate-plane branch, query -> pivot distances by the norm
        expansion), not the planar kernel's.

        Returns (scores (Q, budget*block), candidate row indices)."""
        u = self.user_embed(batch["user_ids"])  # (Q, E) normalised
        cand = batch["candidates"]
        piv = batch["pivots"]
        pairs = batch["pair_idx"]
        deltas = batch["deltas"]
        boxes = batch["boxes"]  # (B_blocks, M, 4)
        n, e_dim = cand.shape
        b_blocks = boxes.shape[0]
        n_pad = b_blocks * block

        uf = u.float()
        lb, cdist = pruned_block_keys(uf, piv, pairs, deltas, boxes)
        order = lexsort_rows(cdist, lb)
        top = order[:, :budget_blocks]  # (Q, budget)
        cand_pad = nn.functional.pad(cand, (0, 0, 0, n_pad - n))
        blocks = cand_pad.reshape(b_blocks, block, e_dim)
        picked = blocks[top]  # (Q, budget, block, E): the pruned gather
        scores = torch.einsum(
            "qe,qkbe->qkb", uf, picked.float()
        ).reshape(u.shape[0], -1)
        rows = (top[..., None] * block
                + torch.arange(block, device=top.device)[None, None, :]
                ).reshape(u.shape[0], -1)
        return scores, rows


def _tower_head(e: torch.Tensor, ws, bs) -> torch.Tensor:
    """A tower's MLP over its looked-up rows ``e`` (B, F, D), normalised."""
    z = _mlp_apply(e.reshape(e.shape[0], -1), ws, bs)
    return z / torch.clamp_min(torch.linalg.norm(z, dim=-1, keepdim=True), 1e-6)


def pruned_block_keys(uf: torch.Tensor, piv: torch.Tensor, pairs: torch.Tensor,
                      deltas: torch.Tensor, boxes: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(lb, cdist), each (Q, B_blocks): the planar lower bound of every
    (query, block) and the mean distance of the query's plane projections
    to the block's box centres, in the reference's arithmetic and order
    (``forward_retrieval_pruned`` ranks blocks by them)."""
    check_ieee_fp32(uf)
    pairs = pairs.long()
    dq = torch.sqrt(torch.clamp_min(
        torch.sum(uf * uf, -1)[:, None]
        + torch.sum(piv * piv, -1)[None, :]
        - (2.0 * uf) @ piv.T, 0.0,
    ))  # (Q, P)
    d1 = dq[:, pairs[:, 0]]
    d2 = dq[:, pairs[:, 1]]
    delta = torch.clamp_min(deltas[None, :], 1e-12)
    qx = (d1 * d1 - d2 * d2) / (2.0 * delta)
    s = qx + delta / 2.0
    qy = torch.sqrt(torch.clamp_min(d1 * d1 - s * s, 0.0))
    qxb, qyb = qx[:, None, :], qy[:, None, :]
    dx = torch.clamp_min(torch.maximum(boxes[None, :, :, 0] - qxb,
                                       qxb - boxes[None, :, :, 1]), 0.0)
    dy = torch.clamp_min(torch.maximum(boxes[None, :, :, 2] - qyb,
                                       qyb - boxes[None, :, :, 3]), 0.0)
    lb = torch.amax(torch.sqrt(dx * dx + dy * dy), dim=-1)
    cx = 0.5 * (boxes[None, :, :, 0] + boxes[None, :, :, 1])
    cy = 0.5 * (boxes[None, :, :, 2] + boxes[None, :, :, 3])
    ex, ey = qxb - cx, qyb - cy
    cdist = torch.mean(torch.sqrt(ex * ex + ey * ey), dim=-1)
    return lb, cdist


def lexsort_rows(secondary: torch.Tensor, primary: torch.Tensor) -> torch.Tensor:
    """Per row, the order of ``jnp.lexsort((secondary, primary), axis=1)``:
    by ``primary``, ties by ``secondary``, then by position."""
    first = torch.argsort(secondary, dim=1, stable=True)
    second = torch.argsort(torch.gather(primary, 1, first), dim=1, stable=True)
    return torch.gather(first, 1, second)


class DLRMModel(_RecsysModule):
    """DLRM-RM2 (arXiv:1906.00091): bottom MLP on dense feats, dot-product
    feature interaction, top MLP."""

    def param_shapes(self) -> dict:
        c = self.cfg
        d = c.embed_dim
        bot = (c.n_dense,) + tuple(c.bot_mlp)
        n_f = c.n_sparse + 1
        n_inter = n_f * (n_f - 1) // 2
        top = (n_inter + d,) + tuple(c.mlp) + (1,)
        return {
            "tables": ((c.n_sparse, c.vocab, d), c.dtype),
            "bot_w": _mlp_shapes(bot, c.dtype),
            "bot_b": [((x,), c.dtype) for x in bot[1:]],
            "top_w": _mlp_shapes(top, c.dtype),
            "top_b": [((x,), c.dtype) for x in top[1:]],
        }

    def forward(self, batch: dict) -> torch.Tensor:
        emb = _constrain_rows(
            embedding_lookup(self.tables, batch["sparse_ids"]), self.cfg.batch_axes
        )  # (B, 26, D)
        return _dlrm_head(batch["dense"].to(self.cfg.dtype), emb, self._p())

    def _lookup_ids(self) -> dict:
        return {"tables": ("tables", lambda b: b["sparse_ids"])}

    def _split_logits(self, ts: _TableSplit) -> list:
        dt = self.cfg.dtype
        return ts.heads(lambda r, p, e, b: _dlrm_head(b["dense"].to(dt), e, p), ts.params,
                        ts.constrain(ts.read(self, "tables")), ts.batch)


def _dlrm_head(dense: torch.Tensor, emb: torch.Tensor, p: dict) -> torch.Tensor:
    """DLRM's bottom MLP on ``dense`` (B, 13), the dot interaction with the
    looked-up rows ``emb`` (B, 26, D) and the top MLP."""
    z0 = _mlp_apply(dense, p["bot_w"], p["bot_b"], final_act=True)
    z = torch.cat([z0[:, None, :], emb], dim=1)  # (B, 27, D)
    if z.dtype == torch.float32:
        check_ieee_fp32(z)
    inter = torch.einsum("bnd,bmd->bnm", z, z)  # (B, 27, 27)
    # row-major upper triangle, as jnp.triu_indices
    iu, ju = torch.triu_indices(z.shape[1], z.shape[1], offset=1, device=z.device)
    feat = torch.cat([inter[:, iu, ju], z0], dim=-1)
    return _mlp_apply(feat, p["top_w"], p["top_b"]).float()[:, 0]


def bce_terms(logit: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Each row's binary cross-entropy of ``logit`` against ``y``."""
    return torch.clamp_min(logit, 0) - logit * y + torch.log1p(torch.exp(-torch.abs(logit)))


def bce_loss(model, batch: dict) -> torch.Tensor:
    return torch.mean(bce_terms(model.forward(batch), batch["label"].float()))
