"""Config substrate of the port: architecture bundles and their cells — the
port of ``repro.configs.common`` (the LM, GNN and recsys families).

An ArchBundle knows, for every assigned input shape, the batch it takes
(``TensorSpec`` shapes and torch dtypes; nothing is allocated), the batch's
partition specs over a mesh (``Cell.partition``, the reference's
``input_partition``) and how to build a REDUCED version of itself for CPU
tests.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.parallel.sharding import P, dp_axes

__all__ = [
    "Cell",
    "ArchBundle",
    "TensorSpec",
    "loss_for",
    "SKIP_PURE_FULL_ATTENTION",
    "LM_SHAPES",
    "lm_cells",
    "lm_reduced",
    "GNN_SHAPES",
    "GNN_EDGE_BLOCKS",
    "gnn_cells",
    "RECSYS_SHAPES",
    "recsys_batch_spec",
    "recsys_cells",
]


class TensorSpec(NamedTuple):
    """Shape and dtype of one batch entry: the port's counterpart of a
    ``jax.ShapeDtypeStruct``."""

    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass
class Cell:
    shape_name: str
    kind: str  # train | prefill | decode | serve
    # inputs() -> dict of TensorSpec (the *batch*, not the parameters)
    inputs: Callable[[], Any]
    # input_partition(mesh) -> the batch's specs (a dict of ``P``)
    input_partition: Callable[[Any], Any]
    skip: str | None = None
    note: str = ""

    def partition(self, mesh):
        """The cell's input partition over ``mesh`` (a ``ShardMesh``)."""
        return self.input_partition(mesh)


@dataclasses.dataclass
class ArchBundle:
    name: str
    family: str  # lm | gnn | recsys
    cfg: Any
    model: Any
    cells: dict[str, Cell]
    # reduced-config smoke artifacts:
    # make_reduced() -> (model, cfg, batch_fn(generator) -> concrete batch)
    make_reduced: Callable[[], tuple[Any, Any, Callable]]
    # per-cell model override (GNN heads differ per dataset shape)
    cell_model: Callable[[str], Any] | None = None

    def model_for(self, cell_name: str):
        if self.cell_model is not None:
            return self.cell_model(cell_name)
        return self.model

    def loss_fn(self, model=None):
        return loss_for(self.family, model if model is not None else self.model)


def loss_for(family: str, model) -> Callable:
    """``loss(batch)`` of a model of ``family`` (the port's models hold their
    parameters, so the loss takes the batch alone)."""
    if family == "recsys":
        from repro_torch.models import recsys as R

        if model.cfg.kind == "two_tower":
            return model.loss_fn
        return lambda b: R.bce_loss(model, b)
    return model.loss_fn


# --------------------------------------------------------------------- LM

SKIP_PURE_FULL_ATTENTION = (
    "long_500k requires sub-quadratic attention; this arch is pure full "
    "attention (assignment rule: skip + note in DESIGN.md)"
)

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def lm_cells(cfg, model, *, pure_full_attention: bool) -> dict[str, Cell]:
    cells = {}
    for shape_name, s in LM_SHAPES.items():
        kind, seq, batch = s["kind"], s["seq"], s["batch"]
        skip = None
        if shape_name == "long_500k" and pure_full_attention:
            skip = SKIP_PURE_FULL_ATTENTION

        if kind == "train":

            def inputs(seq=seq, batch=batch):
                return {"tokens": TensorSpec((batch, seq + 1), torch.int32)}

            def ipart(mesh):
                return {"tokens": P(dp_axes(mesh), None)}

        elif kind == "prefill":

            def inputs(seq=seq, batch=batch):
                return {"tokens": TensorSpec((batch, seq), torch.int32)}

            def ipart(mesh):
                return {"tokens": P(dp_axes(mesh), None)}

        else:  # decode: batch + cache handled by the launcher

            def inputs(seq=seq, batch=batch):
                return {
                    "token": TensorSpec((batch, 1), torch.int32),
                    "pos": TensorSpec((), torch.int32),
                }

            def ipart(mesh, batch=batch):
                tok = P(dp_axes(mesh), None) if batch > 1 else P(None, None)
                return {"token": tok, "pos": P()}

        cells[shape_name] = Cell(shape_name, kind, inputs, ipart, skip=skip)
    return cells


def lm_reduced(cfg_cls, model_cls, **overrides):
    """Tiny same-family config + synthetic batch for CPU tests."""

    def make():
        cfg = cfg_cls(**overrides)
        model = model_cls(cfg)

        def batch_fn(generator: torch.Generator) -> dict:
            """A reduced batch drawn on ``generator``'s device."""
            return {
                "tokens": torch.randint(0, cfg.vocab, (2, 33), generator=generator,
                                        device=generator.device, dtype=torch.int32)
            }

        return model, cfg, batch_fn

    return make


# --------------------------------------------------------------------- GNN

def _pad512(x: int) -> int:
    return -(-x // 512) * 512


GNN_SHAPES = {
    # exact assignment numbers, padded to a multiple of 512 so node/edge
    # arrays shard evenly on both production meshes (padding is masked out
    # via label_mask / degree-0 nodes — standard pipeline practice).
    "full_graph_sm": dict(n=2708, e=10556, f=1433, classes=7),
    "minibatch_lg": dict(
        n=1024 + 1024 * 15 + 1024 * 15 * 10, e=1024 * 15 + 1024 * 15 * 10,
        f=602, classes=41,
        note="reddit-scale sampled subgraph: 1,024 seeds, fanout 15-10 "
             "(232,965 nodes / 114,615,892 edges in the full graph)",
    ),
    "ogb_products": dict(n=2_449_029, e=61_859_140, f=100, classes=47),
    "molecule": dict(
        n=30 * 128, e=64 * 128, f=16, classes=2,
        graphs=128, note="128 small graphs batched block-diagonally",
    ),
}


GNN_EDGE_BLOCKS = 512  # dst-partitioned edge layout: one row per node block


def gnn_cells(cfg) -> dict[str, Cell]:
    """PNA shape set (see configs/pna.py for the exact numbers).

    Edges use the dst-partitioned layout (S=512 blocks x E_loc, 5% skew
    slack) — see PNAModel._forward_partitioned."""
    cells = {}
    for name, s in GNN_SHAPES.items():
        e_loc = -(-int(s["e"] * 1.05 // GNN_EDGE_BLOCKS) // 8) * 8 + 8

        def inputs(s=s, e_loc=e_loc):
            n = _pad512(s["n"])
            eshape = (GNN_EDGE_BLOCKS, e_loc)
            d = {
                "x": TensorSpec((n, s["f"]), torch.float32),
                "edge_src": TensorSpec(eshape, torch.int32),
                "edge_dst_local": TensorSpec(eshape, torch.int32),
                "edge_valid": TensorSpec(eshape, torch.bool),
            }
            if "graphs" in s:
                d["graph_id"] = TensorSpec((n,), torch.int32)
                d["labels"] = TensorSpec((s["graphs"],), torch.int32)
            else:
                d["labels"] = TensorSpec((n,), torch.int32)
                d["label_mask"] = TensorSpec((n,), torch.float32)
            return d

        def ipart(mesh, s=s):
            all_ax = dp_axes(mesh) + ("model",)
            nodes = P(all_ax)
            edges = P(all_ax, None)
            d = {
                "x": P(all_ax, None),
                "edge_src": edges,
                "edge_dst_local": edges,
                "edge_valid": edges,
            }
            if "graphs" in s:
                d["graph_id"] = nodes
                d["labels"] = P(None)
            else:
                d["labels"] = nodes
                d["label_mask"] = nodes
            return d

        cells[name] = Cell(name, "train", inputs, ipart, note=s.get("note", ""))
    return cells


def _axsize(mesh, axes) -> int:
    out = 1
    for a in axes:
        out *= mesh.size(a)
    return out


# ------------------------------------------------------------------ recsys

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="serve", batch=1, candidates=1_000_000),
}


def recsys_batch_spec(cfg, batch: int, candidates: int | None = None,
                      train=False) -> dict[str, TensorSpec]:
    """The batch of each recsys model kind as ``TensorSpec``s."""
    k = cfg.kind
    d = {}
    if k == "wide_deep":
        b = candidates or batch
        d["sparse_ids"] = TensorSpec((b, cfg.n_sparse), torch.int32)
    elif k == "din":
        b = candidates or batch
        d["hist_ids"] = TensorSpec((b, cfg.hist_len), torch.int32)
        d["hist_valid"] = TensorSpec((b, cfg.hist_len), torch.bool)
        d["target_id"] = TensorSpec((b,), torch.int32)
    elif k == "two_tower":
        d["user_ids"] = TensorSpec((batch, cfg.n_user_fields), torch.int32)
        if candidates:
            d["candidates"] = TensorSpec((candidates, cfg.embed_dim), torch.float32)
        else:
            d["item_ids"] = TensorSpec((batch, cfg.n_item_fields), torch.int32)
    elif k == "dlrm":
        b = candidates or batch
        d["dense"] = TensorSpec((b, cfg.n_dense), torch.float32)
        d["sparse_ids"] = TensorSpec((b, cfg.n_sparse), torch.int32)
    else:
        raise ValueError(k)
    if train and k != "two_tower":
        b = candidates or batch
        d["label"] = TensorSpec((b,), torch.float32)
    return d


def recsys_cells(cfg) -> dict[str, Cell]:
    cells = {}
    for name, s in RECSYS_SHAPES.items():
        cand = s.get("candidates")

        def inputs(s=s, cand=cand):
            return recsys_batch_spec(cfg, s["batch"], cand, train=s["kind"] == "train")

        def ipart(mesh, s=s, cand=cand):
            dp = dp_axes(mesh)
            eff = cand or s["batch"]
            row = P(dp) if eff % _axsize(mesh, dp) == 0 else P(None)
            specs = recsys_batch_spec(cfg, s["batch"], cand, train=s["kind"] == "train")
            out = {}
            for key, sd in specs.items():
                if key == "candidates":
                    # FEATURE-dim sharding: row gathers stay local; the dot
                    # becomes a partial contraction + a small all-reduce
                    out[key] = P(None, "model")
                elif key == "user_ids" and cand:
                    out[key] = P(None, None)  # batch=1
                else:
                    out[key] = P(*(tuple(row) + (None,) * (len(sd.shape) - 1)))
            return out

        note = ""
        if cand and cfg.kind != "two_tower":
            note = (
                "retrieval_cand for a CTR model = bulk-score 1M candidate rows "
                "for one user (user features broadcast into each row)"
            )
        cells[name] = Cell(name, s["kind"], inputs, ipart, note=note)
    return cells
