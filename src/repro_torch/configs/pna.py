"""pna [gnn] — exact assignment config, the port of ``repro.configs.pna``:

    n_layers=4 d_hidden=75 aggregators=mean-max-min-std
    scalers=id-amp-atten            [arXiv:2004.05718; paper]

Shapes (per assignment; see configs/common.GNN_SHAPES for the padded forms):
    full_graph_sm   n=2,708  e=10,556   d_feat=1,433   (full-batch, cora)
    minibatch_lg    n=232,965 e=114,615,892 batch_nodes=1,024 fanout=15-10
    ogb_products    n=2,449,029 e=61,859,140 d_feat=100 (full-batch-large)
    molecule        n=30 e=64 batch=128                 (batched-small-graphs)

The input feature width / label space differ per dataset, so each cell gets
its own (w_in, w_out) head around the shared 4×75 PNA trunk.  The reduced
config's batch is drawn from a ``torch.Generator`` on its device, as the
LM family's is (the reference's distribution, not JAX's numbers).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import common
from repro_torch.models.gnn import PNAConfig, PNAModel

BASE = PNAConfig(
    name="pna", n_layers=4, d_hidden=75, d_feat=1433, n_classes=7,
)

_CELL_CFG = {
    "full_graph_sm": dict(d_feat=1433, n_classes=7),
    "minibatch_lg": dict(d_feat=602, n_classes=41),
    "ogb_products": dict(d_feat=100, n_classes=47),
    "molecule": dict(d_feat=16, n_classes=2, graph_level=True),
}


def _cell_model(cell_name: str) -> PNAModel:
    return PNAModel(dataclasses.replace(BASE, **_CELL_CFG[cell_name]))


def _make_reduced():
    cfg = dataclasses.replace(
        BASE, name="pna-smoke", n_layers=2, d_hidden=16, d_feat=8, n_classes=3
    )
    model = PNAModel(cfg)

    def batch_fn(generator: torch.Generator) -> dict:
        """A reduced batch drawn on ``generator``'s device."""
        n, e = 64, 256
        dev = generator.device
        ints = dict(generator=generator, device=dev, dtype=torch.int32)
        return {
            "x": torch.randn((n, cfg.d_feat), generator=generator, device=dev),
            "edge_src": torch.randint(0, n, (e,), **ints),
            "edge_dst": torch.randint(0, n, (e,), **ints),
            "labels": torch.randint(0, cfg.n_classes, (n,), **ints),
            "label_mask": torch.ones((n,), dtype=torch.float32, device=dev),
        }

    return model, cfg, batch_fn


def bundles() -> dict:
    b = common.ArchBundle(
        name="pna",
        family="gnn",
        cfg=BASE,
        model=PNAModel(BASE),
        cells=common.gnn_cells(BASE),
        make_reduced=_make_reduced,
        cell_model=_cell_model,
    )
    return {"pna": b}
