"""The four assigned recsys architectures — exact assignment configs, the
port of ``repro.configs.recsys_archs``.

    wide-deep           n_sparse=40 embed_dim=32 mlp=1024-512-256
                        interaction=concat            [arXiv:1606.07792]
    din                 embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
                        interaction=target-attn       [arXiv:1706.06978]
    two-tower-retrieval embed_dim=256 tower_mlp=1024-512-256 interaction=dot
                        sampled-softmax               [RecSys'19 (YouTube)]
    dlrm-rm2            n_dense=13 n_sparse=26 embed_dim=64
                        bot_mlp=13-512-256-64 top_mlp=512-512-256-1
                        interaction=dot               [arXiv:1906.00091]

Vocabulary sizes are not pinned by the assignment; the 10^6-row regime of
the public DLRM / Criteo literature is used.  The reduced configs (vocab
997, float32, batch 16) are the reference's.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import common
from repro_torch.models import recsys as R

WIDE_DEEP = R.RecsysConfig(
    name="wide-deep", kind="wide_deep", n_sparse=40, embed_dim=32,
    mlp=(1024, 512, 256), vocab=1_000_000,
)
DIN = R.RecsysConfig(
    name="din", kind="din", embed_dim=18, hist_len=100,
    attn_mlp=(80, 40), mlp=(200, 80), vocab=1_000_000,
)
TWO_TOWER = R.RecsysConfig(
    name="two-tower-retrieval", kind="two_tower", embed_dim=256,
    tower_mlp=(1024, 512, 256), n_user_fields=8, n_item_fields=4,
    vocab=1_000_000,
)
DLRM = R.RecsysConfig(
    name="dlrm-rm2", kind="dlrm", n_dense=13, n_sparse=26, embed_dim=64,
    bot_mlp=(512, 256, 64), mlp=(512, 512, 256), vocab=1_000_000,
)

_MODEL_CLS = {
    "wide_deep": R.WideDeepModel,
    "din": R.DINModel,
    "two_tower": R.TwoTowerModel,
    "dlrm": R.DLRMModel,
}


def _make_reduced_fn(cfg):
    def make():
        small = dataclasses.replace(
            cfg, name=cfg.name + "-smoke", vocab=997, dtype=torch.float32
        )
        model = _MODEL_CLS[cfg.kind](small)

        def batch_fn(generator: torch.Generator) -> dict:
            """A reduced training batch drawn on ``generator``'s device."""
            dev = generator.device
            out = {}
            for key, spec in common.recsys_batch_spec(small, batch=16, train=True).items():
                if spec.dtype == torch.int32:
                    out[key] = torch.randint(0, small.vocab, spec.shape, generator=generator,
                                             device=dev, dtype=torch.int32)
                elif spec.dtype == torch.bool:
                    out[key] = torch.ones(spec.shape, dtype=torch.bool, device=dev)
                else:
                    out[key] = torch.rand(spec.shape, generator=generator, device=dev)
            return out

        return model, small, batch_fn

    return make


def bundles() -> dict:
    out = {}
    for cfg in (WIDE_DEEP, DIN, TWO_TOWER, DLRM):
        model = _MODEL_CLS[cfg.kind](cfg)
        out[cfg.name] = common.ArchBundle(
            name=cfg.name,
            family="recsys",
            cfg=cfg,
            model=model,
            cells=common.recsys_cells(cfg),
            make_reduced=_make_reduced_fn(cfg),
        )
    return out
