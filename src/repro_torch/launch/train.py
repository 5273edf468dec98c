"""Training launcher of the port, the port of ``repro.launch.train`` for
every family (LM, GNN, recsys):

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 20 --reduced --device cpu      # the reduced config on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch pna \\
        --steps 20 --reduced                   # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 20 --reduced --mesh 2x2        # over a (data, model) mesh

Runs on the CUDA device (``--device cuda``, the default, raising where
there is none, float32 matmuls in IEEE float32) unless ``--device cpu``.
The streams are the reference's: ``TokenStream`` batches for an LM (8 × 32
reduced, the ``train_4k`` cell's 256 × 4,096 at full size), ``ClickStream``
for a recsys model (16 rows reduced, the ``train_batch`` cell's 65,536 at
full size), repeated ``batched_molecules`` batches (8 graphs of 10 nodes
and 20 edges) for the GNN.  The full sizes do not fit one 80 GB card: an
LM batch of 256 × 4,096 tokens (the full Llama-3.2-1B fits 2 rows with
remat) and the full two-tower config's in-batch softmax (PERF.md §4).

The molecule stream holds graph labels, so the GNN trains the graph-level
head (``graph_level=True``: the ``molecule`` cell's model, or the reduced
config with it).  The reference feeds the stream to the node-level base
model, whose loss cannot pair its node logits with graph labels and raises.

``--mesh DxM`` runs the loop over a ``("data", "model")`` mesh of D × M
devices (``launch.mesh.make_local_mesh``; CPU devices with ``--device
cpu``, ``launch.simdevices.simulated_mesh``): the state in pieces by the
model's ``param_specs``, the sharded step of ``parallel.sharded_step``
with the family's plan (an LM's layers over "model", PNA's nodes over
every device, a recsys model's tables in their "model" pieces).  PNA's
molecule batches then come in the dst-partitioned layout, the 80 nodes in
16 blocks (``PNAModel.partition_edges``), so D × M must divide 16.

A run resumes from the latest checkpoint in ``--checkpoint-dir``, under
whatever mesh saved it.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import common
from repro_torch.configs.registry import get_arch
from repro_torch.core.flat_index import resolve_device
from repro_torch.data.pipeline import ClickStream, TokenStream, batched_molecules
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.simdevices import simulated_mesh
from repro_torch.optim import make_optimizer
from repro_torch.parallel.sharded_step import sharded_step_for
from repro_torch.train.loop import TrainLoop, TrainLoopConfig
from repro_torch.train.step import functional_loss

__all__ = ["make_stream", "train_model", "parse_mesh", "main"]

# the families whose training is not ported yet, and the ROADMAP item of each
NOT_TRAINED: dict[str, str] = {}


class MoleculeStream:
    """Repeated ``batched_molecules`` batches (8 graphs of 10 nodes and 20
    edges), batch ``i`` drawn from ``default_rng(i)``, as the reference's
    GNN stream."""

    def __init__(self, d_feat: int, n_classes: int, blocks: int | None = None):
        self.d_feat, self.n_classes = d_feat, n_classes
        self.blocks = blocks  # the dst-partitioned layout's blocks, or flat
        self.step = 0

    def next(self) -> dict:
        rng = np.random.default_rng(self.step)
        self.step += 1
        batch = batched_molecules(rng, 8, 10, 20, self.d_feat, self.n_classes)
        if self.blocks is None:
            return batch
        from repro_torch.models.gnn import PNAModel

        src, dstl, valid = PNAModel.partition_edges(batch.pop("edge_src"), batch.pop("edge_dst"),
                                                    batch["x"].shape[0], self.blocks)
        batch.update(edge_src=src, edge_dst_local=dstl, edge_valid=valid)
        return batch

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, s: dict) -> None:
        self.step = s["step"]


def train_model(bundle: common.ArchBundle, reduced: bool):
    """(model, cfg) a run of ``bundle`` trains: the reduced or the full
    config; for the GNN its graph-level head (the molecule stream's)."""
    if bundle.family == "gnn":
        if reduced:
            model, cfg, _ = bundle.make_reduced()
            model = type(model)(dataclasses.replace(cfg, graph_level=True))
        else:
            model = bundle.model_for("molecule")
        return model, model.cfg
    if reduced:
        model, cfg, _ = bundle.make_reduced()
        return model, cfg
    return bundle.model, bundle.cfg


def make_stream(family: str, model, cfg, reduced: bool, mesh: bool = False):
    if family == "lm":
        if reduced:
            return TokenStream(vocab=model.cfg.vocab, batch=8, seq=32)
        return TokenStream(vocab=cfg.vocab, batch=256, seq=4096)
    if family == "recsys":
        batch = 16 if reduced else common.RECSYS_SHAPES["train_batch"]["batch"]
        return ClickStream(model.cfg, batch=batch)
    return MoleculeStream(model.cfg.d_feat, model.cfg.n_classes, 16 if mesh else None)


def parse_mesh(text: str, device: torch.device):
    """``"DxM"`` -> a ``("data", "model")`` mesh of D × M devices on
    ``device``'s type."""
    try:
        d, m = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DxM (e.g. 2x2), got {text!r}") from None
    if device.type == "cpu":
        return simulated_mesh(d * m, (d, m), ("data", "model"))
    return make_local_mesh(model_parallel=m, n_devices=d * m)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh", default=None, help="DxM: a (data, model) mesh, e.g. 2x2")
    args = ap.parse_args(argv)
    bundle = get_arch(args.arch)
    if bundle.family in NOT_TRAINED:
        raise NotImplementedError(
            f"training the {bundle.family} family ({args.arch!r}) is not ported "
            f"yet: {NOT_TRAINED[bundle.family]}")
    dev = resolve_device(None if args.device == "cuda" else args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    model, cfg = train_model(bundle, args.reduced)
    loss_fn = functional_loss(model, common.loss_for(bundle.family, model))
    opt = make_optimizer(getattr(cfg, "optimizer", "adamw"), total_steps=args.steps)
    microbatches = 1 if args.reduced else getattr(cfg, "microbatches", 1)
    sharded = None
    if args.mesh:
        sharded = sharded_step_for(bundle.family, model, opt, parse_mesh(args.mesh, dev),
                                   microbatches=microbatches, compression=args.compression)
    loop = TrainLoop(
        loss_fn, opt, make_stream(bundle.family, model, cfg, args.reduced, bool(args.mesh)),
        TrainLoopConfig(
            total_steps=args.steps,
            checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir,
            compression=args.compression,
            microbatches=microbatches,
        ),
        device=dev,
        sharded=sharded,
    )
    state = loop.init_or_restore(
        lambda: model.init_params(torch.Generator(dev).manual_seed(0), device=dev).param_tree())
    loop.run(state)
    print(f"done: final loss {loop.losses[-1]:.4f} over {len(loop.losses)} steps "
          f"({loop.stragglers} straggler events) on "
          f"{dev if sharded is None else f'a {args.mesh} mesh of {dev.type} devices'}")


if __name__ == "__main__":
    main()
