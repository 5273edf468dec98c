"""Training launcher of the port, the port of ``repro.launch.train`` for
the recsys family (an LM or GNN name raises ``NotImplementedError`` naming
the ROADMAP item that ports its training):

    PYTHONPATH=src python -m repro_torch.launch.train --arch two-tower-retrieval \\
        --steps 20 --reduced --device cpu      # the reduced config on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch two-tower-retrieval \\
        --steps 20 --reduced                   # on the card

Runs on the CUDA device (``--device cuda``, the default, raising where
there is none, float32 matmuls in IEEE float32) unless ``--device cpu``.
Without ``--reduced`` the full config trains on the ``train_batch`` cell's
65,536 rows a step, as the reference does (the full two-tower config's
in-batch softmax does not fit one 80 GB card there: PERF.md §4).  A run
resumes from the latest checkpoint in ``--checkpoint-dir``.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import common
from repro_torch.configs.registry import get_arch
from repro_torch.core.flat_index import resolve_device
from repro_torch.data.pipeline import ClickStream
from repro_torch.optim import make_optimizer
from repro_torch.train.loop import TrainLoop, TrainLoopConfig
from repro_torch.train.step import functional_loss

REDUCED_BATCH = 16
# the families whose training is not ported yet, and the ROADMAP item of each
NOT_TRAINED = {
    "lm": "ROADMAP Queue 1 item 8.3b (the LM branch of launch/train.py, an LM "
          "train step on the card)",
    "gnn": "ROADMAP Queue 1 item 8.4 (models/gnn.py with configs/pna.py)",
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
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

    if args.reduced:
        model, cfg, _ = bundle.make_reduced()
    else:
        model, cfg = bundle.model, bundle.cfg
    batch = REDUCED_BATCH if args.reduced else common.RECSYS_SHAPES["train_batch"]["batch"]
    loss_fn = functional_loss(model, common.loss_for(bundle.family, model))
    opt = make_optimizer(getattr(cfg, "optimizer", "adamw"), total_steps=args.steps)
    loop = TrainLoop(
        loss_fn, opt, ClickStream(model.cfg, batch=batch),
        TrainLoopConfig(
            total_steps=args.steps,
            checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir,
            compression=args.compression,
            microbatches=1 if args.reduced else getattr(cfg, "microbatches", 1),
        ),
        device=dev,
    )
    state = loop.init_or_restore(
        lambda: model.init_params(torch.Generator(dev).manual_seed(0), device=dev).param_tree())
    loop.run(state)
    print(f"done: final loss {loop.losses[-1]:.4f} over {len(loop.losses)} steps "
          f"({loop.stragglers} straggler events) on {dev}")


if __name__ == "__main__":
    main()
