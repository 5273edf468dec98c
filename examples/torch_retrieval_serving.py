"""End-to-end serving example of the PyTorch/CUDA port (the port of
``examples/retrieval_serving.py``; the paper's kind of system is search,
so the end-to-end example trains a small model and serves it):

  1. train the reduced two-tower retrieval model (AdamW, lr 3e-3),
  2. embed an item corpus with the trained item tower,
  3. build the supermetric (BSS) index over the corpus,
  4. serve batched top-k requests exactly, measuring pruning.

    PYTHONPATH=src python examples/torch_retrieval_serving.py [--steps 200]
    PYTHONPATH=src python examples/torch_retrieval_serving.py --device cpu --steps 20

Runs on the CUDA device unless ``--device cpu``; exits non-zero if a loss
is not finite.
"""

import argparse
import math
import sys
import tempfile

import numpy as np
import torch

from repro_torch.configs import common
from repro_torch.configs.registry import get_arch
from repro_torch.core.flat_index import resolve_device
from repro_torch.core.npdist import pairwise_np
from repro_torch.data.pipeline import ClickStream
from repro_torch.optim import adamw
from repro_torch.serve.queue import now
from repro_torch.serve.retrieval import RetrievalServer
from repro_torch.train.loop import TrainLoop, TrainLoopConfig
from repro_torch.train.step import functional_loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--corpus", type=int, default=20_000)
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(None if args.device == "cuda" else args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # 1. train
    bundle = get_arch("two-tower-retrieval")
    model, cfg, _ = bundle.make_reduced()
    with tempfile.TemporaryDirectory() as ckpt:
        loop = TrainLoop(
            functional_loss(model, common.loss_for("recsys", model)), adamw(lr=3e-3),
            ClickStream(model.cfg, batch=64, seed=0),
            TrainLoopConfig(total_steps=args.steps, checkpoint_every=10**9,
                            checkpoint_dir=ckpt, log_every=50),
            device=dev,
        )
        state = loop.init_or_restore(
            lambda: model.init_params(torch.Generator(dev).manual_seed(0), device=dev).param_tree())
        state = loop.run(state)
    print(f"trained {args.steps} steps on {dev}: loss {loop.losses[0]:.3f} -> "
          f"{loop.losses[-1]:.3f}")
    if not all(math.isfinite(v) for v in loop.losses):
        print("non-finite loss", file=sys.stderr)
        return 1

    # 2./3. embed + index
    model.load_param_tree(state["params"])
    rng = np.random.default_rng(1)
    item_ids = rng.integers(0, model.cfg.vocab, size=(args.corpus, model.cfg.n_item_fields))
    user_ids = rng.integers(0, model.cfg.vocab, size=(args.queries, model.cfg.n_user_fields))
    with torch.inference_mode():
        corpus = model.item_embed(torch.as_tensor(item_ids, device=dev)).float().cpu().numpy()
        users = model.user_embed(torch.as_tensor(user_ids, device=dev)).float().cpu().numpy()
    server = RetrievalServer(corpus, device=dev)
    print(f"indexed {args.corpus} items in {server.index.n_blocks} blocks")

    # 4. serve
    t0 = now()
    top = server.top_k(users, args.k)
    dt = now() - t0

    # verify exactness on a subsample
    d = pairwise_np("l2", users[:16] / np.linalg.norm(users[:16], axis=1, keepdims=True),
                    server.corpus)
    hit = sum(
        len(set(np.argsort(d[i])[: args.k]) & set(np.asarray(top[i]).tolist()))
        for i in range(16)
    )
    print(f"top-{args.k} x {args.queries} queries in {dt:.2f}s "
          f"({dt / args.queries * 1e3:.1f} ms/query, fused batched engine)")
    print(f"recall@{args.k} (exactness check) = {hit / (16 * args.k):.3f}")
    s = server.stats
    print(f"distances/query = {s.dists_per_query:.0f} / {args.corpus} "
          f"({100 * s.saving:.1f}% pruned by the four-point lower bound)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
