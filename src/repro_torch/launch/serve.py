"""Serving launcher of the port: embed a corpus with the two-tower model,
build the supermetric index, serve batched retrieval queries — the port of
``repro.launch.serve`` (the reduced two-tower bundle, seeded weights).

    PYTHONPATH=src python -m repro_torch.launch.serve --corpus 20000 --queries 256 --k 10
    PYTHONPATH=src python -m repro_torch.launch.serve --min-score 0.5 --device cpu

Runs on the CUDA device (``--device cuda``, the default, raising where
there is no card); ``--device cpu`` runs the model and the plain engine on
the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.flat_index import resolve_device
from repro_torch.models.recsys import check_ids
from repro_torch.serve.queue import now
from repro_torch.serve.retrieval import RetrievalServer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", type=int, default=20_000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--min-score", type=float, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    # "cuda" is the current CUDA device, raising where there is none
    dev = resolve_device(None if args.device == "cuda" else args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    bundle = get_arch("two-tower-retrieval")
    model, cfg, _ = bundle.make_reduced()
    model.init_params(torch.Generator(dev).manual_seed(0), device=dev)

    rng = np.random.default_rng(0)
    item_ids = rng.integers(0, cfg.vocab, size=(args.corpus, cfg.n_item_fields))
    user_ids = rng.integers(0, cfg.vocab, size=(args.queries, cfg.n_user_fields))
    check_ids(item_ids, cfg.vocab, "item ids")
    check_ids(user_ids, cfg.vocab, "user ids")

    print(f"embedding corpus of {args.corpus} items ...")
    with torch.inference_mode():
        corpus = model.item_embed(torch.as_tensor(item_ids, device=dev)).float().cpu().numpy()
        users = model.user_embed(torch.as_tensor(user_ids, device=dev)).float().cpu().numpy()

    t0 = now()
    server = RetrievalServer(corpus, device=dev)
    print(f"built supermetric index in {now() - t0:.2f}s "
          f"({server.index.n_blocks} blocks)")

    if args.min_score is not None:
        hits = server.range_query(users, args.min_score)
        sizes = [len(h) for h in hits]
        print(f"range query >= {args.min_score}: mean {np.mean(sizes):.1f} hits")
    else:
        t0 = now()
        server.top_k(users, args.k)
        dt = now() - t0
        print(f"top-{args.k} for {args.queries} queries in {dt:.2f}s")
    s = server.stats
    print(f"distances/query: {s.dists_per_query:.0f} "
          f"(exhaustive would be {args.corpus}) -> {100 * s.saving:.1f}% pruned")


if __name__ == "__main__":
    main()
