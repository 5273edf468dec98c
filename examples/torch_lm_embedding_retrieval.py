"""LM-embedding retrieval on the PyTorch/CUDA port: any of the five assigned
LM architectures can feed the supermetric index — embed token windows with
the (reduced) LM's final hidden state, index, and search exactly.

The paper's technique does not accelerate the transformer itself; it serves
the similarity structure the transformer PRODUCES.

    PYTHONPATH=src python examples/torch_lm_embedding_retrieval.py              # on the card
    PYTHONPATH=src python examples/torch_lm_embedding_retrieval.py --device cpu

The model and the index live on the CUDA device unless ``--device cpu``;
there the engine runs the hand-written Hopper kernels, on the CPU their
plain PyTorch versions.  The numpy oracle ``bss_query`` is held to the
float64 exhaustive search, and the engine's hits to the oracle's.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core import flat_index, tree
from repro_torch.core.npdist import pairwise_np
from repro_torch.data.metricsets import calibrate_threshold
from repro_torch.data.pipeline import TokenStream
from repro_torch.models.params import check_ids

BAND = 1e-5  # float32 may place a point this close to t on either side


def embed_windows(model, tokens: torch.Tensor) -> np.ndarray:
    """Mean-pooled final hidden state per window (B, d_model): the layers
    alone, as the reference's example runs them (no ``scale_embed``, no
    final norm)."""
    c = model.cfg
    with torch.inference_mode():
        x = model.embed[tokens.long()].to(c.dtype)
        pos = torch.arange(tokens.shape[1], dtype=torch.int32,
                           device=tokens.device).expand(tokens.shape)
        lp_all, _ = model._layer_params()
        for i, loc in enumerate(model._is_local_flags()):
            x, _, _ = model._block(x, model._layer(lp_all, i), loc, pos, pos)
        return x.mean(dim=1).float().cpu().numpy()


def embed_stream(model, n_windows: int, device, batch: int = 256, seq: int = 32) -> np.ndarray:
    """``n_windows`` windows of ``TokenStream(batch, seq, seed=0)``, embedded
    a batch at a time."""
    stream = TokenStream(vocab=model.cfg.vocab, batch=batch, seq=seq, seed=0)
    embs = []
    for _ in range(n_windows // batch):
        toks = stream.next()["tokens"][:, :-1]
        check_ids(toks, model.cfg.vocab, "tokens")
        embs.append(embed_windows(model, torch.as_tensor(toks, device=device)))
    return np.concatenate(embs)


def boundary_diffs(corpus, queries, a, b, t: float) -> int:
    """Points in exactly one of ``a`` and ``b`` (per query); raises unless
    each lies within BAND * max(1, t) of t in float64."""
    n = 0
    for qv, x, y in zip(queries, a, b):
        for j in set(x) ^ set(y):
            dj = float(pairwise_np("l2", qv, corpus[j])[0, 0])
            if abs(dj - t) > BAND * max(1.0, t):
                raise RuntimeError(f"hit {j} differs at distance {dj}, t={t}")
            n += 1
    return n


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--windows", type=int, default=4096)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model and the engine run (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = flat_index.resolve_device(None if args.device == "cuda" else args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    bundle = get_arch(args.arch)
    if bundle.family != "lm":
        raise ValueError(f"{args.arch!r} is a {bundle.family} arch, not an LM")
    model, cfg, _ = bundle.make_reduced()
    model.init_params(torch.Generator(dev).manual_seed(0), device=dev)

    corpus = embed_stream(model, args.windows, dev)
    queries, corpus = corpus[:64], corpus[64:]
    print(f"embedded {len(corpus)} windows with {args.arch} (reduced) "
          f"-> {corpus.shape[1]}-d on {dev}")

    t = calibrate_threshold("l2", corpus, 2e-3)
    idx = flat_index.build_bss("l2", corpus, n_pivots=12, n_pairs=16, block=128, device=dev)
    hits, stats = flat_index.bss_query(idx, queries, t)
    truth = tree.exhaustive_search("l2", corpus, queries, t)
    exact = all(sorted(a) == sorted(b) for a, b in zip(hits, truth))
    print(f"range search t={t:.4f}: exact={exact}, "
          f"{stats['dists_per_query']:.0f} dists/query "
          f"({100 * stats['block_exclusion_rate']:.1f}% blocks pruned)")

    got, est = flat_index.bss_query_batched(idx, queries, t)
    n_edge = boundary_diffs(corpus, queries, [sorted(h) for h in got], hits, t)
    print(f"engine ({est['backend']}): {est['dists_per_query']:.0f} dists/query, "
          f"== oracle ({n_edge} points within {BAND:g} of t)")
    return dict(corpus=corpus, queries=queries, t=t, hits=hits, exact=exact,
                engine_hits=got, engine_backend=est["backend"], boundary_diffs=n_edge)


if __name__ == "__main__":
    main()
