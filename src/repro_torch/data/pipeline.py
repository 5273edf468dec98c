"""Deterministic, checkpointable synthetic data pipelines: the port of
``repro.data.pipeline`` (numpy, as there; the arrays equal the reference's
bit for bit for the same seed and step).

Every stream is a pure function of (seed, step): saving ``state()`` in a
checkpoint and calling ``restore()`` resumes the exact sequence — the
fault-tolerance contract (test-covered).  Real deployments swap the
``_synthesize`` bodies for file readers; the iterator state/resume protocol
is the part that matters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.common import recsys_batch_spec

__all__ = ["TokenStream", "ClickStream", "NeighborSampler", "batched_molecules"]


_DTYPE_KIND = {torch.int8: "int", torch.int16: "int", torch.int32: "int",
               torch.int64: "int", torch.bool: "bool"}


@dataclasses.dataclass
class _StreamState:
    seed: int
    step: int


class _Stream:
    def __init__(self, seed: int = 0):
        self._st = _StreamState(seed=seed, step=0)

    def state(self) -> dict:
        return dataclasses.asdict(self._st)

    def restore(self, state: dict) -> None:
        self._st = _StreamState(**state)

    def _rng(self) -> np.random.Generator:
        # counter-based: independent of call history
        return np.random.default_rng((self._st.seed << 20) ^ self._st.step)


class TokenStream(_Stream):
    """Zipf-distributed token batches (B, S+1) for LM training."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        super().__init__(seed)
        self.vocab, self.batch, self.seq = vocab, batch, seq

    def next(self) -> dict:
        rng = self._rng()
        self._st.step += 1
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        return {"tokens": (z % self.vocab).astype(np.int32)}


class ClickStream(_Stream):
    """Synthetic CTR log for the recsys models."""

    def __init__(self, cfg, batch: int, seed: int = 0):
        super().__init__(seed)
        self.cfg, self.batch = cfg, batch

    def next(self) -> dict:
        rng = self._rng()
        self._st.step += 1
        specs = recsys_batch_spec(self.cfg, self.batch, train=True)
        out = {}
        for key, sd in specs.items():
            # the reference branches on the numpy name of the dtype
            # ("int32", "bool"); a torch dtype prints as "torch.int32"
            kind = _DTYPE_KIND.get(sd.dtype, "float")
            if kind == "int":
                out[key] = rng.integers(0, self.cfg.vocab, size=sd.shape, dtype=np.int32)
            elif kind == "bool":
                out[key] = rng.random(sd.shape) < 0.9
            else:
                out[key] = rng.random(sd.shape).astype(np.float32)
        if "label" in out:
            # the loop's last spec, as in the reference
            out["label"] = (rng.random(sd.shape[:1]) < 0.3).astype(np.float32)
        return out


class NeighborSampler(_Stream):
    """Layer-wise uniform neighbour sampling (GraphSAGE-style) over a CSR
    graph — the real sampler the ``minibatch_lg`` cell's shapes come from.

    Produces a padded subgraph: seeds + fanout[0] + fanout[0]*fanout[1] ...
    node slots; edges point child->parent so segment aggregation at the
    parents sees sampled neighbourhoods.
    """

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 features: np.ndarray, labels: np.ndarray,
                 batch_nodes: int, fanout: tuple[int, ...], seed: int = 0):
        super().__init__(seed)
        self.indptr, self.indices = indptr, indices
        self.features, self.labels = features, labels
        self.batch_nodes, self.fanout = batch_nodes, fanout

    def next(self) -> dict:
        rng = self._rng()
        self._st.step += 1
        n = self.indptr.shape[0] - 1
        seeds = rng.integers(0, n, size=self.batch_nodes)
        node_ids = [seeds]
        edge_src, edge_dst = [], []
        frontier = seeds
        offset = 0
        for f in self.fanout:
            starts = self.indptr[frontier]
            degs = self.indptr[frontier + 1] - starts
            # uniform-with-replacement sample of f neighbours per node
            picks = (rng.random((len(frontier), f)) *
                     np.maximum(degs, 1)[:, None]).astype(np.int64)
            picks = np.minimum(picks, np.maximum(degs - 1, 0)[:, None])
            nbrs = self.indices[starts[:, None] + picks]  # (front, f)
            isolated = degs == 0
            nbrs[isolated] = frontier[isolated][:, None]  # self-loop fallback
            child_slot = offset + len(frontier) + np.arange(nbrs.size)
            parent_slot = offset + np.repeat(np.arange(len(frontier)), f)
            edge_src.append(child_slot)
            edge_dst.append(parent_slot)
            node_ids.append(nbrs.reshape(-1))
            offset += len(frontier)
            frontier = nbrs.reshape(-1)
        all_nodes = np.concatenate(node_ids)
        src = np.concatenate(edge_src).astype(np.int32)
        dst = np.concatenate(edge_dst).astype(np.int32)
        x = self.features[all_nodes].astype(np.float32)
        labels = self.labels[all_nodes].astype(np.int32)
        mask = np.zeros(len(all_nodes), np.float32)
        mask[: self.batch_nodes] = 1.0  # loss on seeds only
        return {
            "x": x,
            "edge_src": src,
            "edge_dst": dst,
            "labels": labels,
            "label_mask": mask,
        }


def batched_molecules(rng: np.random.Generator, n_graphs: int, n_nodes: int,
                      n_edges: int, d_feat: int, n_classes: int) -> dict:
    """Block-diagonal batch of small graphs + graph-level labels."""
    xs, srcs, dsts, gids = [], [], [], []
    for g in range(n_graphs):
        xs.append(rng.normal(size=(n_nodes, d_feat)).astype(np.float32))
        s = rng.integers(0, n_nodes, size=n_edges)
        d = rng.integers(0, n_nodes, size=n_edges)
        srcs.append(s + g * n_nodes)
        dsts.append(d + g * n_nodes)
        gids.append(np.full(n_nodes, g, np.int32))
    return {
        "x": np.concatenate(xs),
        "edge_src": np.concatenate(srcs).astype(np.int32),
        "edge_dst": np.concatenate(dsts).astype(np.int32),
        "graph_id": np.concatenate(gids),
        "labels": rng.integers(0, n_classes, size=n_graphs).astype(np.int32),
    }
