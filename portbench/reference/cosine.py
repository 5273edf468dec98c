"""Cosine distance sqrt(2 - 2 cos): the Euclidean distance between the rows
scaled to unit length (rows of norm below 1e-12 are scaled by 1e12)."""

from __future__ import annotations

import torch

from portbench.reference import l2

MIN_NORM = 1e-12


pair_bytes = l2.pair_bytes
pairwise = l2.pairwise
paired = l2.paired


def prepare(t: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit length; ``pairwise`` and ``paired`` take these."""
    return t / torch.clamp_min(torch.linalg.norm(t, dim=-1, keepdim=True), MIN_NORM)


def control(q: torch.Tensor, x: torch.Tensor, precision: str) -> torch.Tensor:
    """The rows scaled in float32, their distances as ``l2.control``."""
    return l2.control(prepare(q.float()), prepare(x.float()), precision)
