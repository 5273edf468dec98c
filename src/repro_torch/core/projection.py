"""Tetrahedral projection onto a plane (paper §3) — the port of
``repro.core.projection``.

A point with distances ``d1, d2`` to two pivots ``delta`` apart projects to
the apex ``x = (d1^2 - d2^2) / (2 delta)``, ``y = sqrt(max(d1^2 - (x +
delta/2)^2, 0))``; with the four-point property the planar distance between
two projections lower-bounds their true distance, so the distance from a
query's apex to a block's bounding box bounds the distance to every point of
the block.

Every function takes an ``xp`` namespace: ``numpy`` (host dtype kept — the
index build projects the corpus through this branch, so it must stay the
reference's numpy math byte for byte) or ``torch`` (float32 tensors on any
device — the query side).  Both branches run ONE body with the reference's
op order, so the bounds the build stores and the bounds the queries compute
cannot drift apart.  Degenerate planes (delta below ``DEGENERATE_DELTA``)
project to the ring (0, d1) on both sides.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.constants import DEGENERATE_DELTA, MIN_DELTA

__all__ = ["project", "project_x", "point_to_interval", "point_to_box"]


class _TorchOps:
    """The three numpy functions the geometry uses, on torch tensors.
    ``maximum`` with a Python scalar is ``clamp_min`` (torch.maximum takes
    tensors only); the value is the same for every non-NaN input."""

    @staticmethod
    def maximum(a, b):
        if isinstance(b, torch.Tensor):
            return torch.maximum(a, b)
        return torch.clamp_min(a, b)

    where = staticmethod(torch.where)
    sqrt = staticmethod(torch.sqrt)


def _ops(xp):
    if xp is torch:
        return _TorchOps
    if xp is np:
        return np
    raise ValueError(f"xp must be numpy or torch, got {xp!r}")


def _coerce(xp, *arrays):
    """torch computes in float32 (the engines' dtype); numpy keeps the host
    dtype (the float32 index build)."""
    if xp is torch:
        return tuple(torch.as_tensor(a, dtype=torch.float32) for a in arrays)
    return tuple(np.asarray(a) for a in arrays)


def project(d1, d2, delta, *, xp=torch):
    """Planar apex coordinates for distances (d1, d2) w.r.t. pivot gap
    delta; broadcasts over any leading shape."""
    d1, d2, raw = _coerce(xp, d1, d2, delta)
    xp = _ops(xp)
    delta = xp.maximum(raw, MIN_DELTA)
    x = xp.where(
        raw < DEGENERATE_DELTA, 0.0, (d1 * d1 - d2 * d2) / (2.0 * delta)
    )
    y_sq = d1 * d1 - (x + delta / 2.0) ** 2
    y = xp.sqrt(xp.maximum(y_sq, 0.0))
    return x, y


def project_x(d1, d2, delta, *, xp=torch):
    """X coordinate only: the Hilbert-exclusion quantity; degenerate planes
    yield 0."""
    d1, d2, raw = _coerce(xp, d1, d2, delta)
    xp = _ops(xp)
    delta = xp.maximum(raw, MIN_DELTA)
    return xp.where(
        raw < DEGENERATE_DELTA, 0.0, (d1 * d1 - d2 * d2) / (2.0 * delta)
    )


def point_to_interval(v, lo, hi, *, xp=torch):
    """Distance from coordinate(s) to interval(s) [lo, hi] (0 inside)."""
    xp = _ops(xp)
    return xp.maximum(xp.maximum(lo - v, v - hi), 0.0)


def point_to_box(x, y, box, *, xp=torch):
    """Planar distance from point(s) to axis-aligned box(es)
    ``box[..., :] = (x_lo, x_hi, y_lo, y_hi)``; broadcasts.  The Blocked
    Supermetric Scan's pruning primitive."""
    dx = point_to_interval(x, box[..., 0], box[..., 1], xp=xp)
    dy = point_to_interval(y, box[..., 2], box[..., 3], xp=xp)
    xp = _ops(xp)
    return xp.sqrt(dx * dx + dy * dy)
