"""Exclusion rules: Hyperbolic (triangle inequality) vs Hilbert (four-point),
and the general linear planar partition family (paper §3.2-3.4) — the port
of ``repro.core.exclusion``.

A binary partition is a signed margin ``m(point)``: ``m < split`` goes left,
``m >= split`` right; a query may exclude the far side when its separation
exceeds ``t``.  Hilbert margins are planar coordinates (sound through the
four-point property); the Hyperbolic margin of the closer-of-two-pivots
partition is ``(d1 - d2) / 2``.  Cover-radius exclusion is sound for both.

Every predicate takes an ``xp`` namespace: ``numpy`` (the host tree walks of
``core/tree.py`` and ``core/lrt.py``, float64, the reference's numpy
arithmetic op for op) or ``torch`` (the default: the forest walker of
``repro_torch.forest``, float32 tensors on the operands' device).  One body
serves both, so the host oracle and the device walk cannot drift apart.

NaN discipline: a NaN operand (a missing centre witness, the root's absent
centre distance) makes every comparison False, i.e. no exclusion; padded
reference slots carry ``+inf`` query distances, which exclude nothing
either.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import projection
from repro_torch.core.constants import DEGENERATE_DELTA, MIN_DELTA

__all__ = [
    "HYPERBOLIC",
    "HILBERT",
    "PlanarPartition",
    "hyperbolic_margin",
    "hilbert_margin",
    "planar_margin",
    "planar_margin_cs",
    "cover_radius_exclusion_mask",
    "hyperplane_exclusion_mask",
    "centre_witness_exclusion_mask",
]

HYPERBOLIC = "hyperbolic"
HILBERT = "hilbert"

# the dtype policy of ``projection``: float32 tensors for torch, the host
# dtype for numpy
_coerce = projection._coerce
_ops = projection._ops


def _off_diagonal(xp, k: int, like):
    """(k, k) True off the diagonal, on ``like``'s device for torch."""
    if xp is torch:
        return _torch_off_diagonal(k, like.device)
    return ~np.eye(k, dtype=bool)


@functools.lru_cache(maxsize=256)
def _torch_off_diagonal(k: int, device: torch.device) -> torch.Tensor:
    # made once per (arity, device): the forest walk asks at every level
    return ~torch.eye(k, dtype=torch.bool, device=device)


def hyperbolic_margin(d1, d2, *, xp=torch):
    """Signed triangle-inequality margin of the closer-pivot partition,
    ``(d1 - d2) / 2``: negative means closer to p1 (left); the opposite
    side is excluded iff |margin| > t."""
    d1, d2 = _coerce(xp, d1, d2)
    return 0.5 * (d1 - d2)


def hilbert_margin(d1, d2, delta, *, xp=torch):
    """Signed four-point margin, the planar X coordinate
    ``(d1^2 - d2^2) / (2 d(p1, p2))``; the opposite side is excluded iff
    |margin| > t."""
    return projection.project_x(d1, d2, delta, xp=xp)


@dataclasses.dataclass(frozen=True)
class PlanarPartition:
    """A linear partition of the projected plane:
    ``margin = nx * r_x + ny * r_y - split`` with ``(r_x, r_y)`` the
    rotated projection and ``(nx, ny)`` a unit vector (x-split, y-split,
    LRT, PCA axis)."""

    theta: float = 0.0
    h: float = 0.0
    nx: float = 1.0
    ny: float = 0.0
    split: float = 0.0

    def margin(self, x, y, *, xp=torch):
        rx, ry = projection.rotate(x, y, self.theta, self.h, xp=xp)
        return self.nx * rx + self.ny * ry - self.split

    def separation(self, x, y, *, xp=torch):
        return _ops(xp).abs(self.margin(x, y, xp=xp))


def planar_margin(x, y, theta, h, nx, ny, split, *, xp=torch):
    """Array form of ``PlanarPartition.margin`` for node tables: every
    parameter broadcasts against the planar coordinates."""
    rx, ry = projection.rotate(x, y, theta, h, xp=xp)
    return nx * rx + ny * ry - split


def planar_margin_cs(x, y, cos_theta, sin_theta, h, nx, ny, split, *, xp=torch):
    """``planar_margin`` with cos(theta) and sin(theta) given
    (``projection.rotate_cs``)."""
    rx, ry = projection.rotate_cs(x, y, cos_theta, sin_theta, h, xp=xp)
    return nx * rx + ny * ry - split


def cover_radius_exclusion_mask(dq, cover_r, t, *, xp=torch):
    """Ball exclusion: child x is excluded when ``d(q, p_x) > cr_x + t``;
    an +inf ``dq`` (a padded slot) excludes."""
    dq, cover_r = _coerce(xp, dq, cover_r)
    return dq > cover_r + t


def hyperplane_exclusion_mask(dq, ref_dists, t, mechanism, *, xp=torch):
    """Pairwise hyperplane exclusion over an n-ary node (paper Alg. 2).

    ``dq`` (..., k) query -> reference distances (+inf at padded slots),
    ``ref_dists`` (k, k) or a broadcastable batch (nodes, k, k).  Returns
    (..., k), True where child x can be excluded: some witness y has
    ``d(q,px) - d(q,py) > 2t`` (Hyperbolic) or
    ``(d(q,px)^2 - d(q,py)^2) / d(px,py) > 2t`` (Hilbert)."""
    dq, ref_dists = _coerce(xp, dq, ref_dists)
    ops = _ops(xp)
    dx = dq[..., :, None]  # (..., k, 1) candidate to exclude
    dy = dq[..., None, :]  # (..., 1, k) witness
    if mechanism == HYPERBOLIC:
        crit = dx - dy > 2.0 * t
    elif mechanism == HILBERT:
        delta = ops.maximum(ref_dists, MIN_DELTA)
        # degenerate witness pairs (duplicate refs) separate nothing: float
        # noise over a tiny delta would be spurious exclusion
        crit = ((dx * dx - dy * dy) / delta > 2.0 * t) & (
            ref_dists >= DEGENERATE_DELTA
        )
    else:
        raise ValueError(f"unknown mechanism {mechanism!r}")
    k = dq.shape[-1]
    return ops.any(crit & _off_diagonal(xp, k, dq), axis=-1)


def centre_witness_exclusion_mask(dq, d_centre, centre_dists, t, mechanism, *, xp=torch):
    """SAT-family bonus witness: the parent centre, whose query distance was
    paid one level up.  ``d_centre`` (...,) is NaN where the walk has no
    centre in hand and ``centre_dists`` (k,) (or a batch) NaN where the
    build disabled the witness; both exclude nothing.  Returns (..., k)."""
    dq, d_centre, centre_dists = _coerce(xp, dq, d_centre, centre_dists)
    dc = d_centre[..., None]
    if mechanism == HYPERBOLIC:
        return dq - dc > 2.0 * t
    if mechanism == HILBERT:
        delta = _ops(xp).maximum(centre_dists, MIN_DELTA)
        # a ref sitting on the centre separates nothing
        return ((dq * dq - dc * dc) / delta > 2.0 * t) & (
            centre_dists >= DEGENERATE_DELTA
        )
    raise ValueError(f"unknown mechanism {mechanism!r}")
