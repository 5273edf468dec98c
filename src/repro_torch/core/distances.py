"""Distance metrics with explicit supermetric (four-point) classification,
in torch — the port of ``repro.core.distances``.

Same registry, names and arithmetic order as the reference (see its module
docstring for the paper's taxonomy): l2, cosine, jsd, triangular (four-point),
l1, linf (controls) and the ``"{base}^{alpha}"`` power transforms.  Every
``pairwise`` takes (n, K) and (m, K) tensors on any device and returns the
(n, m) float32 distance matrix; tests hold each within 1e-5 of the JAX
registry.

On a CUDA device a float32 matmul must stay IEEE float32: TF32 would move
distances by ~1e-3 relative and shift hits that sit near a threshold.
``check_ieee_fp32`` refuses to run with TF32 matmuls enabled.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

__all__ = [
    "Metric",
    "METRICS",
    "get_metric",
    "check_ieee_fp32",
    "l2",
    "cosine",
    "jsd",
    "triangular",
    "l1",
    "linf",
    "power_transform",
]

_EPS = 1e-12


def check_ieee_fp32(t: torch.Tensor) -> None:
    """Raise if a float32 matmul on ``t``'s device would round its inputs
    to TF32 (``torch.backends.cuda.matmul.allow_tf32``)."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "float32 matmul would run in TF32; set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )


@dataclasses.dataclass(frozen=True)
class Metric:
    """A distance metric with batched evaluation and supermetric metadata."""

    name: str
    pairwise: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    four_point: bool
    # True when inputs must be probability vectors (non-negative, sum to 1).
    probability_space: bool = False

    def point(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.pairwise(x[None, :], y[None, :])[0, 0]

    def to_query(self, q: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        """Distances from one query to a set of points, shape (n,)."""
        return self.pairwise(q[None, :], xs)[0]


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1)


def _l2_pairwise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """||x-y|| via the matmul identity; fp32 accumulation; clamped at 0."""
    x = x.float()
    y = y.float()
    check_ieee_fp32(x)
    sq = _sq_norms(x)[:, None] + _sq_norms(y)[None, :] - 2.0 * (x @ y.T)
    return torch.sqrt(torch.clamp_min(sq, 0.0))


def _cosine_pairwise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Proper (supermetric) cosine distance ``sqrt(2 - 2 cos)``: the
    Euclidean distance between l2-normalised vectors."""
    x = x.float()
    y = y.float()
    check_ieee_fp32(x)
    xn = x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), _EPS)
    yn = y / torch.clamp_min(torch.linalg.norm(y, dim=-1, keepdim=True), _EPS)
    cos = torch.clamp(xn @ yn.T, -1.0, 1.0)
    return torch.sqrt(torch.clamp_min(2.0 - 2.0 * cos, 0.0))


def _xlogx(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v > _EPS, v * torch.log(torch.clamp_min(v, _EPS)), 0.0)


def _jsd_pairwise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Jensen-Shannon distance (sqrt of the base-2 JS divergence) over
    probability vectors; broadcast over pairs like the reference."""
    x = x.float()[:, None, :]
    y = y.float()[None, :, :]
    m = 0.5 * (x + y)
    js = torch.sum(0.5 * _xlogx(x) + 0.5 * _xlogx(y) - _xlogx(m), dim=-1)
    js = torch.clamp_min(js, 0.0) / math.log(2.0)
    return torch.sqrt(js)


def _triangular_pairwise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Triangular distance ``sqrt(0.5 * sum (x-y)^2 / (x+y))`` over
    probability vectors."""
    x = x.float()[:, None, :]
    y = y.float()[None, :, :]
    num = (x - y) ** 2
    den = torch.clamp_min(x + y, _EPS)
    return torch.sqrt(torch.clamp_min(0.5 * torch.sum(num / den, dim=-1), 0.0))


def _l1_pairwise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x = x.float()[:, None, :]
    y = y.float()[None, :, :]
    return torch.sum(torch.abs(x - y), dim=-1)


def _linf_pairwise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x = x.float()[:, None, :]
    y = y.float()[None, :, :]
    return torch.amax(torch.abs(x - y), dim=-1)


l2 = Metric("l2", _l2_pairwise, four_point=True)
cosine = Metric("cosine", _cosine_pairwise, four_point=True)
jsd = Metric("jsd", _jsd_pairwise, four_point=True, probability_space=True)
triangular = Metric(
    "triangular", _triangular_pairwise, four_point=True, probability_space=True
)
l1 = Metric("l1", _l1_pairwise, four_point=False)
linf = Metric("linf", _linf_pairwise, four_point=False)

METRICS: dict[str, Metric] = {
    m.name: m for m in (l2, cosine, jsd, triangular, l1, linf)
}


def power_transform(base: Metric, alpha: float = 0.5) -> Metric:
    """``d^alpha`` for ``0 < alpha <= 1/2`` has the four-point property for
    ANY metric ``d`` (paper §2.2 item 4).  Registered in ``METRICS`` under
    ``"{base}^{alpha}"`` with its numpy twin in ``npdist``."""
    if not (0.0 < alpha <= 0.5):
        raise ValueError("four-point property only guaranteed for 0 < alpha <= 1/2")

    def pw(x, y, _base=base.pairwise, _a=alpha):
        return torch.pow(torch.clamp_min(_base(x, y), 0.0), _a)

    m = Metric(
        f"{base.name}^{alpha}",
        pw,
        four_point=True,
        probability_space=base.probability_space,
    )
    METRICS[m.name] = m
    from repro_torch.core import npdist

    npdist.register_power(base.name, alpha)
    return m


def get_metric(name: str) -> Metric:
    """Registry lookup; ``"{base}^{alpha}"`` power-transform names (e.g.
    ``"l1^0.5"``) are parsed and registered on first use."""
    if name not in METRICS and "^" in name:
        base, _, exp = name.partition("^")
        if base in METRICS:
            try:
                alpha = float(exp)
            except ValueError:
                alpha = None
            # only canonical names register ("l1^0.5", not "l1^0.50") — a
            # failed lookup must not mutate the registry as a side effect
            if alpha is not None and f"{base}^{alpha}" == name:
                power_transform(METRICS[base], alpha)
    if name not in METRICS:
        raise KeyError(f"unknown metric {name!r}; have {sorted(METRICS)}")
    return METRICS[name]
