"""Distance metrics with explicit supermetric (four-point) classification,
in torch — the port of ``repro.core.distances``.

Same registry, names and arithmetic order as the reference (see its module
docstring for the paper's taxonomy): l2, cosine, jsd, triangular (four-point),
l1, linf (controls) and the ``"{base}^{alpha}"`` power transforms.  Every
``pairwise`` takes (n, K) and (m, K) tensors on any device and returns the
(n, m) float32 distance matrix; tests hold each within 1e-5 of the JAX
registry.

A float32 matmul must stay IEEE float32: TF32 on a CUDA device, or bfloat16
through oneDNN on the CPU, would move distances by ~1e-3 relative and shift
hits that sit near a threshold.  ``check_ieee_fp32`` refuses to run with
either enabled.

The broadcast metrics (jsd, triangular, l1, linf) evaluate ``y`` in column
chunks whose (n, chunk, K) transient stays within ``PAIRWISE_CHUNK_BYTES``.
So does the inner product of l2 and cosine (``row_dot``): each element is
its own sum over K, so a row's distances have the same bits in a batch of
any size.  A BLAS matmul would not promise that: its blocking follows the
batch's row count.
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
    "PAIRWISE_CHUNK_BYTES",
    "pair_chunk_cols",
    "row_dot",
]

_EPS = 1e-12


# float32 matmul settings that round the inputs (TF32 or bfloat16): the
# per-backend names of torch's newer API and the global names of the older
_ROUNDED = ("tf32", "bf16", "high", "medium")


def _fp32_matmul_setting(backend: str) -> str:
    """The float32 matmul setting of ``torch.backends.<backend>`` ("cuda"
    or "mkldnn", the CPU's oneDNN): its own ``matmul.fp32_precision`` where
    the installed torch has one ("none" inherits the generic
    ``torch.backends.fp32_precision``), else the global
    ``torch.get_float32_matmul_precision()``.  The global one also reflects
    the CUDA setting, so it is not read where the backend has its own."""
    matmul = getattr(getattr(torch.backends, backend), "matmul", None)
    own = getattr(matmul, "fp32_precision", None)
    if own is None:
        return torch.get_float32_matmul_precision()
    if own == "none":
        return getattr(torch.backends, "fp32_precision", "none")
    return own


def check_ieee_fp32(t: torch.Tensor) -> None:
    """Raise if a float32 matmul on ``t``'s device would not run in IEEE
    float32: on CUDA under TF32 (``torch.backends.cuda.matmul.allow_tf32``,
    or a float32 matmul precision below "highest"); on the CPU where oneDNN
    would round to bfloat16 or TF32 (``set_float32_matmul_precision
    ("medium")`` does so)."""
    if t.is_cuda:
        setting = _fp32_matmul_setting("cuda")
        if torch.backends.cuda.matmul.allow_tf32 or setting in _ROUNDED:
            raise RuntimeError(
                f"float32 matmul would run in TF32 ({setting!r}); set "
                f"torch.backends.cuda.matmul.allow_tf32 = False and "
                f"torch.set_float32_matmul_precision('highest')"
            )
        return
    setting = _fp32_matmul_setting("mkldnn")
    if setting in _ROUNDED:
        raise RuntimeError(
            f"float32 matmul on the CPU would not run in IEEE float32 "
            f"({setting!r}); call torch.set_float32_matmul_precision('highest')"
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
    sq = _sq_norms(x)[:, None] + _sq_norms(y)[None, :] - 2.0 * row_dot(x, y)
    return torch.sqrt(torch.clamp_min(sq, 0.0))


def _cosine_pairwise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Proper (supermetric) cosine distance ``sqrt(2 - 2 cos)``: the
    Euclidean distance between l2-normalised vectors."""
    x = x.float()
    y = y.float()
    check_ieee_fp32(x)
    xn = x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), _EPS)
    yn = y / torch.clamp_min(torch.linalg.norm(y, dim=-1, keepdim=True), _EPS)
    cos = torch.clamp(row_dot(xn, yn), -1.0, 1.0)
    return torch.sqrt(torch.clamp_min(2.0 - 2.0 * cos, 0.0))


def _xlogx(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v > _EPS, v * torch.log(torch.clamp_min(v, _EPS)), 0.0)


# the most bytes one (n, chunk, K) float32 transient of the broadcast
# metrics (jsd, triangular, l1, linf) may take: they run over column
# chunks of ``y`` so a (512, 101,504, 112) call -- the exact phase of a
# 512-query batch at the paper's colors size, 23.3 GB per transient if
# broadcast whole -- fits on the card
PAIRWISE_CHUNK_BYTES = 256 * 2**20


def pair_chunk_cols(n: int, m: int, k: int) -> int:
    """Columns of ``y`` per pass so that an (n, cols, K) float32 transient
    stays within ``PAIRWISE_CHUNK_BYTES`` (at least one column)."""
    return max(1, min(m, PAIRWISE_CHUNK_BYTES // max(1, 4 * n * k)))


def _broadcast_pairwise(
    body: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    y: torch.Tensor,
) -> torch.Tensor:
    """(n, K), (m, K) -> (n, m): ``body`` on the (n, 1, K) and (1, cols, K)
    broadcast, one chunk of ``y`` rows at a time.  Every element keeps its
    arithmetic and order; only the columns per pass change."""
    x = x.float()[:, None, :]
    y = y.float()
    n, m, k = x.shape[0], y.shape[0], y.shape[1]
    cols = pair_chunk_cols(n, m, k)
    if cols >= m:
        return body(x, y[None, :, :])
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    for s in range(0, m, cols):
        out[:, s:s + cols] = body(x, y[None, s:s + cols, :])
    return out


def _dot_body(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * y, dim=-1)


def row_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(n, K), (m, K) -> (n, m) float32 inner products, each summed over K
    by itself (no matmul), so its bits do not depend on n or m."""
    return _broadcast_pairwise(_dot_body, x, y)


def _jsd_body(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    m = 0.5 * (x + y)
    js = torch.sum(0.5 * _xlogx(x) + 0.5 * _xlogx(y) - _xlogx(m), dim=-1)
    js = torch.clamp_min(js, 0.0) / math.log(2.0)
    return torch.sqrt(js)


def _triangular_body(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    num = (x - y) ** 2
    den = torch.clamp_min(x + y, _EPS)
    return torch.sqrt(torch.clamp_min(0.5 * torch.sum(num / den, dim=-1), 0.0))


def _l1_body(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(x - y), dim=-1)


def _linf_body(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(x - y), dim=-1)


def _jsd_pairwise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Jensen-Shannon distance (sqrt of the base-2 JS divergence) over
    probability vectors; the per-k sum of the reference registry."""
    return _broadcast_pairwise(_jsd_body, x, y)


def _triangular_pairwise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Triangular distance ``sqrt(0.5 * sum (x-y)^2 / (x+y))`` over
    probability vectors."""
    return _broadcast_pairwise(_triangular_body, x, y)


def _l1_pairwise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _broadcast_pairwise(_l1_body, x, y)


def _linf_pairwise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _broadcast_pairwise(_linf_body, x, y)


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
