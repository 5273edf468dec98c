"""Mixed-precision margins for the bf16 exact phase — the port of
``repro.core.precision``, with the same names and the same float64
arithmetic, so the margin is bit-equal to the reference's on the same
corpus (``tests/test_torch_precision.py``).

The engines stream a bfloat16 mirror of the corpus through the masked tile
kernels (fp32 accumulation: every kernel upcasts ``y`` on entry) without
giving up exactness: every threshold comparison against a bf16-phase
distance is widened by a margin ``eps`` and the boundary band is re-checked
against the fp32 corpus.  Write ``p~`` for the bf16 rounding of corpus point
``p``.  The supermetrics are metrics, so ``|d(q, p~) - d(q, p)| <= d(p, p~)``
for every query ``q``; ``r_max = max_p d(p, p~)`` is measured exactly, in
float64, over the valid rows, and a small term bounds the fp32 arithmetic:

    eps = 2 * r_max + ARITH_ULPS * eps_f32 * sqrt(dim) * scale

* range: every true hit has ``d16 <= t + eps``, and every ``d16 <= t - eps``
  is a true hit, so only the band ``t - eps < d16 <= t + eps`` needs fp32;
* kNN: ``|kth16 - kth32| <= eps``, so the true top-k lie in
  ``d16 <= kth16 + 2 * eps``.

The rounding is round-to-nearest-even through ``torch.bfloat16`` on the
CPU, the bits ``ml_dtypes`` gives (tested, subnormals and ties included);
the engine's mirror is built from these very bits, so the margin speaks of
the values the kernels read.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.npdist import pairwise_np

__all__ = ["ARITH_ULPS", "JSD_ACCURATE_BELOW", "bf16_round_np", "bf16_margin",
           "jsd_accurate_below", "prob_error_budget", "prob_error_verdict"]

# headroom multiplier on fp32 accumulation noise (the reference's)
ARITH_ULPS = 64.0

_F32_EPS = float(np.finfo(np.float32).eps)
_EPS = 1e-12  # probability-simplex guard, as npdist._EPS


def bf16_round_np(a: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even through bfloat16, returned as float32 — the
    exact values the engine's bf16 corpus mirror holds."""
    a32 = np.ascontiguousarray(a, np.float32)
    return torch.from_numpy(a32).to(torch.bfloat16).to(torch.float32).numpy()


def _xlogx(v: np.ndarray) -> np.ndarray:
    return np.where(v > _EPS, v * np.log(np.maximum(v, _EPS)), 0.0)


def _rowwise(metric_name: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """d(a[i], b[i]) per row, float64, with ``pairwise_np``'s guards (the
    diagonal of the oracle)."""
    a = np.asarray(a, np.float64)  # lint: disable=R3
    b = np.asarray(b, np.float64)  # lint: disable=R3
    if metric_name == "l2":
        return np.linalg.norm(a - b, axis=1)
    if metric_name == "cosine":
        an = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), _EPS)
        bn = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), _EPS)
        cos = np.clip(np.sum(an * bn, axis=1), -1.0, 1.0)
        return np.sqrt(np.maximum(2.0 - 2.0 * cos, 0.0))
    if metric_name == "jsd":
        m = 0.5 * (a + b)
        js = np.sum(0.5 * _xlogx(a) + 0.5 * _xlogx(b) - _xlogx(m), axis=1)
        return np.sqrt(np.maximum(js, 0.0) / np.log(2.0))
    if metric_name == "triangular":
        s = np.maximum(a + b, _EPS)
        return np.sqrt(np.maximum(0.5 * np.sum((a - b) ** 2 / s, axis=1), 0.0))
    # power transforms and anything else: chunked diagonal of the oracle
    out = np.empty(a.shape[0], np.float64)  # lint: disable=R3
    chunk = 64
    for lo in range(0, a.shape[0], chunk):
        hi = min(lo + chunk, a.shape[0])
        out[lo:hi] = np.diagonal(pairwise_np(metric_name, a[lo:hi], b[lo:hi]))
    return out


def _arith_scale(metric_name: str, data64: np.ndarray) -> float:
    """Magnitude scale for the fp32-accumulation noise term."""
    if metric_name in ("jsd", "triangular"):
        return 1.0  # distances live in [0, 1]
    if metric_name == "cosine":
        return 2.0  # distances live in [0, 2]
    norms = np.linalg.norm(data64, axis=1)
    return 1.0 + (float(norms.max()) if norms.size else 0.0)


def bf16_margin(
    metric_name: str, data: np.ndarray, valid: np.ndarray | None = None
) -> float:
    """Conservative comparison margin for bf16-phase distances against the
    corpus ``data`` (engine space: already normalised for cosine-as-l2),
    restricted to ``valid`` rows (padding rows are never hits and must not
    widen the band)."""
    data = np.asarray(data, np.float32)
    if valid is not None:
        data = data[np.asarray(valid, bool)]
    dim = int(data.shape[1]) if data.ndim == 2 else 1
    if data.size == 0:
        return float(_F32_EPS)
    data64 = np.asarray(data, np.float64)  # lint: disable=R3
    r = _rowwise(metric_name, data64, bf16_round_np(data).astype(np.float64))  # lint: disable=R3
    eps = 2.0 * float(r.max()) + ARITH_ULPS * _F32_EPS * math.sqrt(dim) * (
        _arith_scale(metric_name, data64)
    )
    # round UP into fp32 so the fp32 comparisons inherit the guarantee
    return float(np.nextafter(np.float32(eps), np.float32(np.inf)))


# --- the JSD / Triangular tiles' own arithmetic error (port only) ---------
#
# The CUDA tiles (csrc/prob_dist.cu) take the mixture logarithm and the
# reciprocal from the special function units.  Their error has to stay
# inside the fp32 arithmetic term of ``eps`` above, ARITH_ULPS * eps_f32 *
# sqrt(dim) (scale 1 for both metrics), for the two passes of the bf16
# proof; the source note derives the bound.


# Below this JSD distance the tile recomputes a cell with the accurate
# logarithm (csrc/prob_dist.cu, "Near duplicates").
JSD_ACCURATE_BELOW = 0.05


def jsd_accurate_below(k: int) -> float:
    """The fast sum S (JSD^2 in bits) below which the JSD tile recomputes a
    cell: S at ``JSD_ACCURATE_BELOW`` plus the fast sum's error bound there
    (``csrc/prob_dist.cu::jsd_accurate_below``, in the same arithmetic)."""
    u = _F32_EPS / 2
    s = JSD_ACCURATE_BELOW ** 2
    log_k = math.log2(max(k, 1))
    return float(np.float32(s + 2.0 ** -22 * (1 + log_k) + u * (6 * log_k + 2)
                            + (k + 1) * u * 2 * s))


def prob_error_budget(metric_name: str, k: int, d) -> tuple[np.ndarray, np.ndarray]:
    """The bound on |d_kernel - d_exact| of the JSD / Triangular tiles over
    K = ``k`` bins (``csrc/prob_dist.cu``): (the part from lg2.approx /
    rcp.approx, the part from fp32 rounding).  ``d`` is the smaller of the
    two distances (array or scalar).  JSD bounds the error dS of S = JSD^2
    in bits and carries it to d through |d~ - d| = |d~^2 - d^2| / (d~ + d)
    <= dS / 2d; Triangular's is relative.

    JSD has two regimes.  From ``JSD_ACCURATE_BELOW`` up the tile's fast sum
    (lg2.approx) stands; below it every cell is recomputed with the
    accurate logarithm in the plain version's per-k form, whose budget has
    no approximate part.  A cell whose smaller distance is below
    ``JSD_ACCURATE_BELOW`` was recomputed: its exact distance is, or its
    output is, and a fast output is never below it.  The fp32 part of each
    regime bounds the plain fp32 version there, which has no approximate
    instruction."""
    u = _F32_EPS / 2  # fp32 unit roundoff
    d = np.maximum(d, 1e-30)
    if metric_name == "jsd":
        log_k = math.log2(max(k, 1))
        near = d < JSD_ACCURATE_BELOW
        approx = np.where(near, 0.0, 2.0 ** -22 * (1 + log_k) / (2 * d))
        fp32 = np.where(
            near,
            (u * (8 * log_k + 1 / math.log(2)) + (k + 3) * u * d * d) / (2 * d) + u * d,
            (u * (6 * log_k + 2) + (k + 1) * u * d * d) / (2 * d) + 2 * u * d,
        )
        return approx, fp32
    if metric_name == "triangular":
        return d * u, d * u * ((k + 3) / 2 + 1)
    raise KeyError(f"no error budget for {metric_name!r}: the l2 tile is IEEE fp32")


def prob_error_verdict(metric_name: str, k: int, got: np.ndarray, exact: np.ndarray,
                       at: float) -> dict:
    """``got`` (a tile's distances) against ``exact`` (float64, same cells):
    the largest error, the cells over their budget, and the budget at
    ``at`` (the smallest threshold or kth in use) beside the arithmetic
    term.  ``ok``: no cell over budget, and twice the budget at ``at``
    inside the term."""
    got = np.asarray(got, np.float64)  # lint: disable=R3
    err = np.abs(got - exact)
    approx, fp32 = prob_error_budget(metric_name, k, np.minimum(got, exact))
    a_at, f_at = (float(v) for v in prob_error_budget(metric_name, k, at))
    arith = ARITH_ULPS * _F32_EPS * math.sqrt(k)
    over = int((err > approx + fp32).sum())
    return dict(cells=int(err.size), max_abs_err=float(err.max()) if err.size else 0.0,
                cells_over_budget=over, at=float(at), budget_at=a_at + f_at,
                budget_approx_part=a_at, budget_fp32_part=f_at, arith_term=arith,
                ok=over == 0 and 2 * (a_at + f_at) <= arith)
