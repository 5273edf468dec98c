# Copy of src/repro/core/npdist.py, kept so the port imports nothing of the JAX
# package; tests/test_torch_copies.py pins it to the original.
"""Host-side (numpy) distance evaluation for tree build & distance-counted
query replay.

The paper's experiments measure *number of distance evaluations per query*;
that bookkeeping runs on the host over array-encoded trees (pointer-chasing
is a CPU-side concern).  The TPU engines (`flat_index`, `kernels/`) use the
jnp/Pallas implementations in `distances.py`; these numpy twins are
cross-validated against them in tests.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pairwise_np", "register_power", "DistanceCounter"]

_EPS = 1e-12


def _l2(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    sq = (
        np.sum(x * x, axis=-1)[:, None]
        + np.sum(y * y, axis=-1)[None, :]
        - 2.0 * (x @ y.T)
    )
    return np.sqrt(np.maximum(sq, 0.0))


def _cosine(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    xn = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), _EPS)
    yn = y / np.maximum(np.linalg.norm(y, axis=-1, keepdims=True), _EPS)
    cos = np.clip(xn @ yn.T, -1.0, 1.0)
    return np.sqrt(np.maximum(2.0 - 2.0 * cos, 0.0))


def _xlogx(v: np.ndarray) -> np.ndarray:
    return np.where(v > _EPS, v * np.log(np.maximum(v, _EPS)), 0.0)


def _jsd(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    x = x[:, None, :]
    y = y[None, :, :]
    m = 0.5 * (x + y)
    js = np.sum(0.5 * _xlogx(x) + 0.5 * _xlogx(y) - _xlogx(m), axis=-1)
    return np.sqrt(np.maximum(js, 0.0) / np.log(2.0))


def _triangular(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    x = x[:, None, :]
    y = y[None, :, :]
    return np.sqrt(
        np.maximum(0.5 * np.sum((x - y) ** 2 / np.maximum(x + y, _EPS), axis=-1), 0.0)
    )


def _l1(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return np.sum(np.abs(x[:, None, :] - y[None, :, :]), axis=-1)


def _linf(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return np.max(np.abs(x[:, None, :] - y[None, :, :]), axis=-1)


_FNS = {
    "l2": _l2,
    "cosine": _cosine,
    "jsd": _jsd,
    "triangular": _triangular,
    "l1": _l1,
    "linf": _linf,
}


def register_power(base: str, alpha: float) -> str:
    """Register the numpy twin of ``distances.power_transform(base, alpha)``
    under the canonical ``"{base}^{alpha}"`` name; returns the name."""
    name = f"{base}^{alpha}"
    if name not in _FNS:
        base_fn = _FNS[base]

        def pw(x, y, _b=base_fn, _a=alpha):
            # host-side numpy twin: runs on numpy arrays only, never traced
            return np.power(np.maximum(_b(x, y), 0.0), _a)  # lint: disable=R2

        _FNS[name] = pw
    return name


def _resolve(name: str):
    fn = _FNS.get(name)
    if fn is None and "^" in name:
        # power-transform names ("l1^0.5") parse + register on first use,
        # mirroring distances.get_metric
        base, _, exp = name.partition("^")
        if base in _FNS:
            try:
                alpha = float(exp)
            except ValueError:
                alpha = None
            # same bound as distances.power_transform: only 0 < a <= 1/2
            # guarantees the four-point property the engines rely on
            if (
                alpha is not None
                and 0.0 < alpha <= 0.5
                and f"{base}^{alpha}" == name
            ):
                fn = _FNS[register_power(base, alpha)]
    if fn is None:
        raise KeyError(f"unknown metric {name!r}; have {sorted(_FNS)}")
    return fn


def pairwise_np(name: str, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    fn = _resolve(name)
    x = np.asarray(x, np.float64)  # lint: disable=R3
    y = np.asarray(y, np.float64)  # lint: disable=R3
    if x.ndim == 1:
        x = x[None, :]
    if y.ndim == 1:
        y = y[None, :]
    return fn(x, y)


class DistanceCounter:
    """Wraps a metric; every evaluated (query, point) pair is tallied.

    The tally IS the paper's figure of merit.  ``per_query`` holds one counter
    per query row so means/medians can be reported exactly as the paper does.
    """

    def __init__(self, metric_name: str, n_queries: int):
        self.name = metric_name
        self.per_query = np.zeros(n_queries, dtype=np.int64)

    def pairwise(self, qidx: np.ndarray, queries: np.ndarray, pts: np.ndarray):
        d = pairwise_np(self.name, queries, pts)
        self.per_query[qidx] += pts.shape[0] if pts.ndim > 1 else 1
        return d

    @property
    def mean(self) -> float:
        return float(self.per_query.mean())
