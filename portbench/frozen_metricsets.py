"""Frozen copies of the SISAP colors surrogate and the paper's query
protocol.

The yardstick's own copy of the program's data generators
(``colors_surrogate``, ``split_queries``, ``calibrate_threshold``), kept
here so that a later change to the program cannot change what the
benchmark feeds it.  ``calibrate_threshold`` takes the distance function
as an argument: the benchmark hands it the plain reference's.
``portbench/tests/test_bench_parts.py`` pins the outputs to their own
checksums.
"""

from __future__ import annotations

import numpy as np

def colors_surrogate(n: int = 112_682, dim: int = 112, seed: int = 0) -> np.ndarray:
    """Colour-histogram-like: non-negative, rows sum to 1, heavily clustered.

    Mixture of Dirichlet clusters with Zipf-skewed weights + 4% diffuse
    outliers — mimics the clustered/outlier structure visible in the paper's
    appendix scatter plots.
    """
    rng = np.random.default_rng(seed)
    k = 40
    # sparse cluster centres (few dominant bins, like colour histograms)
    centres = rng.gamma(0.35, size=(k, dim))
    centres /= centres.sum(axis=1, keepdims=True)
    weights = 1.0 / np.arange(1, k + 1) ** 1.1
    weights /= weights.sum()
    kappa = rng.lognormal(mean=4.5, sigma=0.6, size=k)  # cluster tightness
    assign = rng.choice(k, size=n, p=weights)
    alpha = centres[assign] * kappa[assign, None] + 1e-3
    pts = rng.gamma(np.maximum(alpha, 1e-6))
    pts /= np.maximum(pts.sum(axis=1, keepdims=True), 1e-12)
    outliers = rng.random(n) < 0.04
    if outliers.any():
        o = rng.gamma(0.5, size=(int(outliers.sum()), dim))
        o /= o.sum(axis=1, keepdims=True)
        pts[outliers] = o
    return pts.astype(np.float64)


def split_queries(
    data: np.ndarray, frac: float = 0.10, seed: int = 0, max_queries: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Paper protocol: remove a random fraction of the data as the query set."""
    rng = np.random.default_rng(seed)
    n = data.shape[0]
    nq = int(n * frac)
    idx = rng.permutation(n)
    q = data[idx[:nq]]
    if max_queries is not None:
        q = q[:max_queries]
    return data[idx[nq:]], q


def calibrate_threshold(
    pairwise,
    data: np.ndarray,
    selectivity: float,
    seed: int = 0,
    n_query_sample: int = 200,
    n_data_sample: int = 20_000,
) -> float:
    """Distance quantile so a range query returns ~selectivity * |data|."""
    rng = np.random.default_rng(seed)
    qi = rng.choice(data.shape[0], size=min(n_query_sample, data.shape[0]), replace=False)
    di = rng.choice(data.shape[0], size=min(n_data_sample, data.shape[0]), replace=False)
    d = pairwise(data[qi], data[di]).ravel()
    d = d[d > 1e-12]  # drop self-pairs (query/data samples overlap)
    return float(np.quantile(d, selectivity))
