# Copy of src/repro/data/metricsets.py, kept so the port imports nothing of the JAX
# package; tests/test_torch_copies.py pins it to the original.
"""Metric-space benchmark datasets.

``euc10`` follows the paper exactly (uniformly random 10-d Euclidean).  The
SISAP ``colors`` / ``nasa`` sets cannot be downloaded in this offline
container, so we generate **surrogates** with matching cardinality /
dimensionality and the property the paper leans on: strongly non-uniform,
clustered "real-world" structure (mixtures with skewed cluster weights plus
outliers).  Absolute distance counts will differ from the published numbers;
all *relative* claims are checked against these surrogates (see DESIGN.md §6).

Thresholds are calibrated the way the paper describes its own: by target
selectivity (fraction of the dataset returned per query).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.npdist import pairwise_np

__all__ = [
    "euc10",
    "colors_surrogate",
    "nasa_surrogate",
    "topics_surrogate",
    "split_queries",
    "calibrate_threshold",
    "DATASETS",
    "PROB_DATASETS",
]


def euc10(n: int = 100_000, seed: int = 0) -> np.ndarray:
    """Uniform [0,1]^10, the paper's generated benchmark."""
    rng = np.random.default_rng(seed)
    return rng.random((n, 10)).astype(np.float64)  # lint: disable=R3


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
    return pts.astype(np.float64)  # lint: disable=R3


def nasa_surrogate(n: int = 40_150, dim: int = 20, seed: int = 0) -> np.ndarray:
    """PCA-reduced-feature-like: Gaussian mixture with decaying eigen-spectrum
    and a heavy tail, normalised to the paper's scale (distances O(0.1-1))."""
    rng = np.random.default_rng(seed)
    k = 15
    spectrum = 1.0 / np.arange(1, dim + 1) ** 1.2
    weights = rng.dirichlet(np.full(k, 0.5))
    means = rng.normal(size=(k, dim)) * np.sqrt(spectrum) * 1.5
    assign = rng.choice(k, size=n, p=weights)
    # heavy-tailed per-point spread with a floor (no exact duplicates: a
    # scale of ~0 would collapse points onto cluster means and degenerate
    # low-selectivity threshold calibration)
    scale = np.abs(rng.standard_t(df=6, size=(n, 1)) * 0.15) + 0.35
    pts = means[assign] + rng.normal(size=(n, dim)) * np.sqrt(spectrum) * scale
    pts *= 0.25  # scale so t-values land near the paper's range (~0.1-0.5)
    return pts.astype(np.float64)  # lint: disable=R3


def topics_surrogate(n: int = 24_576, dim: int = 64, seed: int = 0) -> np.ndarray:
    """Topic-model / term-histogram embeddings: probability vectors on the
    ``dim``-simplex, the corpus type served under the probability-space
    supermetrics (Jensen-Shannon and Triangular, paper §2.2).

    Mixture of sparse Dirichlet topic profiles with Zipf-skewed topic
    popularity: most documents concentrate on a few topics (tight clusters
    the four-point bound can prune), a diffuse tail keeps the space honest.
    """
    rng = np.random.default_rng(seed)
    k = 24
    profiles = rng.gamma(0.25, size=(k, dim))  # sparse: few dominant terms
    profiles /= profiles.sum(axis=1, keepdims=True)
    weights = 1.0 / np.arange(1, k + 1) ** 1.2
    weights /= weights.sum()
    conc = rng.lognormal(mean=4.0, sigma=0.5, size=k)  # per-topic tightness
    assign = rng.choice(k, size=n, p=weights)
    alpha = profiles[assign] * conc[assign, None] + 1e-3
    pts = rng.gamma(np.maximum(alpha, 1e-6))
    pts /= np.maximum(pts.sum(axis=1, keepdims=True), 1e-12)
    diffuse = rng.random(n) < 0.05
    if diffuse.any():
        o = rng.gamma(0.8, size=(int(diffuse.sum()), dim))
        o /= o.sum(axis=1, keepdims=True)
        pts[diffuse] = o
    return pts.astype(np.float64)  # lint: disable=R3


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
    metric: str,
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
    d = pairwise_np(metric, data[qi], data[di]).ravel()
    d = d[d > 1e-12]  # drop self-pairs (query/data samples overlap)
    return float(np.quantile(d, selectivity))


# name -> (generator, paper thresholds for l2 at t0/t1/t2, target selectivities)
DATASETS = {
    "euc10": (euc10, (0.229, 0.245, 0.263), (1e-6, 2e-6, 4e-6)),
    "colors": (colors_surrogate, (0.052, 0.083, 0.131), (1e-5, 1e-4, 1e-3)),
    "nasa": (nasa_surrogate, (0.120, 0.285, 0.530), (1e-5, 1e-4, 1e-3)),
}

# probability-vector corpora (rows on the simplex) — valid under every
# metric in the registry including the probability-space supermetrics
PROB_DATASETS = {
    "topics": topics_surrogate,
    "colors": colors_surrogate,
}
