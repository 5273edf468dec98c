# Copy of src/repro/core/refpoints.py, kept so the port imports nothing of the JAX
# package; tests/test_torch_copies.py pins it to the original.
"""Reference-point (pivot) selection strategies.

A central empirical finding of the paper (§3.3, §4.3): with four-point
(Hilbert) exclusion, search performance is nearly *invariant* to pivot
choice, so cheap strategies (random / FFT) suffice — "putting huge
computational resources into building expensive data structures may be far
less worthwhile in this context".  We implement the paper's set: random, FFT
(farthest-first traversal), max-separation sampling, plus outlier selection
for SAT roots.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.npdist import pairwise_np

__all__ = ["select_random", "select_fft", "select_maxsep_pair", "select_outlier"]


def select_random(rng: np.random.Generator, n_pts: int, k: int) -> np.ndarray:
    """k distinct indices uniformly at random."""
    return rng.choice(n_pts, size=min(k, n_pts), replace=False)


def select_fft(
    metric: str,
    data: np.ndarray,
    k: int,
    rng: np.random.Generator,
    sample_cap: int = 4096,
) -> np.ndarray:
    """Farthest-first traversal (greedy k-center, Gonzalez).

    Seeded from a random point; each next pivot maximises the min-distance to
    pivots chosen so far.  For large nodes we FFT over a random subsample
    (standard practice; the paper's point is precisely that pivot quality
    barely matters under Hilbert exclusion).
    """
    n = data.shape[0]
    k = min(k, n)
    if n > sample_cap:
        cand = rng.choice(n, size=sample_cap, replace=False)
    else:
        cand = np.arange(n)
    sub = data[cand]
    first = int(rng.integers(len(cand)))
    chosen = [first]
    min_d = pairwise_np(metric, sub[first], sub)[0]
    for _ in range(k - 1):
        nxt = int(np.argmax(min_d))
        chosen.append(nxt)
        d_new = pairwise_np(metric, sub[nxt], sub)[0]
        min_d = np.minimum(min_d, d_new)
    return cand[np.array(chosen, dtype=np.int64)]


def select_maxsep_pair(
    metric: str, data: np.ndarray, rng: np.random.Generator, n_pairs: int = 1000
) -> tuple[int, int]:
    """Most-separated pair out of ``n_pairs`` random samples (paper §3.3)."""
    n = data.shape[0]
    a = rng.integers(0, n, size=n_pairs)
    b = rng.integers(0, n, size=n_pairs)
    dd = np.array(
        [pairwise_np(metric, data[a[i]], data[b[i]][None, :])[0, 0] for i in range(n_pairs)]
    )
    i = int(np.argmax(dd))
    return int(a[i]), int(b[i])


def select_outlier(
    metric: str, data: np.ndarray, rng: np.random.Generator, sample_cap: int = 4096
) -> int:
    """SAT_out root selection: an outlier — farthest point from a random
    seed (one FFT step), per DiSAT practice [3]."""
    n = data.shape[0]
    if n > sample_cap:
        cand = rng.choice(n, size=sample_cap, replace=False)
    else:
        cand = np.arange(n)
    seed = data[int(rng.integers(n))]
    d = pairwise_np(metric, seed, data[cand])[0]
    return int(cand[int(np.argmax(d))])
