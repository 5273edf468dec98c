"""The paper's generated Euclidean space: rows uniform on [0,1)^dim, drawn
as the program's ``euc10`` draws them (``np.random.default_rng(seed)``'s
``random``), and a query pool drawn the same way from a second seed.  The
benchmark keeps its own frozen copy of that draw, so that a later change
to the program cannot change what the benchmark feeds it; the tests pin it
to the program's ``euc10`` and to checksums.  The set does not change with
the run's seed; the seed orders the queries (``portbench/traffic.py``)."""

from __future__ import annotations

import numpy as np

from portbench.datasets.common import Data


def uniform(n: int, dim: int, seed: int) -> np.ndarray:
    """(n, dim) float64, uniform on [0, 1)."""
    return np.random.default_rng(seed).random((n, dim))


def make(config: dict, seed: int, device) -> Data:
    corpus = uniform(config["n_points"], config["dim"], config["data_seed"])
    pool = uniform(config["n_queries"], config["dim"], config["query_seed"])
    return Data(corpus=corpus.astype(np.float32), pool=pool.astype(np.float32))
