"""The one traffic generator: a traffic file (``portbench/traffic/<name>.json``)
of parameters, read for a configuration's query pool and the run's seed.

Keys of a traffic file:

* ``kind``: ``"knn"`` or ``"range"``, the search each call makes;
* ``batch``: queries a call; ``k``: neighbours a kNN query;
* ``selectivities``: for range, the calls' thresholds are the reference's
  distance quantiles at these selectivities over the corpus (the paper's
  calibration, ``calibrate_threshold`` with ``calibration``'s ``seed``,
  ``n_query_sample`` and ``n_data_sample``), taken by the calls in turn.

The queries are the pool's rows in an order drawn from the seed: one
permutation after another, each call the next ``batch`` rows, so every
seed sends the same rows in another order.  The warm-up draws its own
stream.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

WINDOW, WARMUP = 0, 1  # streams drawn from one seed


@dataclasses.dataclass
class Call:
    rows: np.ndarray          # pool rows of the call's queries
    t: float | None = None    # range threshold


def seed_words(seed: int) -> list[int]:
    """Any whole number as entropy for ``np.random.default_rng``."""
    seed = int(seed) % (1 << 64)
    return [seed & 0xFFFFFFFF, seed >> 32]


def thresholds(spec: dict, corpus: np.ndarray, pairwise) -> list[float]:
    """The range thresholds of ``spec`` over ``corpus``; ``pairwise(a, b)``
    is the reference's distance matrix of two float64 row sets."""
    from portbench.frozen_metricsets import calibrate_threshold

    cal = spec["calibration"]
    rows = corpus.astype(np.float64)
    return [calibrate_threshold(pairwise, rows, s, seed=cal["seed"],
                                n_query_sample=cal["n_query_sample"],
                                n_data_sample=cal["n_data_sample"])
            for s in spec["selectivities"]]


def calls(spec: dict, pool_size: int, seed: int, stream: int = WINDOW,
          ts: list[float] | None = None):
    """The calls of one stream, without end."""
    if spec["kind"] == "range" and not ts:
        raise ValueError("range traffic needs its thresholds")
    rng = np.random.default_rng(seed_words(seed) + [stream])
    batch = spec["batch"]
    order = np.empty(0, np.int64)
    for i in itertools.count():
        while order.size < batch:
            order = np.concatenate([order, rng.permutation(pool_size)])
        rows, order = order[:batch], order[batch:]
        yield Call(rows=rows, t=None if spec["kind"] == "knn" else ts[i % len(ts)])
