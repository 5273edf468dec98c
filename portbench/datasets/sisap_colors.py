"""The SISAP colors surrogate under the paper's protocol: the set at its
configured size, 10% of its rows taken out as the queries.  The set is the
deployment's data and does not change with the run's seed; the seed orders
the queries (``portbench/traffic.py``)."""

from __future__ import annotations

import numpy as np

from portbench.datasets.common import Data
from portbench.frozen_metricsets import colors_surrogate, split_queries


def make(config: dict, seed: int, device) -> Data:
    rows = colors_surrogate(config["n_points"], config["dim"], seed=config["data_seed"])
    corpus, queries = split_queries(rows, config["query_frac"], seed=config["split_seed"])
    return Data(corpus=corpus.astype(np.float32), pool=queries.astype(np.float32))
