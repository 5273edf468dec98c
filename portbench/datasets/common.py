"""What a data generator returns."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Data:
    corpus: np.ndarray  # (n, d) float32: the rows the index is built over
    pool: np.ndarray    # (m, d) float32: the queries the traffic draws from
