"""The paper's own workload configuration — the port of
``repro.configs.supermetric``: metric-search corpora, index parameters and
the entry point that builds an index for one.

    from repro_torch.configs.supermetric import SISAP_COLORS, build_index
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import flat_index
from repro_torch.data import metricsets


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    name: str
    metric: str = "l2"
    # corpus
    dataset: str = "colors"           # key into data.metricsets.DATASETS
    n_points: int | None = None       # None = dataset default (paper size)
    # paper thresholds (l2); index-time calibration overrides when None
    thresholds: tuple = ()
    selectivities: tuple = (1e-5, 1e-4, 1e-3)
    # tree engine (paper §4 winner)
    tree_variant: str = "hpt_fft_log"
    exclusion: str = "hilbert"
    # BSS engine
    n_pivots: int = 16
    n_pairs: int = 24
    block: int = 128
    # LRT engine (§5 + §6 controlled unbalancing)
    lrt_partition: str = "lrt"
    lrt_select: str = "far"
    split_quantile: float = 0.5


SISAP_COLORS = SearchConfig(
    name="sisap-colors", dataset="colors",
    thresholds=(0.052, 0.083, 0.131),  # paper Table 3
)
SISAP_NASA = SearchConfig(
    name="sisap-nasa", dataset="nasa",
    thresholds=(0.120, 0.285, 0.530),
)
EUC10 = SearchConfig(
    name="euc10", dataset="euc10",
    thresholds=(0.229, 0.245, 0.263),
    selectivities=(1e-6, 2e-6, 4e-6),
)

CONFIGS = {c.name: c for c in (SISAP_COLORS, SISAP_NASA, EUC10)}


def load_corpus(cfg: SearchConfig, seed: int = 0):
    """(corpus, queries): the dataset at the config's size with the paper's
    10% query split."""
    gen = metricsets.DATASETS[cfg.dataset][0]
    data = gen(seed=seed) if cfg.n_points is None else gen(cfg.n_points, seed=seed)
    return metricsets.split_queries(data, 0.10, seed=seed + 1)


def build_index(cfg: SearchConfig, corpus: np.ndarray, engine: str = "bss",
                seed: int = 0, *, device=None):
    """engine: 'bss' (device defaults to the CUDA device, as in
    ``build_bss``); the reference's 'tree' and 'lrt' are not ported yet."""
    if engine == "bss":
        return flat_index.build_bss(
            cfg.metric, corpus, n_pivots=cfg.n_pivots, n_pairs=cfg.n_pairs,
            block=cfg.block, seed=seed, device=device,
        )
    if engine in ("tree", "lrt"):
        raise NotImplementedError(
            f"engine {engine!r} is not ported yet: ROADMAP Queue 1 item 4 "
            f"(forest, tree and LRT builds)"
        )
    raise ValueError(engine)
