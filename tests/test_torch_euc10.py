"""The paper's generated Euclidean space as the benchmark feeds it
(``portbench/datasets/euc10.py``, the cell ``euc10-l2-range``), and the
port's l2 range search over it on the CPU.

The benchmark's frozen draw is pinned bit for bit to the program's
``euc10`` and to checksums of the configuration's full corpus and query
pool.  At the paper_common reduced size (20,000 x 10, thresholds at
selectivities 5e-5 x 1, 2 and 4) ``RetrievalServer(metric="l2")`` on the
plain ``"torch"`` backend returns the brute force's hits over the
benchmark's float64 reference, but for rows within 1e-5 of ``t``; its
``dists_per_query`` is the recount of the surviving blocks' valid rows."""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import traffic  # noqa: E402
from portbench.datasets import euc10 as bench_euc10  # noqa: E402
from portbench.reference import l2 as ref  # noqa: E402
from repro_torch.core.flat_index import bss_lower_bounds  # noqa: E402
from repro_torch.data.metricsets import euc10  # noqa: E402
from repro_torch.serve.retrieval import RetrievalServer  # noqa: E402

CONFIG = json.loads((REPO / "portbench" / "configs" / "euc10-1m.json").read_text())
# sha256 of the float32 bytes the benchmark serves: the 10^6 rows and the
# 10,000 queries of ``euc10-1m``
CORPUS_SHA256 = "3a840e94b989c078c07625906e2715448ab52529310438f147a1d40f94092d66"
POOL_SHA256 = "f00e98b1fff0a2efe18051adc1e2aa3dca011936992d6c9a492a36740ce7d31e"
N, NQ = 20_000, 200
SELECTIVITIES = [5e-5, 1e-4, 2e-4]
BAND = 1e-5  # float32 against float64 at t: rows this near may fall either way


@pytest.mark.parametrize("n,seed", [(1, 0), (257, 0), (1000, 1), (4096, 7)])
def test_frozen_draw_is_the_programs_euc10(n, seed):
    got = bench_euc10.uniform(n, 10, seed)
    want = euc10(n, seed=seed)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))


def test_full_corpus_and_pool_match_their_checksums():
    data = bench_euc10.make(CONFIG, seed=2**31 + 11, device="cpu")
    assert data.corpus.shape == (CONFIG["n_points"], CONFIG["dim"]) == (1_000_000, 10)
    assert data.pool.shape == (CONFIG["n_queries"], CONFIG["dim"]) == (10_000, 10)
    assert data.corpus.dtype == data.pool.dtype == np.float32
    assert hashlib.sha256(data.corpus.tobytes()).hexdigest() == CORPUS_SHA256
    assert hashlib.sha256(data.pool.tobytes()).hexdigest() == POOL_SHA256
    # the run's seed orders the queries; it does not change the set
    again = bench_euc10.make(CONFIG, seed=5, device="cpu")
    assert np.array_equal(again.corpus, data.corpus) and np.array_equal(again.pool, data.pool)


@pytest.fixture(scope="module")
def served():
    """The reduced space, its thresholds (the benchmark's calibration over
    the float64 reference), the server over it and one range call a
    threshold."""
    cfg = dict(CONFIG, n_points=N, n_queries=NQ)
    data = bench_euc10.make(cfg, seed=0, device="cpu")

    def pairwise(a, b):
        return ref.pairwise(torch.as_tensor(a), torch.as_tensor(b)).numpy()

    spec = {"selectivities": SELECTIVITIES,
            "calibration": {"seed": 0, "n_query_sample": 200, "n_data_sample": N}}
    ts = traffic.thresholds(spec, data.corpus, pairwise)
    idx = cfg["index"]
    server = RetrievalServer(data.corpus, metric="l2", n_pivots=idx["n_pivots"],
                             n_pairs=idx["n_pairs"], block=idx["block"], seed=idx["seed"],
                             device="cpu")
    results = [server.search(data.pool, "range", t=t) for t in ts]
    return data, ts, server, results


def test_range_answers_are_the_brute_force(served):
    data, ts, _, results = served
    assert ts == sorted(ts) and ts[0] > 0
    d = ref.pairwise(torch.as_tensor(data.pool, dtype=torch.float64),
                     torch.as_tensor(data.corpus, dtype=torch.float64)).numpy()
    total = 0
    for t, res in zip(ts, results):
        got = np.zeros(d.shape, bool)
        for q, hits in enumerate(res.hits):
            assert len(set(hits)) == len(hits)
            got[q, hits] = True
        truth = d <= t
        wrong = got != truth
        assert np.all(np.abs(d[wrong] - t) <= BAND), np.abs(d[wrong] - t).max()
        total += int(truth.sum())
    # the reduced regime: about 1, 2 and 4 hits a query in all
    assert 0.5 * 7 * NQ < total < 2 * 7 * NQ


def test_dists_per_query_counts_the_surviving_blocks(served):
    data, ts, server, results = served
    index = server.index
    lb = bss_lower_bounds(index, data.pool)
    vpb = index.valid.reshape(index.n_blocks, index.block).sum(axis=1).astype(np.int64)
    n_pivots = index.pivots.shape[0]
    for t, res in zip(ts, results):
        alive = lb <= np.float32(t)
        exact = alive.astype(np.int64) @ vpb
        assert np.array_equal(res.stats["per_query_dists"], n_pivots + exact)
        assert res.stats["dists_per_query"] == float(n_pivots) + float(exact.mean())
        # the bound excludes blocks here (about half of them at this size)
        assert 0 < exact.mean() < 0.75 * N
