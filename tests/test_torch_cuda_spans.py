"""The engine's spans on the card (``repro_torch.obs.record``): the kNN
rounds' ``bss.knn.top_k`` spans resolve their CUDA event pairs to device
ms inside their round, the range bound and exact phases resolve theirs
inside the call, and a ``"cuda"`` call counts its reads to the host: kNN
the bounds once and five arrays a round, range one (the hit positions
beside the counts and the stats' sums).  Results and stats are the same
with the profiler on.  The file imports no jax; on the card it runs as

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_spans.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.backends import EngineOpts
from repro_torch.kernels import _build
from repro_torch.obs import record
from repro_torch.serve.retrieval import RetrievalServer

CUDA = EngineOpts(backend="cuda", realisation="dense")


@pytest.fixture
def card():
    """The CUDA device, or a skip where no sm_90 card and nvcc are."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    try:
        _build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["knn", "range"])
def test_spans_on_card(card, kind):
    rng = np.random.default_rng(7)
    x = rng.random((6064, 32)).astype(np.float32) + 1e-3
    x /= x.sum(axis=1, keepdims=True)
    server = RetrievalServer(x[:6000], metric="jsd", n_pivots=8, n_pairs=12, block=64,
                             seed=0, device=card, opts=CUDA)

    def call():
        if kind == "knn":
            return server.search(x[6000:], "knn", k=10)
        return server.search(x[6000:], "range", t=0.05)

    off = call()
    record.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = call()
    recs = record.spans()
    record.clear()
    (root,) = [r for r in recs if r.parent is None]
    assert root.name == "retrieval.search"
    if kind == "knn":
        np.testing.assert_array_equal(on.indices, off.indices)
        np.testing.assert_array_equal(on.distances, off.distances)
        rounds = on.stats["rounds"]
        assert root.reads == 1 + 5 * rounds
        by_round = [r for r in recs if r.name == "bss.knn.round"]
        top = [r for r in recs if r.name == "bss.knn.top_k"]
        assert len(by_round) == len(top) == rounds
        for t, rnd in zip(top, by_round):
            assert 0 < t.device_ms < (rnd.t1 - rnd.t0) * 1e3
    else:
        assert on.hits == off.hits
        assert root.reads == 1
        _check_range_phases(recs, root)
    assert _same(on.stats, off.stats)


def _check_range_phases(recs, root):
    """One bound and one exact span with device ms each, inside the call."""
    bound = [r for r in recs if r.name == "bss.range.bound"]
    exact = [r for r in recs if r.name == "bss.range.exact" and r.device_ms is not None]
    assert len(bound) == len(exact) == 1
    for r in bound + exact:
        assert 0 < r.device_ms < (root.t1 - root.t0) * 1e3, r


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_l2_range_phases_on_card(card, prec):
    """The l2 range pass over points uniform in [0,1)^10: the bound and
    exact spans carry device ms, and hits and every stats key are the
    same with the profiler on and off."""
    rng = np.random.default_rng(11)
    x = rng.random((20_480, 10)).astype(np.float32)
    server = RetrievalServer(x[:20_000], metric="l2", n_pivots=16, n_pairs=24, block=128,
                             seed=0, device=card,
                             opts=EngineOpts(backend="cuda", realisation="dense", precision=prec))

    def call():
        return server.search(x[20_000:], "range", t=0.3)

    off = call()
    record.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = call()
    recs = record.spans()
    record.clear()
    (root,) = [r for r in recs if r.parent is None]
    assert on.hits == off.hits and sum(map(len, on.hits)) > 0
    _check_range_phases(recs, root)
    assert _same(on.stats, off.stats)
