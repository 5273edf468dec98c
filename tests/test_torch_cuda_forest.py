"""The port's forest walks on the card: the masked tile kernels against the
plain ``"torch"`` backend on the same card, the bf16 leaf phase against
fp32, and the walk's promise that nothing in it waits for the host
(``torch.cuda.set_sync_debug_mode("error")`` around a whole batch).  The
file imports no jax; on the card it runs as

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_forest.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import forest
from repro_torch.core import lrt, tree
from repro_torch.core.backends import EngineOpts
from repro_torch.core.exclusion import HILBERT, HYPERBOLIC
from repro_torch.core.npdist import pairwise_np
from repro_torch.forest import walk
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.serve.front import ServingFront
from repro_torch.serve.retrieval import RetrievalServer

CUDA = EngineOpts(backend="cuda")
TORCH = EngineOpts(backend="torch")
BAND = 1e-5  # fp32 summation order may move a distance this close to t


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(metric: str = "l2", n: int = 4000, nq: int = 150, dim: int = 24):
    rng = np.random.default_rng(31)
    centres = rng.random((20, dim))
    x = centres[rng.integers(0, 20, size=n + nq)] + 0.05 * rng.random((n + nq, dim))
    x = x.astype(np.float32) + 1e-3
    if metric in ("jsd", "triangular"):
        x /= x.sum(axis=1, keepdims=True)
    db, q = x[:n], x[n:]
    d = np.sort(pairwise_np(metric, q[:20], db).ravel())
    return db, q, float(d[int(3e-3 * d.size)])


def _assert_close_hits(metric, db, q, a, b, t):
    """Hit lists equal except points within 1e-5 * max(1, t) of t in
    float64 (fp32 summation order may move a distance that close)."""
    for qi, (ha, hb) in enumerate(zip(a, b)):
        diff = sorted(set(ha) ^ set(hb))
        if diff:
            d = pairwise_np(metric, q[qi], db[diff])[0]
            assert np.all(np.abs(d - t) <= BAND * max(1.0, t)), (qi, diff, d, t)
        else:
            assert sorted(ha) == sorted(hb), qi


@pytest.mark.cuda
@pytest.mark.parametrize("mech", [HILBERT, HYPERBOLIC])
@pytest.mark.parametrize("variant", ["hpt_fft_log", "sat_pure", "hpt_random_binary"])
def test_forest_cuda_matches_torch_on_the_card(card, variant, mech):
    db, q, t = _case()
    tr = tree.build_tree(variant, "l2", db, seed=3)
    enc = forest.encode_tree(tr)
    assert enc.torch_device.type == "cuda"
    reset_launch_counts()
    hits, st = forest.forest_range_search(enc, q, t, mech, opts=CUDA)
    counts = launch_counts()
    assert counts["masked_pairwise_l2"] == len(enc.levels) + 1
    assert st["backend"] == "cuda"
    p_hits, p_st = forest.forest_range_search(enc, q, t, mech, opts=TORCH)
    assert launch_counts() == counts  # the plain backend launches nothing
    _assert_close_hits("l2", db, q, hits, p_hits, t)
    np.testing.assert_array_equal(st["per_query_dists"], p_st["per_query_dists"])
    o_hits, counter = tree.range_search(tr, q, t, mech)
    _assert_close_hits("l2", db, q, hits, o_hits, t)
    np.testing.assert_array_equal(st["per_query_dists"], counter.per_query)


@pytest.mark.cuda
@pytest.mark.parametrize("partition", ["lrt", "closer", "pca"])
def test_monotone_cuda_matches_torch_on_the_card(card, partition):
    db, q, t = _case()
    tr = lrt.build_monotone_tree(partition, "far", "l2", db, seed=3)
    enc = forest.encode_monotone(tr)
    hits, st = forest.monotone_range_search(enc, q, t, HILBERT, opts=CUDA)
    p_hits, p_st = forest.monotone_range_search(enc, q, t, HILBERT, opts=TORCH)
    _assert_close_hits("l2", db, q, hits, p_hits, t)
    np.testing.assert_array_equal(st["per_query_dists"], p_st["per_query_dists"])
    o_hits, counter = lrt.range_search_monotone(tr, q, t, HILBERT)
    _assert_close_hits("l2", db, q, hits, o_hits, t)
    np.testing.assert_array_equal(st["per_query_dists"], counter.per_query)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "jsd", "triangular"])
def test_bf16_leaf_phase_equals_fp32_on_the_card(card, metric):
    """Hits, counts, attribution and frontier of the bf16 leaf phase equal
    the fp32 walk's bit for bit; the bf16 tile ran."""
    db, q, t = _case(metric)
    enc = forest.encode_tree(tree.build_tree("hpt_fft_log", metric, db, seed=3))
    hits32, st32 = forest.forest_range_search(enc, q, t, opts=CUDA)
    reset_launch_counts()
    hits16, st16 = forest.forest_range_search(
        enc, q, t, opts=EngineOpts(backend="cuda", precision="bf16"))
    entry = {"l2": "l2", "jsd": "jsd", "triangular": "tri"}[metric]
    assert launch_counts()[f"masked_pairwise_{entry}_bf16"] == 1
    assert hits16 == hits32
    np.testing.assert_array_equal(st16["per_query_dists"], st32["per_query_dists"])
    np.testing.assert_array_equal(st16["frontier_occupancy"], st32["frontier_occupancy"])
    for m in st32["excluded"]:
        np.testing.assert_array_equal(st16["excluded"][m], st32["excluded"][m])
    assert sum(map(len, hits32)) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_walks_never_wait_for_the_host(card, precision):
    """A whole batch of each walker under ``set_sync_debug_mode("error")``:
    no ``.item()``, no host branch on a tensor, no ``nonzero`` inside."""
    db, q, t = _case()
    encs = (
        (walk._forest_walk,
         forest.encode_tree(tree.build_tree("sat_pure", "l2", db, seed=3))),
        (walk._monotone_walk,
         forest.encode_monotone(lrt.build_monotone_tree("lrt", "far", "l2", db, seed=3))),
    )
    for fn, enc in encs:
        bf16 = precision == "bf16"
        args = (
            enc.metric, torch.as_tensor(q, device=card),
            torch.tensor(t, dtype=torch.float32, device=card), enc.device,
            enc.leaf_bf16 if bf16 else None,
            torch.tensor(enc.bf16_eps(), dtype=torch.float32, device=card) if bf16 else None,
        )
        kw = dict(mechanism=HILBERT, backend="cuda")
        want = fn(*args, **kw)  # warm-up: the libraries load here
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        flat_want = [x for x in want[:-1] for x in (x if isinstance(x, tuple) else (x,))]
        flat_got = [x for x in got[:-1] for x in (x if isinstance(x, tuple) else (x,))]
        for a, b in zip(flat_got, flat_want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_forest_server_and_front_on_the_card(card):
    """``RetrievalServer(index="forest")`` builds for the card, and its
    front's results equal direct ``"cuda"`` walks."""
    db, q, t = _case()
    server = RetrievalServer(db, metric="l2", index="forest", seed=3)
    assert server.index.torch_device.type == "cuda"
    direct, st = forest.forest_range_search(server.index, q[:20], t, opts=CUDA)
    assert server.search(q[:20], "range", t=t).hits == direct
    with ServingFront(server.index, buckets=(32,), max_delay_s=0.01, start=False) as front:
        futs = [front.submit(v, "range", t=t) for v in q[:20]]
        front.start()
        res = [f.result(timeout=300) for f in futs]
    assert [r.hits for r in res] == direct
    assert [r.n_dists for r in res] == st["per_query_dists"].tolist()
