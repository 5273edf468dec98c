"""The port's sharded engine on the card: the sharded ``"cuda"`` engine
equals the single-device ``"cuda"`` engine bit for bit.

A tile cell's bits do not depend on the mask, the block count or the
launch, and the planar bound is elementwise per (query, block) (ROADMAP
"Bits independent of the launch"), so splitting the blocks over shards
changes no bit: hits, per-query counts, ``excluded``, kNN ids, distances
and rounds, fp32 and bf16.  Shards share ``cuda:0`` here (1, 2, 3, 4 and
8 of them); the distinct-device case needs two cards and skips below.
The file imports no jax; on the card it runs as

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_sharded.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import flat_index
from repro_torch.core.backends import EngineOpts
from repro_torch.core.npdist import pairwise_np
from repro_torch.index import append, delete
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.parallel import ShardMesh, local_mesh

CUDA = EngineOpts(backend="cuda")
CUDA16 = EngineOpts(backend="cuda", precision="bf16")
BUILD = dict(n_pivots=8, n_pairs=12, block=64)


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
    return torch.device("cuda", 0)


def _case(metric: str, n: int = 3000, nq: int = 70, dim: int = 32):
    """47 blocks of 64: no shard count above 1 here divides them."""
    rng = np.random.default_rng(23)
    x = rng.random((n + nq, dim)).astype(np.float32) + 1e-3
    if metric in ("jsd", "triangular"):
        x /= x.sum(axis=1, keepdims=True)
    return x[:n], x[n:]


def _assert_equal(got, want):
    """Every key of the single-device stats, bit for bit, apart from
    ``engine``."""
    for key, w in want.items():
        if key == "engine":
            continue
        g = got[key]
        if key == "excluded":
            for mech in w:
                np.testing.assert_array_equal(g[mech], w[mech])
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key


def _same_as_single(sharded, single, q, ts, k=10):
    for opts in (CUDA, CUDA16):
        for t in ts:
            hits, st = flat_index.bss_query_batched(sharded, q, t, opts=opts)
            want_hits, want = flat_index.bss_query_batched(single, q, t, opts=opts)
            assert hits == want_hits
            _assert_equal(st, want)
            assert st["engine"] == "sharded" and st["backend"] == "cuda"
            n_piv = int(st["pivot_dists_per_query"])
            assert int(st["shard_dists"].sum()) == int(st["per_query_dists"].sum()) - len(q) * n_piv
        got = flat_index.bss_knn_batched(sharded, q, k, opts=opts)
        exp = flat_index.bss_knn_batched(single, q, k, opts=opts)
        np.testing.assert_array_equal(got[0], exp[0])
        np.testing.assert_array_equal(got[1], exp[1])
        _assert_equal(got[2], exp[2])


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("metric", ["l2", "cosine", "jsd", "triangular"])
def test_sharded_cuda_equals_single_device_cuda(card, metric, n_shards):
    db, q = _case(metric)
    single = flat_index.build_bss(metric, db, **BUILD, device=card)
    sharded = flat_index.build_bss(metric, db, **BUILD, mesh=ShardMesh((card,) * n_shards))
    space = "l2" if metric == "cosine" else metric
    d = pairwise_np(space, flat_index._engine_queries(metric, q), single.data[single.valid])
    ts = [float(np.quantile(d, f)) for f in (0.005, 0.02)]
    reset_launch_counts()
    _same_as_single(sharded, single, q, ts)
    counts = launch_counts()
    entry = {"jsd": "pairwise_jsd", "triangular": "pairwise_tri"}.get(metric, "pairwise_l2")
    for name in (entry, "masked_" + entry, "masked_" + entry + "_bf16",
                 "planar_lower_bound_pairs"):
        assert counts[name] > 0, (name, counts)
    assert sharded._device is None  # the engines read the shards only


@pytest.mark.cuda
def test_in_place_append_reloads_no_kernel_library(card):
    """An append that fits the padding is written into the shards it lands
    on; no tensor changes shape, no library is loaded again, and the next
    generation equals a single-device index put through the same append
    and a delete."""
    db, q = _case("l2")
    extra = _case("l2", n=40, nq=0)[0] + 0.5  # one block: 47 of 48 are full
    mesh = local_mesh(4) if torch.cuda.device_count() == 1 else ShardMesh((card,) * 4)
    sharded = flat_index.build_bss("l2", db, **BUILD, device="cuda", mesh=mesh)
    single = flat_index.build_bss("l2", db, **BUILD, device=card)
    t = float(np.quantile(pairwise_np("l2", q, db), 0.01))
    _same_as_single(sharded, single, q, [t])
    sidx = sharded.sharded()
    shapes = [tuple(getattr(sh, f).shape) for sh in sidx.shards for f in sh._fields]
    loads = {s: _build.load_count(s) for s in _build.SOURCES}
    old = [sh.data.clone() for sh in sidx.shards]
    sharded1, ms = append(sharded, extra)
    single1, _ = append(single, extra)
    assert ms.sharded_in_place
    assert [tuple(getattr(sh, f).shape)
            for sh in sharded1.sharded().shards for f in sh._fields] == shapes
    assert all(torch.equal(a, sh.data) for a, sh in zip(old, sidx.shards))
    _same_as_single(sharded1, single1, q, [t])
    sharded2, _ = delete(sharded1, [0, 7, 3000, 3039])
    single2, _ = delete(single1, [0, 7, 3000, 3039])
    _same_as_single(sharded2, single2, q, [t])
    assert {s: _build.load_count(s) for s in _build.SOURCES} == loads


@pytest.mark.cuda
def test_shards_on_distinct_cards(card):
    """One shard per card: each shard's kernels run on its own device and
    the merge on the first; results equal the single-device engine."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    db, q = _case("jsd")
    mesh = local_mesh()
    assert len(set(mesh.devices)) == torch.cuda.device_count()
    sharded = flat_index.build_bss("jsd", db, **BUILD, mesh=mesh)
    single = flat_index.build_bss("jsd", db, **BUILD, device=card)
    assert [sh.data.device for sh in sharded.sharded().shards] == list(mesh.devices)
    t = float(np.quantile(pairwise_np("jsd", q, db), 0.01))
    _same_as_single(sharded, single, q, [t])
