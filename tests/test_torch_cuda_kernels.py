"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card of compute capability 9.0 and ``nvcc``
(the kernels are built for sm_90a at first use); elsewhere the ``card``
fixture skips it.  The file imports no jax, so on the card it runs as

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the l2 tiles sum in another order than the plain version's
matmul, so rtol = atol = 1e-5 in fp32 (the reference's kernel sweeps,
``tests/test_kernels.py``) with an identical +inf pattern; the planar
bound is built without FMA contraction and must be bit-equal.  The input
shapes and makers are shared with ``tests/test_torch_kernels.py``.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import flat_index
from repro_torch.core.backends import EngineOpts
from repro_torch.core.npdist import pairwise_np
from repro_torch.kernels import _build, launch_counts, ops, ref, reset_launch_counts

TOL = dict(rtol=1e-5, atol=1e-5)

PAIRWISE_SHAPES = [(128, 128, 16), (200, 310, 48), (1, 7, 3), (130, 128, 112),
                   (64, 500, 20), (256, 256, 128)]
MASKED_CASES = [(256, 384, 32, 128, 128), (100, 200, 64, 128, 128),
                (37, 300, 12, 8, 64), (130, 129, 112, 16, 32)]
PLANAR_SHAPES = [(150, 12, 70), (128, 24, 128), (3, 4, 5), (257, 32, 130)]


def normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def assert_same(got: np.ndarray, want: np.ndarray, **tol):
    assert got.shape == want.shape
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = ~np.isinf(want)
    np.testing.assert_allclose(got[fin], want[fin], **tol)


def planar_inputs(q, m, b, seed):
    """(d1, d2, deltas, boxes) with one degenerate plane and the last block
    padded with the 3e38 sentinel boxes."""
    rng = np.random.default_rng(seed)
    d1 = (np.abs(rng.normal(size=(q, m))) + 1.0).astype(np.float32)
    delta = (np.abs(rng.normal(size=(m,))) + 0.5).astype(np.float32)
    delta[m // 2] = 0.0  # degenerate plane
    d2 = np.abs(d1 + rng.normal(size=(q, m)) * 0.2).astype(np.float32)
    lo = rng.normal(size=(b, m, 2))
    hi = lo + np.abs(rng.normal(size=(b, m, 2)))
    boxes = np.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]], -1)
    boxes = boxes.astype(np.float32)
    boxes[-1] = [3.0e38, 3.1e38, 3.0e38, 3.1e38]  # padded block sentinels
    return d1, d2, delta, boxes


def safe_threshold(dvals: np.ndarray, frac: float) -> float:
    """A threshold at ~the given quantile, snapped to the midpoint of a
    well-separated gap so float32 and float64 agree on every d <= t
    (as tests/test_bss_engine.py defines it)."""
    vals = np.unique(np.sort(np.asarray(dvals, np.float64).ravel()))
    i = int(np.clip(frac * len(vals), 0, len(vals) - 2))
    for j in range(i, len(vals) - 1):
        if vals[j + 1] - vals[j] > 1e-4 * max(1.0, vals[j]):
            return float(0.5 * (vals[j] + vals[j + 1]))
    return float(vals[-1] + 1.0)


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


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", PAIRWISE_SHAPES + [(512, 16, 112)])
@pytest.mark.parametrize("squared", [False, True])
def test_pairwise_l2_kernel_matches_plain(card, m, n, k, squared):
    rng = np.random.default_rng(m + n + k)
    x = torch.from_numpy(normal(rng, m, k)).to(card)
    y = torch.from_numpy(normal(rng, n, k)).to(card)
    before = launch_counts()["pairwise_l2"]
    got = ops.pairwise_l2(x, y, squared=squared)
    torch.cuda.synchronize()
    assert launch_counts()["pairwise_l2"] == before + 1
    assert_same(got.cpu().numpy(), ref.pairwise_l2_ref(x, y, squared).cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,bm,bn", MASKED_CASES + [(512, 101_504, 112, 128, 128)])
def test_masked_pairwise_kernel_matches_plain(card, m, n, k, bm, bn):
    rng = np.random.default_rng(m + n)
    x = torch.from_numpy(normal(rng, m, k)).to(card)
    y = torch.from_numpy(normal(rng, n, k)).to(card)
    tm = rng.random((math.ceil(m / bm), math.ceil(n / bn))) < 0.3
    tm[-1] = False  # an all-dead row of tiles
    tm = torch.from_numpy(tm).to(card)
    got = ops.masked_pairwise_l2(x, y, tm, bm=bm, bn=bn)
    torch.cuda.synchronize()
    assert_same(got.cpu().numpy(), ref.masked_pairwise_l2_ref(x, y, tm, bm, bn).cpu().numpy(),
                **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("q,m,b", PLANAR_SHAPES + [(512, 24, 793)])
def test_planar_kernel_bit_equal_to_plain(card, q, m, b):
    args = [torch.from_numpy(a).to(card) for a in planar_inputs(q, m, b, seed=b)]
    got = ops.planar_lower_bound(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.planar_lower_bound_ref(*args))
    assert torch.isinf(got[:, -1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_engine_cuda_backend_matches_torch_backend(card, metric):
    """The range search through the three kernels returns the plain
    backend's hit lists and stats on a small index, at a threshold no
    distance lies near (so fp32 rounding cannot move a hit)."""
    rng = np.random.default_rng(3)
    db = rng.random((3000, 24)).astype(np.float32)
    q = rng.random((70, 24)).astype(np.float32)
    index = flat_index.build_bss(metric, db, n_pivots=8, n_pairs=12, block=64, device=card)
    t = safe_threshold(pairwise_np(metric, q, db), 0.01)
    reset_launch_counts()
    got, g_stats = flat_index.bss_query_batched(index, q, t, opts=EngineOpts(backend="cuda"))
    assert min(launch_counts().values()) == 1
    want, w_stats = flat_index.bss_query_batched(index, q, t, opts=EngineOpts(backend="torch"))
    assert got == want == flat_index.bss_query(index, q, t)[0]
    assert sum(map(len, got)) > 0
    np.testing.assert_array_equal(g_stats["per_query_dists"], w_stats["per_query_dists"])
    assert g_stats["backend"] == "cuda"
