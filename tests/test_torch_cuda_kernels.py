"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card of compute capability 9.0 and ``nvcc``
(the kernels are built for sm_90a at first use); elsewhere the ``card``
fixture skips it.  The file imports no jax, so on the card it runs as

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the l2 tiles sum in another order than the plain version's
matmul, so rtol = atol = 1e-5 in fp32 (the reference's kernel sweeps,
``tests/test_kernels.py``) with an identical +inf pattern; the JSD and
Triangular tiles sum K terms in another order than ``torch.sum``, and
take the reference sweep's rtol = 1e-4 / atol = 1e-5 unmasked and
1e-5 masked; the planar bound spells every rounding step as an intrinsic
and must be bit-equal, in both its d1/d2 and its pivot-pairs form.  The bf16-y forms are held at the same tolerances against the
plain versions fed the same bf16 ``y``, and must equal the fp32 forms on
the upcast ``y`` bit for bit.  The JSD and Triangular tiles (lg2.approx and
rcp.approx inside) are also held to the float64 function within the error
budget derived in ``csrc/prob_dist.cu``, and must give each (i, j) the same
bits under every launch shape, mask and row shift.  The input shapes and makers are shared with
``tests/test_torch_kernels.py``.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import flat_index
from repro_torch.core.backends import EngineOpts
from repro_torch.core.npdist import pairwise_np
from repro_torch.core.precision import bf16_round_np, prob_error_budget
from repro_torch.index import append, compact, delete
from repro_torch.kernels import _build, launch_counts, ops, ref, reset_launch_counts
from repro_torch.kernels.planar_exclusion import planar_lower_bound_pairs_kernel_call as planar_pairs

TOL = dict(rtol=1e-5, atol=1e-5)
PROB_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_kernels.py:91-124
PROB_METRICS = ("jsd", "triangular")
PROB_PLAIN = {"jsd": ref.pairwise_jsd_ref, "triangular": ref.pairwise_tri_ref}

PAIRWISE_SHAPES = [(128, 128, 16), (200, 310, 48), (1, 7, 3), (130, 128, 112),
                   (64, 500, 20), (256, 256, 128)]
MASKED_CASES = [(256, 384, 32, 128, 128), (100, 200, 64, 128, 128),
                (37, 300, 12, 8, 64), (130, 129, 112, 16, 32)]
PLANAR_SHAPES = [(150, 12, 70), (128, 24, 128), (3, 4, 5), (257, 32, 130)]
# (Q, P, M, B) of the pairs form: ragged Q and B, one plane, more planes
# than one staged chunk of 32
PAIRS_CASES = [(150, 16, 12, 70), (3, 5, 1, 5), (37, 8, 24, 131), (257, 9, 40, 130)]


def normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def assert_same(got: np.ndarray, want: np.ndarray, **tol):
    assert got.shape == want.shape
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = ~np.isinf(want)
    np.testing.assert_allclose(got[fin], want[fin], **tol)


def simplex(rng, n, k):
    """(n, k) float32 probability rows like colour histograms: sparse gamma
    draws with a third of the bins exactly zero and some at 1e-13 and
    1e-9, so the xlogx guard at 1e-12 and the x + y floor are exercised."""
    x = rng.gamma(0.3, size=(n, k))
    x[rng.random((n, k)) < 0.33] = 0.0
    tiny = rng.random((n, k))
    x[tiny < 0.05] = 1e-13
    x[(tiny >= 0.05) & (tiny < 0.1)] = 1e-9
    x[:, 0] += 1e-3  # no all-zero row
    return (x / x.sum(axis=1, keepdims=True)).astype(np.float32)


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


def pairs_inputs(q, p, m, b, seed):
    """(dqp, pairs, deltas, boxes) of the pairs form: a (Q, P) query ->
    pivot matrix and (M, 2) int64 pairs of distinct pivots, the second plane
    repeating the first and the third its reverse; one degenerate plane and
    the last block padded, as ``planar_inputs``."""
    rng = np.random.default_rng(seed)
    dqp = (np.abs(rng.normal(size=(q, p))) + 1.0).astype(np.float32)
    first = rng.integers(0, p, size=m)
    pairs = np.stack([first, (first + rng.integers(1, p, size=m)) % p], 1).astype(np.int64)
    if m >= 3:
        pairs[1] = pairs[0]
        pairs[2] = pairs[0, ::-1]
    _, _, delta, boxes = planar_inputs(1, m, b, seed)
    return dqp, pairs, delta, boxes


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
@pytest.mark.parametrize("metric", PROB_METRICS)
@pytest.mark.parametrize("m,n,k", PAIRWISE_SHAPES + [(512, 16, 112)])
def test_prob_kernel_matches_plain(card, metric, m, n, k):
    rng = np.random.default_rng(m + 2 * n + k)
    x = torch.from_numpy(simplex(rng, m, k)).to(card)
    y = torch.from_numpy(simplex(rng, n, k)).to(card)
    entry = _entry(metric)
    before = launch_counts()[entry]
    got = ops.pairwise_metric(metric, x, y)
    torch.cuda.synchronize()
    assert launch_counts()[entry] == before + 1
    assert_same(got.cpu().numpy(), PROB_PLAIN[metric](x, y).cpu().numpy(), **PROB_TOL)
    if metric == "jsd":
        assert torch.equal(ops.pairwise_jsd(x, y), got)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", PROB_METRICS)
@pytest.mark.parametrize("m,n,k,bm,bn", MASKED_CASES + [(512, 101_504, 112, 128, 128)])
def test_masked_prob_kernel_matches_plain(card, metric, m, n, k, bm, bn):
    rng = np.random.default_rng(m + n + k)
    x = torch.from_numpy(simplex(rng, m, k)).to(card)
    y = torch.from_numpy(simplex(rng, n, k)).to(card)
    tm = rng.random((math.ceil(m / bm), math.ceil(n / bn))) < 0.3
    tm[-1] = False  # an all-dead row of tiles
    tm = torch.from_numpy(tm).to(card)
    got = ops.masked_pairwise_metric(metric, x, y, tm, bm=bm, bn=bn)
    torch.cuda.synchronize()
    want = ref.masked_pairwise_metric_ref(PROB_PLAIN[metric](x, y), tm, bm, bn)
    assert_same(got.cpu().numpy(), want.cpu().numpy(), **TOL)


# the main path's shape; Q and B off the 32 x 64 CTA tile; M over one
# 32-plane chunk, with a ragged last chunk; 768 planes (the most the kernel
# took before it staged planes in chunks) and more
PLANAR_CARD_SHAPES = PLANAR_SHAPES + [(512, 24, 793), (33, 24, 65), (95, 33, 191),
                                      (70, 100, 100), (40, 768, 70), (9, 1000, 65)]


@pytest.mark.cuda
@pytest.mark.parametrize("q,m,b", PLANAR_CARD_SHAPES)
def test_planar_kernel_bit_equal_to_plain(card, q, m, b):
    args = [torch.from_numpy(a).to(card) for a in planar_inputs(q, m, b, seed=b)]
    got = ops.planar_lower_bound(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.planar_lower_bound_ref(*args))
    assert torch.isinf(got[:, -1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("q,p,m,b", PAIRS_CASES + [(512, 16, 24, 793), (40, 16, 768, 70)])
def test_planar_pairs_kernel_bit_equal_to_plain(card, q, p, m, b):
    """The gather form equals its plain version and the d1/d2 form on the
    gathered columns, bit for bit."""
    dqp, pairs, delta, boxes = (torch.from_numpy(a).to(card)
                                for a in pairs_inputs(q, p, m, b, seed=q + m))
    got = planar_pairs(dqp, pairs, delta, boxes)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.planar_lower_bound_pairs_ref(dqp, pairs, delta, boxes))
    d1, d2 = dqp[:, pairs[:, 0]].contiguous(), dqp[:, pairs[:, 1]].contiguous()
    assert torch.equal(got, ops.planar_lower_bound(d1, d2, delta, boxes))
    assert torch.isinf(got[:, -1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "jsd"])
def test_bound_phase_on_card_is_two_launches(card, metric, monkeypatch):
    """On "cuda" the bound phase is the pivot tile and the planar kernel,
    which reads the pivot pairs itself: no gather runs between them."""
    db, q = _engine_case(metric)
    index = flat_index.build_bss(metric, db, n_pivots=8, n_pairs=12, block=64, device=card)
    dev = index.device
    qd = torch.as_tensor(q, device=card)
    gathers = []

    def counted(real):
        def gather(*args, **kw):
            gathers.append(args)
            return real(*args, **kw)
        return gather

    monkeypatch.setattr(torch, "index_select", counted(torch.index_select))
    monkeypatch.setattr(torch.Tensor, "index_select", counted(torch.Tensor.index_select))
    reset_launch_counts()
    lb = flat_index._fused_lower_bounds(metric, qd, dev.pivots, dev.pairs, dev.deltas,
                                        dev.boxes, backend="cuda")
    counts = launch_counts()
    monkeypatch.undo()
    assert counts[_entry(metric)] == counts["planar_lower_bound_pairs"] == 1
    assert sum(counts.values()) == 2 and not gathers
    dqp = ops.pairwise_metric(metric, qd, dev.pivots)
    assert torch.equal(lb, ref.planar_lower_bound_pairs_ref(dqp, dev.pairs, dev.deltas, dev.boxes))


def _entry(metric):
    """The unmasked C entry point (and launch count) of ``metric``'s tile."""
    return {"jsd": "pairwise_jsd", "triangular": "pairwise_tri"}.get(metric, "pairwise_l2")


def _engine_case(metric, n=3000, nq=70, dim=24):
    rng = np.random.default_rng(3)
    if metric in PROB_METRICS:
        return simplex(rng, n, dim), simplex(rng, nq, dim)
    return rng.random((n, dim)).astype(np.float32), rng.random((nq, dim)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cosine", "jsd", "triangular"])
def test_engine_cuda_backend_matches_torch_backend(card, metric):
    """The range search through the kernels returns the plain backend's
    hit lists and stats on a small index, at a threshold no distance lies
    near (so fp32 rounding cannot move a hit)."""
    db, q = _engine_case(metric)
    index = flat_index.build_bss(metric, db, n_pivots=8, n_pairs=12, block=64, device=card)
    t = safe_threshold(pairwise_np(metric, q, db), 0.01)
    reset_launch_counts()
    got, g_stats = flat_index.bss_query_batched(index, q, t, opts=EngineOpts(backend="cuda"))
    counts, entry = launch_counts(), _entry(metric)
    assert counts[entry] == counts["masked_" + entry] == counts["planar_lower_bound_pairs"] == 1
    assert sum(counts.values()) == 3
    want, w_stats = flat_index.bss_query_batched(index, q, t, opts=EngineOpts(backend="torch"))
    assert got == want == flat_index.bss_query(index, q, t)[0]
    assert sum(map(len, got)) > 0
    np.testing.assert_array_equal(g_stats["per_query_dists"], w_stats["per_query_dists"])
    assert g_stats["backend"] == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cosine", "jsd", "triangular"])
def test_knn_cuda_backend_matches_torch_backend(card, metric):
    """kNN through the kernels returns the plain backend's ids, rounds and
    counts (its dense rounds: the scheme the kernels run), and the float64
    brute force's neighbour sets."""
    db, q = _engine_case(metric)
    index = flat_index.build_bss(metric, db, n_pivots=8, n_pairs=12, block=64, device=card)
    reset_launch_counts()
    got, g_d, g_stats = flat_index.bss_knn_batched(index, q, 10, opts=EngineOpts(backend="cuda"))
    counts, entry = launch_counts(), _entry(metric)
    assert counts[entry] == counts["planar_lower_bound_pairs"] == 1
    assert counts["masked_" + entry] == g_stats["rounds"]
    want, w_d, w_stats = flat_index.bss_knn_batched(
        index, q, 10, opts=EngineOpts(backend="torch", realisation="dense"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(g_d, w_d, rtol=1e-5, atol=1e-5)
    assert g_stats["rounds"] == w_stats["rounds"]
    np.testing.assert_array_equal(g_stats["per_query_dists"], w_stats["per_query_dists"])
    truth = pairwise_np(metric, q, db)
    for i in range(len(q)):
        assert set(got[i]) == set(np.argsort(truth[i], kind="stable")[:10]), i


# ------------------------------------------------------- bf16 corpus forms


def _bf16_entry(metric, masked):
    return ("masked_" if masked else "") + _entry(metric) + "_bf16"


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "jsd", "triangular"])
@pytest.mark.parametrize("m,n,k", PAIRWISE_SHAPES + [(512, 16, 112)])
def test_bf16_kernel_matches_plain(card, metric, m, n, k):
    """The unmasked bf16-y forms against their plain versions fed the same
    bf16 y (the plain versions upcast it on entry)."""
    rng = np.random.default_rng(m + 3 * n + k)
    maker = normal if metric == "l2" else simplex
    x = torch.from_numpy(maker(rng, m, k)).to(card)
    y = torch.from_numpy(maker(rng, n, k)).to(card).bfloat16()
    entry = _bf16_entry(metric, False)
    before = launch_counts()[entry]
    got = ops.pairwise_metric(metric, x, y)
    torch.cuda.synchronize()
    assert launch_counts()[entry] == before + 1
    plain = ref.pairwise_l2_ref if metric == "l2" else PROB_PLAIN[metric]
    assert_same(got.cpu().numpy(), plain(x, y).cpu().numpy(),
                **(TOL if metric == "l2" else PROB_TOL))
    # the bf16 form reads the same values as the fp32 form of the upcast y
    assert torch.equal(got, ops.pairwise_metric(metric, x, y.float()))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "jsd", "triangular"])
@pytest.mark.parametrize("m,n,k,bm,bn", MASKED_CASES + [(512, 101_504, 112, 128, 128)])
def test_masked_bf16_kernel_matches_plain(card, metric, m, n, k, bm, bn):
    rng = np.random.default_rng(2 * m + n + k)
    maker = normal if metric == "l2" else simplex
    x = torch.from_numpy(maker(rng, m, k)).to(card)
    y = torch.from_numpy(maker(rng, n, k)).to(card).bfloat16()
    tm = rng.random((math.ceil(m / bm), math.ceil(n / bn))) < 0.3
    tm[-1] = False  # an all-dead row of tiles
    tm = torch.from_numpy(tm).to(card)
    entry = _bf16_entry(metric, True)
    before = launch_counts()[entry]
    got = ops.masked_pairwise_metric(metric, x, y, tm, bm=bm, bn=bn)
    torch.cuda.synchronize()
    assert launch_counts()[entry] == before + 1
    dense = ref.pairwise_l2_ref if metric == "l2" else PROB_PLAIN[metric]
    want = ref.masked_pairwise_metric_ref(dense(x, y), tm, bm, bn)
    assert_same(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert torch.equal(got, ops.masked_pairwise_metric(metric, x, y.float(), tm, bm=bm, bn=bn))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cosine", "jsd", "triangular"])
def test_engine_bf16_equals_fp32_on_card(card, metric):
    """bf16 range and kNN through the kernels equal the fp32 path of the
    same backend bit for bit, and run the bf16 masked form."""
    db, q = _engine_case(metric)
    index = flat_index.build_bss(metric, db, n_pivots=8, n_pairs=12, block=64, device=card)
    t = safe_threshold(pairwise_np(metric, q, db), 0.01)
    fp32, bf16 = EngineOpts(backend="cuda"), EngineOpts(backend="cuda", precision="bf16")
    reset_launch_counts()
    h16, s16 = flat_index.bss_query_batched(index, q, t, opts=bf16)
    counts, entry = launch_counts(), _entry(metric)
    assert counts["masked_" + entry + "_bf16"] == counts["masked_" + entry] == 1
    h32, s32 = flat_index.bss_query_batched(index, q, t, opts=fp32)
    assert h16 == h32 and sum(map(len, h16)) > 0
    np.testing.assert_array_equal(s16["per_query_dists"], s32["per_query_dists"])
    i16, d16, k16 = flat_index.bss_knn_batched(index, q, 10, opts=bf16)
    i32, d32, k32 = flat_index.bss_knn_batched(index, q, 10, opts=fp32)
    np.testing.assert_array_equal(i16, i32)
    np.testing.assert_array_equal(d16, d32)
    assert k16["rounds"] == k32["rounds"]
    np.testing.assert_array_equal(k16["per_query_dists"], k32["per_query_dists"])
    assert torch.equal(index.device_bf16.float().cpu(),
                       torch.from_numpy(bf16_round_np(index.data)))


@pytest.mark.cuda
def test_living_corpus_on_card(card):
    """append / delete / compact with live device mirrors: fp32 and bf16
    agree at every generation, and compact equals a fresh build."""
    db, q = _engine_case("jsd")
    index = flat_index.build_bss("jsd", db[:2700], n_pivots=8, n_pairs=12, block=64,
                                 device=card)
    t = safe_threshold(pairwise_np("jsd", q, db), 0.01)
    bf16 = EngineOpts(backend="cuda", precision="bf16")
    gens = [index]
    flat_index.bss_query_batched(index, q, t, opts=bf16)  # builds both mirrors
    gens.append(append(gens[-1], db[2700:])[0])
    gens.append(delete(gens[-1], list(range(0, 3000, 97)))[0])
    for g in gens:
        want = flat_index.bss_query(g, q, t)[0]
        assert flat_index.bss_query_batched(g, q, t, opts=bf16)[0] == want
        assert flat_index.bss_query_batched(g, q, t, opts=EngineOpts(backend="cuda"))[0] == want
    assert torch.equal(gens[1].device_bf16.float().cpu(),
                       torch.from_numpy(bf16_round_np(gens[1].data)))
    compacted, _ = compact(gens[-1])
    live = np.nonzero(gens[-1].valid)[0]
    ids = np.sort(gens[-1].perm[live])
    fresh = flat_index.build_bss("jsd", db[ids], n_pivots=8, n_pairs=12, block=64, device=card)
    np.testing.assert_array_equal(compacted.data, fresh.data)
    np.testing.assert_array_equal(compacted.boxes, fresh.boxes)
    got = flat_index.bss_query_batched(compacted, q, t, opts=bf16)[0]
    assert got == [[int(ids[h]) for h in row]
                   for row in flat_index.bss_query_batched(fresh, q, t)[0]]


# ------------------------------- JSD / Triangular: bits, edges, error budget

PROB_KS = [1, 3, 15, 16, 112, 130]
PROB_NS = [1, 16, 129]


# Below this float64 distance the fixed tolerances against float64 are not
# held: no fp32 form holds them there.  A JSD term's rounding error, about
# eps_f32 |x log2 x| however close x is to y, is carried to d through
# dS / 2d, so the plain fp32 version (accurate logarithm) misses 1e-5 there
# as the kernel (lg2.approx) does (chip_smoke.py --prob-only prints both).
# Both stay inside the derived budget, which is what is held there, and
# the kernel is held to the plain version within the two budgets.  Every
# threshold and kth of SISAP colors lies above 0.2.
TOL_FROM_D = 0.05


def prob_plain(metric, x, y):
    """The plain fp32 version on the CPU."""
    fn = ref.pairwise_jsd_ref if metric == "jsd" else ref.pairwise_tri_ref
    return fn(torch.from_numpy(x), torch.from_numpy(y)).numpy()


def budget_of(metric, k, *ds):
    """(lg2 / rcp part, fp32 part) at whichever of the distances ``ds``
    gives the larger budget (JSD's falls with d, Triangular's rises)."""
    parts = [prob_error_budget(metric, k, d) for d in ds]
    return np.maximum.reduce([a for a, _ in parts]), np.maximum.reduce([f for _, f in parts])


def assert_against_float64(metric, k, got, x, y, **tol):
    """got (finite where live) against the float64 function of the same
    float32 inputs: inside the derived budget everywhere, and inside
    ``tol`` (if given) from ``TOL_FROM_D`` up; below it, against the plain
    fp32 version within the kernel's budget plus the plain version's (its
    fp32 part)."""
    want = pairwise_np(metric, x, y)
    fin = np.isfinite(got)
    g = got[fin].astype(np.float64)
    d, err = want[fin], np.abs(g - want[fin])
    approx, fp32 = budget_of(metric, k, np.minimum(d, g))
    assert (err <= approx + fp32).all(), (float(err.max()), float((err - approx - fp32).max()))
    near = d < TOL_FROM_D
    if near.any():
        p = prob_plain(metric, x, y)[fin][near].astype(np.float64)
        approx, fp32 = budget_of(metric, k, d[near], g[near], p)
        gap = np.abs(g[near] - p)
        assert (gap <= approx + 2 * fp32).all(), float((gap - approx - 2 * fp32).max())
    if tol:
        far = ~near
        assert (err[far] <= tol["atol"] + tol["rtol"] * d[far]).all(), float(err[far].max())


@pytest.mark.cuda
@pytest.mark.parametrize("k", PROB_KS)
@pytest.mark.parametrize("metric", PROB_METRICS)
def test_prob_kernel_bits_do_not_depend_on_tiling(card, metric, k):
    """Each (i, j) is summed in one order whatever the launch: two launches,
    the wide (128 x 128) and narrow (16 x 16) block shapes, a shift by one
    row, two masks of two cell shapes, and the bf16-y form against the fp32
    form on the widened y all give the same bits for the same (i, j)."""
    rng = np.random.default_rng(100 + k)
    m, n = 200, 133 * 128 + 37  # the wide shape, ragged both ways
    x = torch.from_numpy(simplex(rng, m, k)).to(card)
    y32 = torch.from_numpy(simplex(rng, n, k)).to(card)
    for y in (y32, y32.bfloat16()):
        full = ops.pairwise_metric(metric, x, y)
        assert torch.equal(full, ops.pairwise_metric(metric, x, y))
        assert torch.equal(full, ops.pairwise_metric(metric, x, y.float()))
        assert torch.equal(ops.pairwise_metric(metric, x[37:45], y[1000:1013]),
                           full[37:45, 1000:1013])
        assert torch.equal(ops.pairwise_metric(metric, x[1:], y), full[1:])
        for bm, bn, live in ((128, 128, 0.5), (16, 32, 0.3)):
            tm = torch.from_numpy(rng.random((math.ceil(m / bm), math.ceil(n / bn))) < live)
            tm = tm.to(card)
            got = ops.masked_pairwise_metric(metric, x, y, tm, bm=bm, bn=bn)
            assert torch.equal(got, ref.masked_pairwise_metric_ref(full, tm, bm, bn))
        assert_against_float64(metric, k, full[:, :1000].cpu().numpy(), x.cpu().numpy(),
                               y[:1000].float().cpu().numpy(), **PROB_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n", PROB_NS)
@pytest.mark.parametrize("k", PROB_KS)
@pytest.mark.parametrize("metric", PROB_METRICS)
def test_prob_kernel_against_float64(card, metric, k, n):
    """Masked and unmasked, fp32 and bf16 y, against the float64 function
    of the same inputs: inside the derived budget, and the tolerances
    (1e-4 / 1e-5 unmasked, 1e-5 masked) from ``TOL_FROM_D`` up."""
    rng = np.random.default_rng(7 * k + n)
    m = 70
    x_np = simplex(rng, m, k)
    y_np = simplex(rng, n, k)
    x = torch.from_numpy(x_np).to(card)
    tm = torch.from_numpy(rng.random((math.ceil(m / 16), math.ceil(n / 8))) < 0.6).to(card)
    for y in (torch.from_numpy(y_np).to(card), torch.from_numpy(y_np).to(card).bfloat16()):
        y_vals = y.float().cpu().numpy()  # the values the kernel reads
        got = ops.pairwise_metric(metric, x, y).cpu().numpy()
        assert np.isfinite(got).all()
        assert_against_float64(metric, k, got, x_np, y_vals, **PROB_TOL)
        got_m = ops.masked_pairwise_metric(metric, x, y, tm, bm=16, bn=8).cpu().numpy()
        dense = torch.from_numpy(np.zeros((m, n), np.float32))
        assert np.array_equal(np.isinf(got_m),
                              np.isinf(ref.masked_pairwise_metric_ref(dense, tm.cpu(), 16, 8)))
        assert_against_float64(metric, k, got_m, x_np, y_vals, **TOL)


def edge_rows(k):
    """Probability rows at the edges of the guards: one-hot rows, a row of
    zeros, 1e-13 and 1e-9 bins, a uniform row, and a sparse row; every value
    exactly representable in bfloat16 so identical rows stay identical
    under the bf16 mirror."""
    rows = [np.eye(k)[0], np.eye(k)[k - 1], np.full(k, 1.0 / k)]
    tiny = np.zeros(k)
    tiny[::3] = 1e-13
    tiny[1::3] = 1e-9
    tiny[0] = 1.0
    rows.append(tiny)
    sparse = np.zeros(k)
    sparse[: max(1, k // 4)] = 1.0
    rows.append(sparse / sparse.sum())
    return bf16_round_np(np.stack(rows).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [3, 16, 112])
@pytest.mark.parametrize("metric", PROB_METRICS)
def test_prob_kernel_edge_bins(card, metric, k, masked):
    """Zeros, 1e-13 and 1e-9 bins, one-hot and identical rows, fp32 and bf16
    y: identical rows give exactly 0, everything else the float64 function
    within the budget and the tolerances."""
    x_np = edge_rows(k)
    y_np = np.concatenate([x_np, edge_rows(k)[::-1], simplex(np.random.default_rng(k), 4, k)])
    y_np = bf16_round_np(y_np)
    x = torch.from_numpy(x_np).to(card)
    for y in (torch.from_numpy(y_np).to(card), torch.from_numpy(y_np).to(card).bfloat16()):
        if masked:
            tm = torch.ones((1, 2), dtype=torch.bool, device=card)
            got = ops.masked_pairwise_metric(metric, x, y, tm, bm=8, bn=8).cpu().numpy()
        else:
            got = ops.pairwise_metric(metric, x, y).cpu().numpy()
        assert np.isfinite(got).all()
        assert (np.diagonal(got) == 0.0).all(), np.diagonal(got)
        assert_against_float64(metric, k, got, x_np, y_np, **(TOL if masked else PROB_TOL))


# ------------------------------------------- l2: bits; JSD: near duplicates


@pytest.mark.cuda
@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("k", [3, 16, 112, 130])
def test_l2_kernel_bits_do_not_depend_on_tiling(card, k, squared):
    """Each (i, j) is accumulated in one order whatever the launch: two
    launches, the wide (128 x 128) and narrow (16 x 16) block shapes, a
    shift by one row, masks of three cell shapes (the 128 x 128 engine cell
    skips the per-element mask test), and the bf16-y form against the fp32
    form on the widened y all give the same bits for the same (i, j)."""
    rng = np.random.default_rng(200 + k)
    m, n = 200, 133 * 128 + 37  # the wide shape, ragged both ways
    x = torch.from_numpy(normal(rng, m, k)).to(card)
    y32 = torch.from_numpy(normal(rng, n, k)).to(card)
    for y in (y32, y32.bfloat16()):
        full = ops.pairwise_l2(x, y, squared=squared)
        assert torch.equal(full, ops.pairwise_l2(x, y, squared=squared))
        assert torch.equal(full, ops.pairwise_l2(x, y.float(), squared=squared))
        assert torch.equal(ops.pairwise_l2(x[37:45], y[1000:1013], squared=squared),
                           full[37:45, 1000:1013])
        assert torch.equal(ops.pairwise_l2(x[1:], y, squared=squared), full[1:])
        for bm, bn, live in ((128, 128, 0.5), (16, 32, 0.3), (8, 256, 0.4)):
            tm = torch.from_numpy(rng.random((math.ceil(m / bm), math.ceil(n / bn))) < live)
            tm = tm.to(card)
            got = ops.masked_pairwise_l2(x, y, tm, bm=bm, bn=bn, squared=squared)
            assert torch.equal(got, ref.masked_pairwise_metric_ref(full, tm, bm, bn))
        assert_same(full.cpu().numpy(), ref.pairwise_l2_ref(x, y, squared).cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 16, 112])
def test_jsd_near_duplicates_as_accurate_as_plain(card, k):
    """Below d = 0.05 the JSD tile recomputes with the accurate logarithm:
    against float64 it has no more cells over the fixed tolerance 1e-5 +
    1e-4 d than the plain fp32 version on the card, and its largest error
    is at most 1.1 times the plain version's; the masked and bf16-y forms
    give the same bits."""
    rng = np.random.default_rng(7 * k + 129)
    x_np = simplex(rng, 70, k)
    near = np.abs(x_np * (1 + 1e-3 * rng.normal(size=x_np.shape))).astype(np.float32)
    y_np = np.concatenate([simplex(rng, 129, k),
                           (near / near.sum(axis=1, keepdims=True)).astype(np.float32)])
    x, y = torch.from_numpy(x_np).to(card), torch.from_numpy(y_np).to(card)
    got = ops.pairwise_metric("jsd", x, y)
    plain = ref.pairwise_jsd_ref(x, y).double().cpu().numpy()
    want = pairwise_np("jsd", x_np, y_np)
    sel = want < 0.05
    assert sel.sum() >= 70
    tol = 1e-5 + 1e-4 * want[sel]
    err = np.abs(got.double().cpu().numpy()[sel] - want[sel])
    err_plain = np.abs(plain[sel] - want[sel])
    assert (err > tol).sum() <= (err_plain > tol).sum()
    assert err.max() <= 1.1 * err_plain.max(), (err.max(), err_plain.max())
    approx, fp32 = prob_error_budget("jsd", k, np.minimum(want[sel], got.cpu().numpy()[sel]))
    assert (approx == 0).all() and (err <= fp32).all()
    tm = torch.ones((math.ceil(70 / 16), math.ceil(y_np.shape[0] / 8)), dtype=torch.bool,
                    device=card)
    assert torch.equal(ops.masked_pairwise_metric("jsd", x, y, tm, bm=16, bn=8), got)
    y16 = y.bfloat16()
    assert torch.equal(ops.pairwise_metric("jsd", x, y16),
                       ops.pairwise_metric("jsd", x, y16.float()))


# ------------------------------------------------------------- kNN top-k


@pytest.mark.cuda
def test_round_top_k_on_card_equals_stable_sort(card):
    """The total-order top-k of a kNN round at the main path's shape (512 x
    101,504, k = 10) on the card: exact ties, +inf cells and signed zeros
    come back as a stable sort's first k, except that -0.0 ranks ahead of
    +0.0 (as ``jax.lax.top_k`` ranks them), and as on the CPU."""
    rng = np.random.default_rng(11)
    d = rng.integers(1, 50, size=(512, 101_504)).astype(np.float32) / 8
    d[rng.random(d.shape) < 0.3] = np.inf
    d[:, 7] = -0.0  # the only zeros: the stable sort gives 3, 7
    d[:, 3] = 0.0
    d[-1] = np.inf
    dist = torch.from_numpy(d).to(card)
    idx, val = flat_index._top_k_smallest(dist, 10)
    s_val, s_idx = torch.sort(dist, dim=1, stable=True)
    want_idx = s_idx[:, :10].clone()
    want_idx[:-1, :2] = torch.tensor([7, 3], device=card)  # -0.0 first, then +0.0
    assert torch.equal(idx, want_idx)
    assert torch.equal(val.abs(), s_val[:, :10].abs())
    assert torch.signbit(val[:-1, 0]).all() and not torch.signbit(val[:-1, 1]).any()
    cpu_idx, cpu_val = flat_index._top_k_smallest(dist.cpu(), 10)
    assert torch.equal(idx.cpu(), cpu_idx) and torch.equal(val.cpu(), cpu_val)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("metric", ["l2", "jsd"])
def test_knn_ids_on_card_equal_torch_backend(card, metric, precision):
    """kNN ids through the kernels equal the plain backend's, under its
    dense and its adaptive realisation, in both precisions."""
    db, q = _engine_case(metric)
    index = flat_index.build_bss(metric, db, n_pivots=8, n_pairs=12, block=64, device=card)
    got, g_d, _ = flat_index.bss_knn_batched(
        index, q, 10, opts=EngineOpts(backend="cuda", precision=precision))
    for realisation in ("dense", "adaptive"):
        want, w_d, _ = flat_index.bss_knn_batched(
            index, q, 10, opts=EngineOpts(backend="torch", precision=precision,
                                          realisation=realisation))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(g_d, w_d, rtol=1e-5, atol=1e-5)
