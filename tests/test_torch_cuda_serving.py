"""The port's serving front on the card: results through the front equal
direct ``"cuda"`` engine calls bit for bit.

The kernels give each (query, corpus row) distance the same bits in any
launch (ROADMAP "Bits independent of the launch"), so a front result
equals a direct call on a batch of any composition holding the same row
in hits, kNN ids and distances, and range counts; on the batch the front
formed, every field is equal.  Padding rows (radius -1) must be charged
exactly the pivot distances, as on the plain backend.  The file imports
no jax; on the card it runs as

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_serving.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import flat_index
from repro_torch.core.backends import EngineOpts
from repro_torch.core.npdist import pairwise_np
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.serve.front import ServingFront
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(metric: str, n: int = 3000, nq: int = 70, dim: int = 32):
    rng = np.random.default_rng(21)
    x = rng.random((n + nq, dim)).astype(np.float32) + 1e-3
    if metric in ("jsd", "triangular"):
        x /= x.sum(axis=1, keepdims=True)
    return x[:n], x[n:]


def _snap(dvals: np.ndarray, frac: float) -> float:
    vals = np.unique(np.sort(np.asarray(dvals, np.float64).ravel()))
    i = int(np.clip(frac * len(vals), 0, len(vals) - 2))
    for j in range(i, len(vals) - 1):
        if vals[j + 1] - vals[j] > 1e-4 * max(1.0, vals[j]):
            return float(0.5 * (vals[j] + vals[j + 1]))
    return float(vals[-1] + 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "jsd"])
def test_front_on_card_equals_direct_cuda_calls(card, metric):
    """An interleaved range (three thresholds, fp32 and bf16) and kNN stream
    through the front on the card: each batch the front dispatched equals a
    direct ``"cuda"`` call on the same rows, every field; and one direct
    call over all rows of a kind gives the same hits, kNN ids and
    distances, and range counts.  (A kNN row's count and a bf16 row's
    re-check count follow the cells its query tile computed, so they are
    compared on the front's own batches.)  The front launched the
    kernels."""
    db, q = _case(metric)
    index = flat_index.build_bss(metric, db, n_pivots=8, n_pairs=12, block=64, device=card)
    d = pairwise_np(metric, q, db)
    ts = [_snap(d, f) for f in (0.005, 0.01, 0.02)]
    reqs = [("knn", None) if i % 4 == 1 else ("range", ts[i % 3]) for i in range(len(q))]
    precision = ["bf16" if i % 5 == 0 else "fp32" for i in range(len(q))]
    reset_launch_counts()
    with ServingFront(index, buckets=(8, 32), max_delay_s=0.01, start=False) as front:
        futs = [front.submit(q[i], "knn", k=5, precision=precision[i]) if kind == "knn"
                else front.submit(q[i], "range", t=t, precision=precision[i])
                for i, (kind, t) in enumerate(reqs)]
        front.start()
        res = [f.result(timeout=300) for f in futs]
        stats = front.stats()
    counts = launch_counts()
    assert stats["errors"] == 0
    entry = {"l2": "pairwise_l2", "jsd": "pairwise_jsd"}[metric]
    for name in (entry, "masked_" + entry, "masked_" + entry + "_bf16",
                 "planar_lower_bound_pairs"):
        assert counts[name] > 0, (name, counts)

    def direct(kind, prec, rows, pad=0):
        opts = EngineOpts(backend="cuda", realisation="dense", precision=prec)
        qs = q[rows + rows[:1] * pad]
        if kind == "range":
            t_vec = np.array([reqs[i][1] for i in rows] + [-1.0] * pad, np.float32)
            hits, s = flat_index.bss_query_batched(index, qs, t_vec, opts=opts)
            return hits, None, None, s
        return (None, *flat_index.bss_knn_batched(index, qs, 5, opts=opts))

    batches: dict = {}
    for i, r in enumerate(res):
        key = (reqs[i][0], precision[i], r.batch_size, r.padded_to, r.engine_s)
        batches.setdefault(key, []).append(i)
    for (kind, prec, n, bucket, _), rows in batches.items():
        rows = sorted(rows, key=lambda i: res[i].trace_id)  # the queue order
        assert len(rows) == n
        hits, ids, dists, s = direct(kind, prec, rows, bucket - n)
        for j, i in enumerate(rows):
            assert res[i].n_dists == s["per_query_dists"][j], (kind, prec, i)
            if prec == "bf16":
                assert res[i].n_recheck == s["per_query_recheck"][j], i
            if kind == "range":
                assert res[i].hits == hits[j], (prec, i)
            else:
                np.testing.assert_array_equal(res[i].indices, ids[j])
                np.testing.assert_array_equal(res[i].distances, dists[j])

    for kind in ("range", "knn"):
        for prec in ("fp32", "bf16"):
            rows = [i for i in range(len(q)) if reqs[i][0] == kind and precision[i] == prec]
            hits, ids, dists, s = direct(kind, prec, rows)
            for j, i in enumerate(rows):
                if kind == "range":
                    assert res[i].hits == hits[j], (prec, i)
                    assert res[i].n_dists == s["per_query_dists"][j], (prec, i)
                else:
                    np.testing.assert_array_equal(res[i].indices, ids[j])
                    np.testing.assert_array_equal(res[i].distances, dists[j])


@pytest.mark.cuda
def test_padding_rows_on_card_charged_only_the_pivots(card):
    """Rows at radius -1 survive no block on the card, are charged exactly
    ``n_pivots`` distances, and leave the real rows as the unpadded call."""
    db, q = _case("l2")
    index = flat_index.build_bss("l2", db, n_pivots=8, n_pairs=12, block=64, device=card)
    t = _snap(pairwise_np("l2", q, db), 0.01)
    t_vec = np.full(32, t, np.float32)
    t_vec[5:] = -1.0
    qpad = np.concatenate([q[:5], np.repeat(q[:1], 27, axis=0)])
    hits, s = flat_index.bss_query_batched(index, qpad, t_vec, opts=CUDA)
    assert (s["per_query_dists"][5:] == index.pivots.shape[0]).all()
    assert all(h == [] for h in hits[5:])
    want, ws = flat_index.bss_query_batched(index, qpad, t_vec,
                                            opts=EngineOpts(backend="torch", realisation="dense"))
    assert hits == want
    np.testing.assert_array_equal(s["per_query_dists"], ws["per_query_dists"])
    ref, rs = flat_index.bss_query_batched(index, q[:5], t, opts=CUDA)
    assert hits[:5] == ref
    np.testing.assert_array_equal(s["per_query_dists"][:5], rs["per_query_dists"])

    with ServingFront(index, buckets=(32,), max_delay_s=0.01, start=False) as front:
        futs = [front.submit(v, "range", t=t) for v in q[:5]]
        front.start()
        res = [f.result(timeout=300) for f in futs]
        c = front.metrics().snapshot()["counters"]
    assert [r.hits for r in res] == ref
    assert c["engine/dists{engine=bss,kind=range}"] == float(rs["per_query_dists"].sum())
    assert c["serve/padded_rows"] == 27.0


@pytest.mark.cuda
def test_server_on_card_builds_for_the_card(card):
    """``RetrievalServer(device=None)`` builds on the CUDA device and its
    ``search`` runs the kernels."""
    db, q = _case("l2", n=2000, nq=16)
    server = RetrievalServer(db, metric="l2", n_pivots=8, n_pairs=12, block=64)
    assert server.index.torch_device.type == "cuda"
    reset_launch_counts()
    out = server.search(q, "knn", k=4)
    assert out.stats["backend"] == "cuda"
    assert launch_counts()["masked_pairwise_l2"] > 0
