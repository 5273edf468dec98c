"""The recsys family's serving path on the card: bf16 towers held to the
float32 CPU forward over the same weights, and a two-tower corpus served at
K = 256 by the Hopper kernels, held to the plain ``"torch"`` backend on the
same card, bf16 equal to fp32.

The towers run the full two-tower widths (tower MLP 1024-512-256, 256
dims) at a small vocabulary, so the tables stay small; serving runs over a
few thousand item rows.  The file imports no jax; on the card it runs as

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_two_tower.py
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.common import recsys_batch_spec
from repro_torch.configs.recsys_archs import DIN, DLRM, TWO_TOWER, WIDE_DEEP
from repro_torch.core.backends import EngineOpts
from repro_torch.core.npdist import pairwise_np
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.models import recsys as R
from repro_torch.serve.retrieval import (RetrievalServer, distance_to_score,
                                         score_to_distance)

VOCAB = 4096
BAND = 1e-5
# a bf16 forward against the float32 one over the same weights: every
# layer's output rounds to bf16 (relative 2**-9 each), through up to five
# layers and a final sum that may cancel; held relative to the largest |logit|
CTR_REL = 5e-2


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


def _two_tower(dev):
    cfg = dataclasses.replace(TWO_TOWER, vocab=VOCAB)
    return R.TwoTowerModel(cfg).init_params(torch.Generator(dev).manual_seed(0), device=dev)


def _cos(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


@pytest.mark.cuda
@pytest.mark.parametrize("tower, fields", [("user_embed", 8), ("item_embed", 4)])
def test_bf16_towers_on_card_match_fp32_on_cpu(card, tower, fields):
    model = _two_tower(card)
    cpu = R.cast_model(model, torch.float32, "cpu")
    ids = np.random.default_rng(1).integers(0, VOCAB, size=(256, fields))
    with torch.inference_mode():
        got = getattr(model, tower)(torch.as_tensor(ids, device=card)).float().cpu().numpy()
        want = getattr(cpu, tower)(torch.as_tensor(ids)).numpy()
    assert model.user_w[0].dtype == torch.bfloat16
    assert _cos(got, want).min() >= 0.999
    assert np.abs(got - want).max() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [WIDE_DEEP, DIN, DLRM], ids=lambda c: c.name)
def test_ctr_forward_on_card_matches_fp32_on_cpu(card, cfg):
    cfg = dataclasses.replace(cfg, vocab=VOCAB)
    model = {"wide_deep": R.WideDeepModel, "din": R.DINModel, "dlrm": R.DLRMModel}[cfg.kind](cfg)
    model.init_params(torch.Generator(card).manual_seed(0), device=card)
    cpu = R.cast_model(model, torch.float32, "cpu")
    rng = np.random.default_rng(2)
    batch = {}
    for key, spec in recsys_batch_spec(cfg, 512, train=True).items():
        if spec.dtype == torch.int32:
            batch[key] = rng.integers(0, VOCAB, size=spec.shape).astype(np.int32)
        elif spec.dtype == torch.bool:
            batch[key] = rng.random(spec.shape) < 0.8
        elif key == "label":
            batch[key] = (rng.random(spec.shape) < 0.5).astype(np.float32)
        else:
            batch[key] = rng.normal(size=spec.shape).astype(np.float32)
    with torch.inference_mode():
        got = model.forward({k: torch.as_tensor(v, device=card) for k, v in batch.items()})
        want = cpu.forward({k: torch.as_tensor(v) for k, v in batch.items()})
        loss = R.bce_loss(model, {k: torch.as_tensor(v, device=card) for k, v in batch.items()})
    got, want = got.cpu().numpy(), want.numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all() and np.isfinite(float(loss))
    assert np.abs(got - want).max() <= CTR_REL * np.abs(want).max()


def _knn_id_faults(q, corpus, a, b) -> list:
    """Positions where two id lists differ with float64 distances farther
    apart than 1e-5 (and not both at the kth within 1e-5)."""
    bad = []
    for qi in np.nonzero((a != b).any(axis=1))[0]:
        da = pairwise_np("l2", q[qi], corpus[a[qi]])[0]
        db = pairwise_np("l2", q[qi], corpus[b[qi]])[0]
        kth = max(da.max(), db.max())
        for pos in np.nonzero(a[qi] != b[qi])[0]:
            near = abs(da[pos] - db[pos]) <= BAND
            at_kth = abs(da[pos] - kth) <= BAND and abs(db[pos] - kth) <= BAND
            if not (near or at_kth):
                bad.append((int(qi), int(pos)))
    return bad


@pytest.mark.cuda
def test_two_tower_corpus_served_at_256_dims(card):
    """3,000 items of the towers' own corpus (bf16 towers, upcast) through
    ``RetrievalServer`` on the card: kNN and min-score range on ``"cuda"``
    against ``"torch"`` on the same index, and bf16 equal to fp32 in every
    field; the path launches rows 1, 2, 2b and 3b of PERF.md §6."""
    model = _two_tower(card)
    rng = np.random.default_rng(3)
    with torch.inference_mode():
        corpus = model.item_embed(torch.as_tensor(
            rng.integers(0, VOCAB, size=(3000, 4)), device=card)).float().cpu().numpy()
        users = model.user_embed(torch.as_tensor(
            rng.integers(0, VOCAB, size=(200, 8)), device=card)).float().cpu().numpy()
    server = RetrievalServer(corpus, device=card)
    assert server.index.data.shape[1] == 256
    q = server._prep(users)
    d = pairwise_np("l2", q, server.corpus)
    # the distance the min-score maps to, so range_query and search agree
    t = float(score_to_distance(distance_to_score(np.quantile(d, 5e-3))))
    reset_launch_counts()
    knn = server.search(users, "knn", k=10, opts=EngineOpts(backend="cuda"))
    knn16 = server.search(users, "knn", k=10, opts=EngineOpts(backend="cuda", precision="bf16"))
    hits = server.range_query(users, float(distance_to_score(t)))
    rng_ = server.search(users, "range", t=t, opts=EngineOpts(backend="cuda"))
    rng16 = server.search(users, "range", t=t, opts=EngineOpts(backend="cuda", precision="bf16"))
    counts = launch_counts()
    for entry in ("pairwise_l2", "masked_pairwise_l2", "masked_pairwise_l2_bf16",
                  "planar_lower_bound_pairs"):
        assert counts[entry] > 0, (entry, counts)
    plain = server.search(users, "knn", k=10, opts=EngineOpts(backend="torch"))
    assert not _knn_id_faults(q, server.corpus, knn.indices, plain.indices)
    kth, p_kth = knn.distances[:, -1], plain.distances[:, -1]
    differ = knn.stats["per_query_dists"] != plain.stats["per_query_dists"]
    assert (np.abs(kth - p_kth)[differ] <= BAND).all()
    truth = np.argsort(d, axis=1, kind="stable")[:, :10]
    assert not _knn_id_faults(q, server.corpus, knn.indices, truth)
    for key in ("indices", "distances"):
        assert np.array_equal(getattr(knn16, key), getattr(knn, key)), key
    assert knn16.stats["rounds"] == knn.stats["rounds"]
    np.testing.assert_array_equal(knn16.stats["per_query_dists"], knn.stats["per_query_dists"])
    p_rng = server.search(users, "range", t=t, opts=EngineOpts(backend="torch"))
    assert rng_.hits == hits and sum(map(len, hits)) > 0
    for qi, (a, b) in enumerate(zip(rng_.hits, p_rng.hits)):
        for i in set(a) ^ set(b):
            assert abs(d[qi, i] - t) <= BAND * max(1.0, t), (qi, i)
    assert rng16.hits == rng_.hits
    for key in ("per_query_dists", "tiles_computed"):
        np.testing.assert_array_equal(rng16.stats[key], rng_.stats[key])
    np.testing.assert_array_equal(rng16.stats["excluded"]["hilbert"],
                                  rng_.stats["excluded"]["hilbert"])
