"""The two-tower serving path end to end on the CPU — the port of
``repro.launch.serve``'s pipeline held to the JAX package.

Both packages get the same corpus (JAX's ``item_embed`` of numpy-seeded
item ids, over JAX's reduced-model parameters) and the same user rows: the
port's ``RetrievalServer(device="cpu")`` must return JAX's top-k ids and
range hits with the same per-query distance counts, bit for bit.  The
min-score threshold is snapped to a gap between distances (the reference
tests' idiom) so float32 and float64 agree on every ``d <= t``.  The
port's own towers (the same parameters through ``load_jax_params``) embed
a corpus too, which its server serves; its top-k ids are held to a float64
brute force, a difference allowed only between ids whose float64 distances
lie within 1e-5 (counted).  The launcher runs in a subprocess.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import registry as jax_registry
from repro.serve.retrieval import RetrievalServer as JaxServer
from repro_torch.configs.registry import registry
from repro_torch.core.npdist import pairwise_np
from repro_torch.models.recsys import load_jax_params
from repro_torch.serve.retrieval import RetrievalServer, score_to_distance

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_ITEMS, N_USERS, K = 3000, 48, 10


@pytest.fixture(scope="module")
def slice_case():
    jm, cfg, _ = jax_registry()["two-tower-retrieval"].make_reduced()
    params = jm.init_params(jax.random.PRNGKey(0))
    tm, _, _ = registry()["two-tower-retrieval"].make_reduced()
    load_jax_params(tm, jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(11)
    item_ids = rng.integers(0, cfg.vocab, size=(N_ITEMS, cfg.n_item_fields))
    user_ids = rng.integers(0, cfg.vocab, size=(N_USERS, cfg.n_user_fields))
    corpus = np.asarray(jm.item_embed(params, item_ids), np.float32)
    users = np.asarray(jm.user_embed(params, user_ids), np.float32)
    with torch.no_grad():
        port_corpus = tm.item_embed(torch.as_tensor(item_ids)).numpy()
        port_users = tm.user_embed(torch.as_tensor(user_ids)).numpy()
    return corpus, users, port_corpus, port_users


def _snap(dvals: np.ndarray, frac: float) -> float:
    vals = np.unique(np.sort(np.asarray(dvals, np.float64).ravel()))  # lint: disable=R3
    i = int(np.clip(frac * len(vals), 0, len(vals) - 2))
    for j in range(i, len(vals) - 1):
        if vals[j + 1] - vals[j] > 1e-4 * max(1.0, vals[j]):
            return float(0.5 * (vals[j] + vals[j + 1]))
    return float(vals[-1] + 1.0)


def test_port_server_equals_jax_server_on_the_same_corpus(slice_case):
    corpus, users, _, _ = slice_case
    port = RetrievalServer(corpus, device="cpu")
    ref = JaxServer(corpus)
    np.testing.assert_array_equal(port.corpus, ref.corpus)
    a, b = port.search(users, "knn", k=K), ref.search(users, "knn", k=K)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.stats["per_query_dists"], b.stats["per_query_dists"])
    assert [list(r) for r in port.top_k(users, K)] == [list(r) for r in ref.top_k(users, K)]
    # min-score at about 20 hits a user, snapped to a gap in the distances
    d = pairwise_np("l2", port._prep(users), port.corpus)
    t = _snap(d, 20 / port.corpus.shape[0])
    min_score = 1.0 - 0.5 * t * t
    assert abs(float(score_to_distance(np.asarray(min_score))) - t) < 1e-9
    hits = port.range_query(users, min_score)
    assert hits == ref.range_query(users, min_score)
    assert sum(map(len, hits)) > 0
    ra, rb = port.search(users, "range", t=t), ref.search(users, "range", t=t)
    assert ra.hits == rb.hits
    np.testing.assert_array_equal(ra.stats["per_query_dists"], rb.stats["per_query_dists"])
    assert port.stats.n_queries == ref.stats.n_queries
    assert port.stats.total_dists == ref.stats.total_dists


def test_port_towers_serve_their_own_corpus_exactly(slice_case):
    corpus, users, port_corpus, port_users = slice_case
    np.testing.assert_allclose(port_corpus, corpus, rtol=1e-5, atol=1e-5)
    server = RetrievalServer(port_corpus, device="cpu")
    res = server.search(port_users, "knn", k=K)
    q = server._prep(port_users)
    d = pairwise_np("l2", q, server.corpus)
    truth = np.argsort(d, axis=1, kind="stable")[:, :K]
    ties = 0
    for qi in np.nonzero((res.indices != truth).any(axis=1))[0]:
        for pos in np.nonzero(res.indices[qi] != truth[qi])[0]:
            gap = abs(d[qi, res.indices[qi, pos]] - d[qi, truth[qi, pos]])
            assert gap <= 1e-5, (qi, pos, gap)
            ties += 1
    assert ties <= N_USERS, ties
    np.testing.assert_allclose(res.distances, np.take_along_axis(d, res.indices, 1),
                               rtol=1e-5, atol=1e-5)
    assert np.isfinite(res.distances).all()


@pytest.mark.parametrize("extra", [[], ["--min-score", "0.5"]])
def test_launcher_runs_on_the_cpu(extra):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--corpus", "3000", "--queries", "32", *extra],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "built supermetric index" in out.stdout
    assert "distances/query:" in out.stdout
    assert ("range query >= 0.5" if extra else "top-10 for 32 queries") in out.stdout
