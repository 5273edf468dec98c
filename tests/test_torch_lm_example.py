"""``examples/torch_lm_embedding_retrieval.py`` against the JAX package's
``examples/lm_embedding_retrieval.py``, on the CPU at a reduced size.

The port's reduced Llama holds JAX's own parameters; both examples embed
the same ``TokenStream`` windows (within 1e-5: IEEE float32 in both, summed
in another order), calibrate, build the index and search.  The oracle's
and the ``"torch"`` engine's hits at JAX's threshold equal JAX's oracle
hits, except points whose float64 distance lies within 1e-5 * max(1, t) of
t (the corpora differ in their last bits).  The threshold is compared on
one corpus: ``calibrate_threshold`` keeps the sampled self-pairs whose
distance rounds above 1e-12, so its quantile follows a corpus's last bits.
"""

from __future__ import annotations

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import registry as jax_registry
from repro.core import flat_index as jflat
from repro.data.metricsets import calibrate_threshold as j_calibrate
from repro.data.pipeline import TokenStream as JTokenStream
from repro_torch.configs.registry import registry
from repro_torch.core import flat_index
from repro_torch.data.metricsets import calibrate_threshold
from repro_torch.models.params import load_jax_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
WINDOWS = 1024


def _load(rel: str):
    spec = importlib.util.spec_from_file_location(pathlib.Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def both():
    """(JAX's corpus and queries, the port's) from the two examples'
    embedding functions over the same windows and parameters."""
    jex, tex = _load("examples/lm_embedding_retrieval.py"), _load(
        "examples/torch_lm_embedding_retrieval.py")
    jm, _, _ = jax_registry()["llama3.2-1b"].make_reduced()
    params = jm.init_params(jax.random.PRNGKey(0))
    tm, _, _ = registry()["llama3.2-1b"].make_reduced()
    load_jax_params(tm, jax.tree.map(np.asarray, params), device="cpu")
    stream = JTokenStream(vocab=jm.cfg.vocab, batch=256, seq=32, seed=0)
    jemb = np.concatenate([
        jex.embed_windows(jm, params, jnp.asarray(stream.next()["tokens"][:, :-1]))
        for _ in range(WINDOWS // 256)])
    temb = tex.embed_stream(tm, WINDOWS, torch.device("cpu"))
    return tex, (jemb[64:], jemb[:64]), (temb[64:], temb[:64])


def test_embeddings_match_jax(both):
    _, (jc, jq), (tc, tq) = both
    assert tc.shape == jc.shape == (WINDOWS - 64, 32) and tc.dtype == np.float32
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tq, jq, rtol=1e-5, atol=1e-5)


def test_oracle_and_engine_hits_equal_jax(both):
    tex, (jc, jq), (tc, tq) = both
    t = j_calibrate("l2", jc, 2e-3)
    assert calibrate_threshold("l2", jc, 2e-3) == t
    jidx = jflat.build_bss("l2", jc, n_pivots=12, n_pairs=16, block=128)
    jhits, jstats = jflat.bss_query(jidx, jq, t)
    idx = flat_index.build_bss("l2", tc, n_pivots=12, n_pairs=16, block=128, device="cpu")
    hits, stats = flat_index.bss_query(idx, tq, t)
    eng, est = flat_index.bss_query_batched(idx, tq, t)
    assert est["backend"] == "torch"
    assert sum(map(len, jhits)) > 0
    assert stats["dists_per_query"] > 0 and jstats["dists_per_query"] > 0
    for got in (hits, [sorted(h) for h in eng]):
        for qv, a, b in zip(tq, got, jhits):
            for j in set(a) ^ set(b):
                dj = float(np.linalg.norm(qv.astype(np.float64) - tc[j]))  # lint: disable=R3
                assert abs(dj - t) <= tex.BAND * max(1.0, t), (j, dj, t)


def test_example_runs_on_the_cpu(capsys):
    """The example end to end at ``--device cpu``: the oracle exact against
    the float64 scan and the engine equal to the oracle."""
    tex = _load("examples/torch_lm_embedding_retrieval.py")
    out = tex.main(["--device", "cpu", "--windows", "512"])
    assert out["exact"] and out["engine_backend"] == "torch"
    assert out["corpus"].shape == (512 - 64, 32)
    text = capsys.readouterr().out
    assert "exact=True" in text and "== oracle" in text
    with pytest.raises(ValueError, match="not an LM"):
        tex.main(["--device", "cpu", "--arch", "din"])
