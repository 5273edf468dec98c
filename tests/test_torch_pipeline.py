"""The port's data pipeline (``repro_torch.data.pipeline``) against the JAX
package's: the four streams give the same arrays bit for bit, for the same
seed and step, over five steps and after ``restore``."""

from __future__ import annotations

import numpy as np
import pytest

from repro.configs.registry import registry as jax_registry
from repro.data import pipeline as jp
from repro_torch.configs.registry import registry
from repro_torch.data import pipeline as tp

ARCHS = ["wide-deep", "din", "two-tower-retrieval", "dlrm-rm2"]
STEPS = 5


def _same(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


def _graph(seed: int = 0):
    rng = np.random.default_rng(seed)
    n = 200
    deg = rng.integers(0, 6, size=n)
    deg[::17] = 0  # isolated nodes take the self-loop fallback
    indptr = np.concatenate([[0], np.cumsum(deg)])
    indices = rng.integers(0, n, size=indptr[-1])
    feats = rng.normal(size=(n, 12)).astype(np.float32)
    labels = rng.integers(0, 5, size=n)
    return indptr, indices, feats, labels


def _streams(kind: str, arch: str | None = None):
    """(the JAX package's stream, the port's), built alike."""
    if kind == "tokens":
        return (jp.TokenStream(vocab=101, batch=4, seq=16, seed=3),
                tp.TokenStream(vocab=101, batch=4, seq=16, seed=3))
    if kind == "clicks":
        jcfg = jax_registry()[arch].make_reduced()[1]
        tcfg = registry()[arch].make_reduced()[1]
        return jp.ClickStream(jcfg, batch=16, seed=7), tp.ClickStream(tcfg, batch=16, seed=7)
    g = _graph()
    return (jp.NeighborSampler(*g, batch_nodes=8, fanout=(3, 2), seed=5),
            tp.NeighborSampler(*g, batch_nodes=8, fanout=(3, 2), seed=5))


CASES = [("tokens", None), ("neighbors", None)] + [("clicks", a) for a in ARCHS]


@pytest.mark.parametrize("kind, arch", CASES, ids=[c[1] or c[0] for c in CASES])
def test_stream_equals_jax_over_five_steps_and_after_restore(kind, arch):
    j, t = _streams(kind, arch)
    for _ in range(STEPS):
        _same(t.next(), j.next())
    assert t.state() == j.state()
    st = j.state()
    want = j.next()
    j2, t2 = _streams(kind, arch)
    t2.restore(st)
    j2.restore(st)
    _same(t2.next(), want)
    _same(j2.next(), t.next())


def test_click_stream_dtypes_follow_the_spec():
    """int32 ids, bool history masks, float32 features and 0/1 labels: the
    torch dtypes of the port's spec are mapped, not read off their names."""
    t = tp.ClickStream(registry()["din"].make_reduced()[1], batch=16, seed=1).next()
    assert t["hist_ids"].dtype == np.int32 and t["target_id"].dtype == np.int32
    assert t["hist_valid"].dtype == np.bool_
    assert t["label"].dtype == np.float32 and set(np.unique(t["label"])) <= {0.0, 1.0}


def test_batched_molecules_equal_jax():
    for seed in range(3):
        _same(tp.batched_molecules(np.random.default_rng(seed), 4, 6, 9, 5, 3),
              jp.batched_molecules(np.random.default_rng(seed), 4, 6, 9, 5, 3))
