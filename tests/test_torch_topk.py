"""The kNN round top-k of the port (``repro_torch.core.flat_index.
_round_top_k``) against ``jax.lax.top_k(-d, k)``, the reference's round
top-k, and kNN with exact ties through both precisions against JAX.

The top-k takes int64 keys (the IEEE total-order image of each float32 in
the high word, the column in the low word), so it must return what
``jax.lax.top_k`` returns on the negated block: the k smallest entries
ascending, equal values by lowest position, -0.0 ahead of +0.0, rows of
+inf by position.  Compared on crafted rows: ids equal, values equal bit
for bit.

kNN on an integer-valued l2 corpus with exact duplicate rows: every
squared distance is an integer that float32 holds exactly, so both
packages compute every distance exactly and many tie; ids, distances,
rounds and every stats key then equal JAX's dense path bit for bit in fp32
and bf16 (the integers are bf16 values too), also with k above the valid
corpus.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat_index as r_flat
from repro.core.backends import EngineOpts as REngineOpts
from repro_torch.core import flat_index as t_flat
from repro_torch.core.backends import EngineOpts
from test_torch_bss_engine import _assert_stats_equal

NEG0 = np.float32(-0.0)


def crafted_rows() -> np.ndarray:
    """(8, 12) float32 rows: signed zeros, exact ties, +inf, negatives."""
    inf = np.inf
    rows = [
        [0.0, NEG0, 0.5, 0.0, NEG0, 1.0, 0.5, 2.0, 0.0, 3.0, NEG0, 0.25],
        [0.5] * 12,                                     # all tie
        [inf] * 12,                                     # nothing computed
        [inf, 3.0, inf, 1.0, inf, inf, 1.0, inf, inf, inf, inf, inf],  # 3 finite
        [1.0, -2.0, NEG0, -0.5, 0.0, -2.0, 7.0, inf, -inf, 1e-45, -1e-45, 0.0],
        [2.0, 1.0, 2.0, 1.0, 0.0, 0.0, 3.0, 3.0, NEG0, NEG0, 1.0, 2.0],
        [3.4e38, inf, 1.0e-38, 1.2e-38, 3.4e38, 0.0, inf, 5.0, 5.0, 5.0, 0.0, 1.0e-38],
        [NEG0] * 6 + [0.0] * 6,
    ]
    return np.array(rows, np.float32)


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("k", [1, 3, 5, 12])
def test_round_top_k_equals_jax_top_k(k):
    d = crafted_rows()
    neg, want_idx = jax.lax.top_k(-jnp.asarray(d), k)
    want_val = -np.asarray(neg)
    radii = torch.full((d.shape[0],), 1.0)
    alive = torch.zeros((d.shape[0], 3), dtype=torch.bool)
    idx, val, kth, done = t_flat._round_top_k(torch.from_numpy(d), radii, alive, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(bits(val.numpy()), bits(want_val))
    np.testing.assert_array_equal(bits(kth.numpy()), bits(want_val[:, -1]))
    want_done = np.isfinite(want_val[:, -1]) & (want_val[:, -1] <= 1.0)
    np.testing.assert_array_equal(done.numpy(), want_done)


def test_total_order_keys_rank_signed_zeros_and_infinities():
    """-0.0 ranks ahead of +0.0 whatever their positions (a stable sort
    ranks them by position); rows of +inf come back by position."""
    d = torch.tensor([[0.0, -0.0, 0.0, -0.0], [np.inf] * 4], dtype=torch.float32)
    idx, val = t_flat._top_k_smallest(d, 4)
    assert idx.tolist() == [[1, 3, 0, 2], [0, 1, 2, 3]]
    assert torch.equal(torch.signbit(val[0]), torch.tensor([True, True, False, False]))
    # against the stable sort it replaces, on ties of any other value
    rng = np.random.default_rng(0)
    block = torch.from_numpy(rng.integers(0, 5, size=(6, 300)).astype(np.float32))
    block[block == 4] = np.inf
    s_val, s_idx = torch.sort(block, dim=1, stable=True)
    idx, val = t_flat._top_k_smallest(block, 40)
    assert torch.equal(idx, s_idx[:, :40]) and torch.equal(val, s_val[:, :40])


def integer_space(n, dim, seed, copies=4):
    """Integer-valued rows in [0, 16), each repeated ``copies`` times."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 16, size=(n // copies, dim)).astype(np.float32)
    return np.repeat(base, copies, axis=0)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("k,n_db", [(7, 640), (50, 40)])
def test_knn_with_exact_ties_bit_equal_to_jax_dense(precision, k, n_db):
    db = integer_space(n_db, 6, seed=n_db)
    q = np.random.default_rng(1).integers(0, 16, size=(19, 6)).astype(np.float32)
    q[:4] = db[[0, 5, 9, 13]]  # queries on duplicated corpus rows: distance 0
    r_idx = r_flat.build_bss("l2", db, n_pivots=6, n_pairs=8, block=32, seed=2)
    t_idx = t_flat.index_from_arrays(
        {f: getattr(r_idx, f) for f in t_flat.INDEX_FIELDS}, device="cpu")
    want = r_flat.bss_knn_batched(
        r_idx, q, k, opts=REngineOpts(backend="jnp", realisation="dense", precision=precision))
    got = t_flat.bss_knn_batched(
        t_idx, q, k, opts=EngineOpts(backend="torch", realisation="dense", precision=precision))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(bits(got[1]), bits(want[1]))
    _assert_stats_equal(got[2], want[2])
    assert (got[1][:4, 0] == 0.0).all()
    if k > n_db:
        assert (got[0][:, n_db:] == -1).all() and np.isinf(got[1][:, n_db:]).all()
