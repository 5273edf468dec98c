"""The port's bf16 margin (``repro_torch.core.precision``) against the JAX
package's (``repro.core.precision``) on the CPU.

* ``bf16_round_np`` rounds through ``torch.bfloat16``; it must give the
  bits ``ml_dtypes`` gives (round-to-nearest-even), on random values and
  on the edges: signed zeros, float32 subnormals, the largest finite
  float32, values that round to +-inf, NaN and exact ties.
* ``bf16_margin`` must be bit-equal to the reference's for every
  supermetric and a power transform, with and without a ``valid`` mask:
  the same rounded bits through the same float64 operations.
* The margin property of ``tests/test_bf16_precision.py``: the float64
  displacement of every (query, point) distance under bf16 rounding of
  the corpus stays within the port's margin.
"""

import ml_dtypes
import numpy as np
import pytest
from hypothesis_shim import given, settings, st

from repro.core import precision as r_precision
from repro.core.npdist import pairwise_np
from repro_torch.core import precision as t_precision

MARGIN_METRICS = ("l2", "cosine", "jsd", "triangular", "l1^0.5")


def _ml_round(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def _space(metric: str, n: int, dim: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.random((n, dim)).astype(np.float32) + 1e-3
    if metric in ("jsd", "triangular"):
        x /= x.sum(axis=1, keepdims=True)
    return x


def _edges() -> np.ndarray:
    f32 = np.finfo(np.float32)
    one = np.float32(1.0)
    bf_ulp = np.float32(2.0 ** -7)  # bf16 spacing at 1
    return np.array([
        0.0, -0.0,
        f32.tiny, -f32.tiny,                      # smallest normal
        np.float32(1e-45), np.float32(-1e-45),    # smallest subnormal
        np.float32(3e-39), np.float32(-7.5e-39),  # subnormals
        f32.max, -f32.max,                        # round to +-inf in bf16
        np.float32(3.3961776e38),                 # above bf16's max finite
        np.float32(3.3895314e38),                 # bf16's max finite
        np.inf, -np.inf,
        one + bf_ulp / 2,                         # tie: rounds down to even 1.0
        one + 3 * bf_ulp / 2,                     # tie: rounds up to even
        -(one + bf_ulp / 2),
        one + bf_ulp / 2 + np.float32(2.0 ** -23),  # just above a tie: up
        np.float32(1e-13), np.float32(1e-9),      # the colors corpus's tiny bins
    ], np.float32)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-30), (2, 1e30), (3, 1e-38)])
def test_bf16_round_matches_ml_dtypes_on_random_values(seed, scale):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(257, 33)) * scale).astype(np.float32)
    got = t_precision.bf16_round_np(a)
    assert got.dtype == np.float32 and got.shape == a.shape
    np.testing.assert_array_equal(got.view(np.uint32), _ml_round(a).view(np.uint32))
    assert np.array_equal(got, r_precision.bf16_round_np(a))


def test_bf16_round_matches_ml_dtypes_on_edges():
    a = _edges()
    got = t_precision.bf16_round_np(a)
    want = _ml_round(a)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got[0] == 0.0 and not np.signbit(got[0]) and np.signbit(got[1])
    assert np.isinf(got[8]) and np.isinf(got[9]) and got[9] < 0
    assert got[14] == 1.0 and got[15] == np.float32(1.0 + 2.0 ** -6)
    # NaN stays NaN (its payload is not part of the mirror's contract)
    nan = t_precision.bf16_round_np(np.array([np.nan, -np.nan], np.float32))
    assert np.isnan(nan).all() and np.isnan(_ml_round(np.array([np.nan]))).all()


def test_bf16_round_takes_any_layout():
    a = np.asfortranarray(np.random.default_rng(4).normal(size=(9, 7)).astype(np.float32))
    np.testing.assert_array_equal(t_precision.bf16_round_np(a), _ml_round(a))
    np.testing.assert_array_equal(t_precision.bf16_round_np(a[:, ::2]), _ml_round(a[:, ::2]))
    assert t_precision.bf16_round_np(np.float32(1.00390625)) == np.float32(1.0)


@pytest.mark.parametrize("metric", MARGIN_METRICS)
@pytest.mark.parametrize("masked", [False, True])
def test_bf16_margin_bit_equal_to_reference(metric, masked):
    data = _space("jsd" if metric in ("jsd", "triangular") else "l2", 300, 19, seed=5)
    valid = None
    if masked:
        data = np.concatenate([data, np.full((13, 19), 7.0, np.float32)])
        valid = np.ones(len(data), bool)
        valid[-13:] = False
        valid[::17] = False
    got = t_precision.bf16_margin(metric, data, valid)
    want = r_precision.bf16_margin(metric, data, valid)
    assert isinstance(got, float)
    assert np.float64(got).view(np.uint64) == np.float64(want).view(np.uint64)
    assert got == float(np.float32(got))  # an fp32 value, rounded up into fp32


def test_bf16_margin_guards_match_reference():
    data = _space("l2", 64, 8, 3)
    assert t_precision.bf16_margin("l2", data) > 0.0
    empty = np.zeros((0, 8), np.float32)
    assert t_precision.bf16_margin("l2", empty) == r_precision.bf16_margin("l2", empty)
    padded = np.concatenate([data, np.full((1, 8), 1e30, np.float32)])
    valid = np.ones(65, bool)
    valid[-1] = False
    assert t_precision.bf16_margin("l2", padded, valid) == t_precision.bf16_margin(
        "l2", data, np.ones(64, bool))
    assert t_precision.ARITH_ULPS == r_precision.ARITH_ULPS


@settings(max_examples=25, deadline=None)
@given(
    st.sampled_from(("l2", "cosine", "jsd", "triangular")),
    st.integers(min_value=0, max_value=10_000),
    st.integers(min_value=2, max_value=48),
)
def test_margin_never_falsely_excludes(metric, seed, dim):
    """tests/test_bf16_precision.py:69 on the port's margin: the float64
    displacement of every distance under bf16 rounding of the corpus stays
    within ``bf16_margin``."""
    data = _space(metric, 80, dim, seed)
    q = _space(metric, 16, dim, seed + 1)
    eps = t_precision.bf16_margin(metric, data)
    d_true = pairwise_np(metric, q, data)
    d_tilde = pairwise_np(metric, q, t_precision.bf16_round_np(data))
    assert float(np.abs(d_true - d_tilde).max()) <= eps, (metric, seed, dim)
