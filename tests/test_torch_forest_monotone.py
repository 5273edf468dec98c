"""The port's monotone / LRT forest walk against the JAX package's and the
host walk ``lrt.range_search_monotone`` on the CPU, and the port's walks
against the JAX walks over the Pallas kernels in interpret mode (a few
trees: interpret mode is slow).  The mirror of ``tests/test_forest.py``'s
monotone and Pallas cases; comparisons as in ``torch_forest_common``.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

from repro import forest as jax_forest
from repro_torch import forest
from repro_torch.core import lrt, tree
from repro_torch.core.exclusion import HILBERT, HYPERBOLIC
from torch_forest_common import (
    assert_tables_equal,
    assert_walks_agree,
    build_monotone_pair,
    build_tree_pair,
    space,
)


@functools.lru_cache(maxsize=None)
def _space():
    return space()


@functools.lru_cache(maxsize=None)
def _monotone(partition: str, select: str):
    db, _, _ = _space()
    return build_monotone_pair(partition, select, "l2", db, seed=5)


@pytest.mark.parametrize("select", ["rand", "far"])
@pytest.mark.parametrize("partition", lrt.PARTITIONS)
def test_monotone_matches_jax_and_host_walk(partition, select):
    _, q, t = _space()
    ptr, penc, carried, jenc = _monotone(partition, select)
    assert_tables_equal(penc, jenc)
    assert_walks_agree(
        forest.monotone_range_search, jax_forest.monotone_range_search,
        penc, carried, jenc, q, t, HILBERT,
        lrt.range_search_monotone(ptr, q, t, HILBERT),
    )


def test_monotone_hyperbolic_closer():
    _, q, t = _space()
    ptr, penc, carried, jenc = _monotone("closer", "far")
    assert_walks_agree(
        forest.monotone_range_search, jax_forest.monotone_range_search,
        penc, carried, jenc, q, t, HYPERBOLIC,
        lrt.range_search_monotone(ptr, q, t, HYPERBOLIC),
    )


def test_monotone_rejects_hyperbolic_planar():
    _, q, t = _space()
    _, penc, _, _ = _monotone("lrt", "rand")
    with pytest.raises(ValueError, match="closer"):
        forest.monotone_range_search(penc, q, t, HYPERBOLIC)
    with pytest.raises(ValueError):
        forest.monotone_range_search(penc, q, t, "euclid")


@pytest.mark.parametrize("partition", ["lrt", "pca"])
def test_rotation_uses_host_cos_sin(partition):
    """cos(theta) and sin(theta) are float64 on the host rounded once to
    float32, the same bits on every device; the LRT / PCA trees rotate
    (some theta is nonzero) and still match the JAX walk above."""
    _, penc, _, _ = _monotone(partition, "far")
    for lv in penc.levels:
        theta = lv.theta.astype(np.float64)
        np.testing.assert_array_equal(lv.cos_theta, np.cos(theta).astype(np.float32))
        np.testing.assert_array_equal(lv.sin_theta, np.sin(theta).astype(np.float32))
        assert lv.cos_theta.dtype == lv.sin_theta.dtype == np.float32
    if partition == "lrt":
        assert any(np.any(lv.theta != 0) for lv in penc.levels)


@pytest.mark.parametrize("mech", [HYPERBOLIC, HILBERT])
def test_forest_matches_jax_pallas_interpret(mech):
    """The JAX walk over its Pallas masked tiles (interpret mode) gives the
    port's hits, counts and attribution."""
    db, q, t = _space()
    ptr, penc, carried, jenc = build_tree_pair("hpt_fft_log", "l2", db, seed=7)
    assert_walks_agree(
        forest.forest_range_search, jax_forest.forest_range_search,
        penc, carried, jenc, q, t, mech, tree.range_search(ptr, q, t, mech),
        jax_backend="pallas",
    )


def test_monotone_matches_jax_pallas_interpret():
    _, q, t = _space()
    ptr, penc, carried, jenc = _monotone("lrt", "far")
    assert_walks_agree(
        forest.monotone_range_search, jax_forest.monotone_range_search,
        penc, carried, jenc, q, t, HILBERT,
        lrt.range_search_monotone(ptr, q, t, HILBERT), jax_backend="pallas",
    )
