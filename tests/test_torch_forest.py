"""The port's device forest (``repro_torch.forest``) against the JAX
package's and the host numpy walks, on the CPU: the mirror of
``tests/test_forest.py`` for the 12 partition-tree variants.

For every variant and mechanism the port's host tables equal the JAX
encoder's array for array; the port's walk, on its own encoding and on the
JAX encoding carried over by ``forest_from_arrays``, returns the JAX walk's
hits in the same order, its ``per_query_dists``, exclusion attribution and
frontier occupancy, and the host walk's hit sets and
``DistanceCounter.per_query`` (``torch_forest_common``).  The monotone
family, the Pallas interpret cases and the edge cases are in
``tests/test_torch_forest_monotone.py`` and
``tests/test_torch_forest_edges.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro import forest as jax_forest
from repro_torch import forest
from repro_torch.core import tree
from repro_torch.core.exclusion import HILBERT, HYPERBOLIC
from torch_forest_common import (
    assert_tables_equal,
    assert_walks_agree,
    build_tree_pair,
    space,
)


@functools.lru_cache(maxsize=None)
def _space():
    return space()


@functools.lru_cache(maxsize=None)
def _variant(variant: str):
    db, _, _ = _space()
    return build_tree_pair(variant, "l2", db, seed=7)


@pytest.mark.parametrize("mech", [HYPERBOLIC, HILBERT])
@pytest.mark.parametrize("variant", tree.TREE_VARIANTS)
def test_forest_matches_jax_and_host_walk(variant, mech):
    """Hits, counts, attribution and frontier equal to JAX's jnp walk on the
    same tree, hit sets and counts to the host walk: 12 variants x both
    mechanisms."""
    _, q, t = _space()
    ptr, penc, carried, jenc = _variant(variant)
    assert_walks_agree(
        forest.forest_range_search, jax_forest.forest_range_search,
        penc, carried, jenc, q, t, mech, tree.range_search(ptr, q, t, mech),
    )


@pytest.mark.parametrize("variant", ["hpt_fft_log", "sat_pure", "hpt_random_binary"])
def test_encode_tables_equal_jax(variant):
    """Host tables array for array (dtypes too), and the device mirror holds
    them with int64 gather indices."""
    _, penc, carried, jenc = _variant(variant)
    assert_tables_equal(penc, jenc)
    assert_tables_equal(carried, jenc)
    assert penc.n_nodes == jenc.n_nodes and penc.leaf.n_leaves == jenc.leaf.n_leaves
    dev = penc.device
    for lv, host in zip(dev.levels, penc.levels):
        assert lv.parent_pos.dtype == lv.node_of_row.dtype == torch.int64
        assert lv.ref_data.device.type == "cpu"
        np.testing.assert_array_equal(lv.ref_data.numpy(), host.ref_data)
        np.testing.assert_array_equal(lv.node_of_row.numpy(), host.node_of_row)
    assert dev.leaves.leaf_of_row.dtype == torch.int64
    assert penc.leaf_bf16.dtype == torch.bfloat16
    assert penc.bf16_eps() == jenc.bf16_eps()


def test_encode_needs_a_card_by_default(monkeypatch):
    """``device=None`` encodes for the CUDA device and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ptr, *_ = _variant("hpt_fft_fixed")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        forest.encode_tree(ptr)


def test_forest_rejects_unknown_mechanism():
    _, q, t = _space()
    _, penc, _, _ = _variant("hpt_fft_fixed")
    with pytest.raises(ValueError):
        forest.forest_range_search(penc, q, t, "euclid")
    with pytest.raises(ValueError, match="backend"):
        forest.forest_range_search(penc, q, t, backend="jnp")
