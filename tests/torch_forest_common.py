"""Shared cases of the port's forest tests (``tests/test_torch_forest*.py``):
the reference test space of ``tests/test_forest.py``, the JAX encoding
carried into the port by ``forest_from_arrays``, and the comparisons.

Every walk is held three ways on the same tree: the port's walk on its own
encoding, the port's walk on the JAX package's encoding, and the JAX
package's walk (``backend="jnp"``, or Pallas in interpret mode) — hits in
the same order, ``per_query_dists``, the exclusion attribution and the
frontier occupancy equal — and to the host numpy walk: the same hit sets
and ``DistanceCounter.per_query``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro import forest as jax_forest
from repro.core import lrt as jax_lrt
from repro.core import tree as jax_tree
from repro.data import metricsets
from repro_torch import forest
from repro_torch.core import lrt, tree
from repro_torch.forest.encode import forest_from_arrays


def space():
    """``tests/test_forest.py``'s space: a 650 x 16 colors surrogate, 12
    queries, t at selectivity 5e-3."""
    data = metricsets.colors_surrogate(650, dim=16, seed=3)
    db, q = metricsets.split_queries(data, 0.05, seed=4)
    return db, q[:12], metricsets.calibrate_threshold("l2", db, 5e-3)


def same_sets(res, oracle) -> bool:
    return len(res) == len(oracle) and all(
        sorted(a) == sorted(b) for a, b in zip(res, oracle)
    )


def assert_tables_equal(port_enc, jax_enc) -> None:
    """The port's host tables equal the JAX package's, array for array."""
    want = dataclasses.asdict(jax_enc)
    got = dataclasses.asdict(port_enc)
    for key, w in want.items():
        if key.startswith("_"):
            continue
        if key == "levels":
            assert len(got[key]) == len(w)
            for glv, wlv in zip(got[key], w):
                for name, arr in wlv.items():
                    np.testing.assert_array_equal(glv[name], arr, err_msg=name)
                    assert np.asarray(glv[name]).dtype == np.asarray(arr).dtype, name
        elif key == "leaf":
            for name, arr in w.items():
                np.testing.assert_array_equal(got[key][name], arr, err_msg=name)
                assert got[key][name].dtype == arr.dtype, name
        else:
            np.testing.assert_array_equal(got[key], w, err_msg=key)


def build_tree_pair(variant: str, metric: str, db, seed: int):
    """(port tree, port encoding, JAX encoding carried into the port, JAX
    encoding) of one variant built by both packages with one seed."""
    ptr = tree.build_tree(variant, metric, db, seed=seed)
    jenc = jax_forest.encode_tree(jax_tree.build_tree(variant, metric, db, seed=seed))
    penc = forest.encode_tree(ptr, device="cpu")
    return ptr, penc, forest_from_arrays(dataclasses.asdict(jenc), "forest", device="cpu"), jenc


def build_monotone_pair(partition: str, select: str, metric: str, db, seed: int):
    ptr = lrt.build_monotone_tree(partition, select, metric, db, seed=seed)
    jenc = jax_forest.encode_monotone(
        jax_lrt.build_monotone_tree(partition, select, metric, db, seed=seed))
    penc = forest.encode_monotone(ptr, device="cpu")
    return ptr, penc, forest_from_arrays(dataclasses.asdict(jenc), "monotone", device="cpu"), jenc


def jax_kw(backend: str) -> dict:
    return {"backend": backend, "interpret": True if backend == "pallas" else None}


def assert_walks_agree(search, jax_search, penc, carried, jenc, q, t, mech,
                       oracle, *, jax_backend: str = "jnp"):
    """The port's walk on both encodings and the JAX walk: hits (in order),
    counts, attribution and frontier equal; and the host oracle's sets and
    counts.  Returns the port's (hits, stats)."""
    res_np, counter = oracle
    res, stats = search(penc, q, t, mech)
    res_c, stats_c = search(carried, q, t, mech)
    res_j, stats_j = jax_search(jenc, q, t, mech, **jax_kw(jax_backend))
    assert same_sets(res, res_np)
    np.testing.assert_array_equal(stats["per_query_dists"], counter.per_query)
    assert res == res_c == res_j
    for st in (stats_c, stats_j):
        np.testing.assert_array_equal(stats["per_query_dists"], st["per_query_dists"])
        np.testing.assert_array_equal(stats["frontier_occupancy"], st["frontier_occupancy"])
        assert stats["excluded"].keys() == st["excluded"].keys()
        for m in st["excluded"]:
            np.testing.assert_array_equal(stats["excluded"][m], st["excluded"][m])
    assert stats["engine"] == stats_j["engine"] and stats["backend"] == "torch"
    return res, stats
