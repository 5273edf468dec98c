"""The living corpus over the port's sharded engine, on the CPU.

The reference's sharded maintenance scenario (``tests/test_maintain.py``,
``_SHARDED``) on a 4-shard mesh of ``"cpu"`` devices: an append that fits
the padding blocks is written into them (``sharded_in_place``, no shard
tensor changes shape), a larger one re-lays the shards out, then a delete
and a compact that keeps the mesh.  At every generation the mesh-built
index returns what a single-device index put through the same mutations
returns, bit for bit (hits, counts, kNN ids, distances, rounds), fp32 and
bf16, and what JAX's single-device index returns (hits, counts, ids
exact).  A mutation never writes a tensor of the generation it came from.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import flat_index as r_flat
from repro.core.backends import EngineOpts as REngineOpts
from repro.index import append as r_append
from repro.index import compact as r_compact
from repro.index import delete as r_delete
from repro_torch.core import flat_index as t_flat
from repro_torch.core.backends import EngineOpts
from repro_torch.index import append, compact, delete
from repro_torch.kernels import _build
from repro_torch.parallel import ShardMesh
from test_torch_bss_engine import _space, safe_threshold
from test_torch_sharded import KNN_TOL, TORCH, TORCH16, _assert_same_stats

JNP = REngineOpts(backend="jnp", realisation="dense")
BUILD = dict(n_pivots=8, n_pairs=10, block=64, seed=1)


def _rows(metric, n, seed):
    return _space(metric, n, 10, seed=seed)


def _same(mesh_idx, plain, r_idx, q, t, k=5):
    """The mesh-built index against the single-device one (bit for bit, both
    precisions) and JAX's (hits, counts and ids exact), and the oracle."""
    for opts in (TORCH, TORCH16):
        hits, st = t_flat.bss_query_batched(mesh_idx, q, t, opts=opts)
        want_hits, want = t_flat.bss_query_batched(plain, q, t, opts=opts)
        assert hits == want_hits and st["n_shards"] == mesh_idx.mesh.size("data")
        _assert_same_stats(st, want)
        got = t_flat.bss_knn_batched(mesh_idx, q, k, opts=opts)
        exp = t_flat.bss_knn_batched(plain, q, k, opts=opts)
        np.testing.assert_array_equal(got[0], exp[0])
        np.testing.assert_array_equal(got[1], exp[1])
        _assert_same_stats(got[2], exp[2])
    r_hits, rs = r_flat.bss_query_batched(r_idx, q, t, opts=JNP)
    assert hits == r_hits
    np.testing.assert_array_equal(st["per_query_dists"], rs["per_query_dists"])
    r_ids, r_d, r_ks = r_flat.bss_knn_batched(r_idx, q, k, opts=JNP)
    np.testing.assert_array_equal(got[0], r_ids)
    np.testing.assert_allclose(got[1], r_d, **KNN_TOL)
    assert got[2]["rounds"] == r_ks["rounds"]
    assert hits == t_flat.bss_query(mesh_idx, q, t)[0]
    return hits


@pytest.mark.parametrize("metric", ["l2", "cosine", "jsd", "triangular"])
def test_sharded_living_corpus_matches_single_device_and_jax(metric):
    db, add, big = _rows(metric, 700, 1), _rows(metric, 20, 3), _rows(metric, 300, 4)
    q = _rows(metric, 11, 2)
    # snapped over every row any generation holds
    t = safe_threshold(t_flat.pairwise_np(metric, q, np.concatenate([db, add, big])), 0.05)
    mesh = ShardMesh(("cpu",) * 4)
    idx = t_flat.build_bss(metric, db, **BUILD, mesh=mesh)
    plain = t_flat.build_bss(metric, db, **BUILD, device="cpu")
    r_idx = r_flat.build_bss(metric, db, **BUILD)
    _same(idx, plain, r_idx, q, t)
    sidx = idx.sharded()
    shapes = [tuple(getattr(sh, f).shape) for sh in sidx.shards for f in sh._fields]
    loads = {s: _build.load_count(s) for s in _build.SOURCES}

    # a small append fits the trailing padding blocks (11 of 12): written in
    # place on the shard it lands on, shapes unchanged
    idx1, ms = append(idx, add)
    plain1, _ = append(plain, add)
    r_idx1, _ = r_append(r_idx, add)
    assert ms.sharded_in_place, ms
    s1 = idx1.sharded()
    assert s1 is idx1._sharded and s1.n_blocks_pad == sidx.n_blocks_pad
    assert [tuple(getattr(sh, f).shape) for sh in s1.shards for f in sh._fields] == shapes
    assert all(a is b for a, b in zip(s1.shards[:3], sidx.shards[:3]))  # untouched: shared
    _same(idx1, plain1, r_idx1, q, t)
    assert {s: _build.load_count(s) for s in _build.SOURCES} == loads  # none loaded again

    # a larger append overflows the free blocks: a lazy re-layout
    idx2, ms = append(idx1, big)
    plain2, _ = append(plain1, big)
    r_idx2, _ = r_append(r_idx1, big)
    assert not ms.sharded_in_place and idx2._sharded is None
    _same(idx2, plain2, r_idx2, q, t)
    assert idx2.sharded().n_blocks_pad > s1.n_blocks_pad

    # delete, then compact keep serving through the mesh
    dead = [0, 5, 700, 1019]
    idx3, _ = delete(idx2, dead)
    plain3, _ = delete(plain2, dead)
    r_idx3, _ = r_delete(r_idx2, dead)
    hits3 = _same(idx3, plain3, r_idx3, q, t)
    assert not any(set(h) & set(dead) for h in hits3)
    idx4, _ = compact(idx3)
    plain4, _ = compact(plain3)
    r_idx4, _ = r_compact(r_idx3)
    assert idx4.mesh is mesh and idx4._sharded is None
    hits4 = _same(idx4, plain4, r_idx4, q, t)
    # compaction re-permutes, so hit ORDER follows the new layout; the
    # hit SETS are the exactness contract
    assert [sorted(h) for h in hits4] == [sorted(h) for h in hits3]
    assert idx._device is None and idx4._device is None  # no unsharded mirror


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_old_generation_shard_tensors_are_never_written(n_shards):
    """After ``append`` (in place) and ``delete``, every tensor of the old
    generation's shards, bf16 mirror included, holds its old bits, and the
    old generation still answers as before."""
    db = _rows("l2", 700, 1)
    q = _rows("l2", 11, 2)
    t = safe_threshold(t_flat.pairwise_np("l2", q, db), 0.05)
    idx = t_flat.build_bss("l2", db, **BUILD, mesh=ShardMesh(("cpu",) * n_shards))
    before = t_flat.bss_query_batched(idx, q, t, opts=TORCH16)  # builds the bf16 mirror
    sidx = idx.sharded()

    def snapshot(s):
        return [[getattr(sh, f).clone() for f in sh._fields] for sh in s.shards], \
            [d.clone() for d in s.data16], s.perm.copy(), s._valid.copy()

    def unchanged(s, snap):
        tensors, d16, perm, valid = snap
        assert all(torch.equal(getattr(sh, f), old)
                   for sh, olds in zip(s.shards, tensors) for f, old in zip(sh._fields, olds))
        assert all(torch.equal(a, b) for a, b in zip(s.data16, d16))
        np.testing.assert_array_equal(s.perm, perm)
        np.testing.assert_array_equal(s._valid, valid)

    snap0 = snapshot(sidx)
    free = sidx.n_blocks_pad - idx.n_blocks
    idx1, ms = append(idx, _rows("l2", max(1, free) * 64 if free else 10, 3))
    assert ms.sharded_in_place == bool(free)
    unchanged(sidx, snap0)
    s1 = idx1.sharded()
    snap1 = snapshot(s1)
    idx2, _ = delete(idx1, [1, 2, 3, idx1.next_id - 1])
    s2 = idx2.sharded()
    unchanged(sidx, snap0)
    unchanged(s1, snap1)
    assert t_flat.bss_query_batched(idx, q, t, opts=TORCH16)[0] == before[0]
    assert not any({1, 2, 3} & set(h) for h in t_flat.bss_query_batched(idx2, q, t)[0])
    assert s2.perm[~s2._valid].tolist() == [-1] * int((~s2._valid).sum())


def test_server_mutations_on_a_mesh_fold_into_its_registry():
    """``RetrievalServer(mesh=)``: an append that fits the padding counts on
    ``index/sharded_in_place``; results stay equal to a meshless server's
    through append, delete and compact, and to the oracle's neighbours."""
    from repro_torch.serve.retrieval import RetrievalServer

    corpus = _rows("l2", 900, 5)
    users = _rows("l2", 13, 6)
    srv = RetrievalServer(corpus, metric="l2", block=64, mesh=ShardMesh(("cpu",) * 4),
                          opts=TORCH)
    plain = RetrievalServer(corpus, metric="l2", block=64, device="cpu", opts=TORCH)
    assert srv.index.n_blocks == 15 and srv.index.sharded().n_blocks_pad == 16
    ms = srv.append(_rows("l2", 40, 7))
    plain.append(_rows("l2", 40, 7))
    assert ms.sharded_in_place
    assert srv.metrics.snapshot()["counters"]["index/sharded_in_place"] == 1.0
    for mutate in (lambda s: s.delete([3, 4, 905]), lambda s: s.compact()):
        mutate(srv)
        mutate(plain)
        got = srv.search(users, "knn", k=6)
        want = plain.search(users, "knn", k=6)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.distances, want.distances)
        assert got.generation == want.generation and got.stats["n_shards"] == 4
        oracle = srv.top_k_oracle(users, 6)
        assert all(set(a.tolist()) == set(b.tolist()) for a, b in zip(got.indices, oracle))


def test_front_over_a_mesh_index_answers_each_generation():
    """A front over a mesh-built index mutated between batches: each result
    equals a direct call on the generation it names."""
    from repro_torch.serve.front import ServingFront

    db = _rows("l2", 900, 8)
    q = _rows("l2", 12, 9)
    t = safe_threshold(t_flat.pairwise_np("l2", q, db), 0.05)
    idx = t_flat.build_bss("l2", db, **BUILD, mesh=ShardMesh(("cpu",) * 4))
    gens = {idx.generation: idx}
    with ServingFront(idx, buckets=(8, 32), max_delay_s=0.01, opts=TORCH) as front:
        first = [f.result(timeout=120) for f in [front.submit(x, "range", t=t) for x in q]]
        front.append(_rows("l2", 30, 10))
        gens[front.index.generation] = front.index
        front.delete([0, 1, 2])
        gens[front.index.generation] = front.index
        second = [f.result(timeout=120) for f in [front.submit(x, "range", t=t) for x in q]]
    assert {r.generation for r in first} == {0} and {r.generation for r in second} == {2}
    for res in (first, second):
        g = gens[res[0].generation]
        want, st = t_flat.bss_query_batched(g, q, t, opts=TORCH)
        assert [r.hits for r in res] == want and st["n_shards"] == 4
        np.testing.assert_array_equal([r.n_dists for r in res], st["per_query_dists"])
