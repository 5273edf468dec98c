"""The port's living corpus (``repro_torch.index``) against the JAX
package's (``repro.index``) on the CPU, after ``tests/test_maintain.py``
(its front, server and sharded cases wait for those ports).

* The same append -> delete -> compact on the same index gives, at every
  generation, the reference's index field for field (``generation``,
  ``next_id``, ``tombstones`` included) and the same ``MutationStats``.
* At every generation the port's fp32 and bf16 range hits agree bit for
  bit with each other and with the numpy oracle over the generation's own
  live rows (per-query distance counts too), and kNN gives the float64
  brute force's neighbours.
* The device mirrors follow the reference's rules: append extends the fp32
  and bf16 mirrors by the new blocks and drops the margin; delete keeps
  both bf16 fields and never writes into the old generation's tensors;
  compact drops both.  With refreshed pivots, compact is a fresh build
  over the live rows, field for field.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import flat_index as r_flat
from repro.index import append as r_append
from repro.index import compact as r_compact
from repro.index import delete as r_delete
from repro.index import maybe_compact as r_maybe_compact
from repro_torch.core import flat_index
from repro_torch.core.backends import EngineOpts
from repro_torch.core.npdist import pairwise_np
from repro_torch.core.precision import bf16_round_np
from repro_torch.index import MutationStats, append, compact, delete, maybe_compact
from test_torch_bss_engine import _space
from test_torch_bss_engine import safe_threshold as _snap

METRICS = ("l2", "cosine", "jsd", "triangular")
_BF16 = EngineOpts(precision="bf16")


def _live_rows_by_id(index):
    live_pos = np.nonzero(index.valid)[0]
    ids = index.perm[live_pos]
    order = np.argsort(ids)
    return ids[order], index.data[live_pos[order]]


def _assert_same_index(got, want):
    """The port's index equals the reference's field for field."""
    for f in flat_index.INDEX_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, f
    assert got.tombstone_frac == want.tombstone_frac


def _assert_same_stats(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _truth_knn(metric, q, ids, rows, k):
    d = pairwise_np(metric, q, rows)
    kk = min(k, rows.shape[0])
    return [[int(ids[j]) for j in np.argsort(d[i])[:kk]] for i in range(len(q))]


def _check_all_paths(index, r_index, q, t, k):
    """fp32 and bf16 range, oracle and kNN on one generation."""
    ids, rows = _live_rows_by_id(index)
    oracle, o_stats = flat_index.bss_query(index, q, t)
    hits, st = flat_index.bss_query_batched(index, q, t)
    h16, st16 = flat_index.bss_query_batched(index, q, t, opts=_BF16)
    assert hits == h16 == oracle
    assert hits == r_flat.bss_query_batched(r_index, q, t)[0]
    np.testing.assert_array_equal(st["per_query_dists"], o_stats["per_query_dists"])
    np.testing.assert_array_equal(st16["per_query_dists"], st["per_query_dists"])
    assert st["generation"] == st16["generation"] == index.generation
    ki, kd, ks = flat_index.bss_knn_batched(index, q, k)
    ki16, kd16, ks16 = flat_index.bss_knn_batched(index, q, k, opts=_BF16)
    np.testing.assert_array_equal(ki, ki16)
    np.testing.assert_array_equal(kd, kd16)
    np.testing.assert_array_equal(ks["per_query_dists"], ks16["per_query_dists"])
    truth = _truth_knn(index.metric_name, q, ids, rows, k)
    for i in range(len(q)):
        assert [j for j in ki[i].tolist() if j >= 0] == truth[i], i
    return hits


@pytest.mark.parametrize("metric", METRICS)
def test_mutations_match_reference_and_fresh_build(metric):
    dim, k = 9, 5
    base = _space(metric, 460, dim, seed=11)
    extra = _space(metric, 70, dim, seed=12)
    q = _space(metric, 13, dim, seed=13)
    build = dict(n_pivots=7, n_pairs=9, block=32, seed=4)
    r0 = r_flat.build_bss(metric, base, **build)
    idx0 = flat_index.build_bss(metric, base, device="cpu", **build)
    _assert_same_index(idx0, r0)
    t = _snap(pairwise_np(metric, q, base), 0.03)
    _check_all_paths(idx0, r0, q, t, k)  # builds both mirrors and the margin
    assert idx0._device is not None and idx0._bf16 is not None
    eps0 = idx0._bf16_eps
    assert eps0 == r0.bf16_margin()

    # append: fresh blocks, mirrors extended, margin dropped
    old_data, old_bf16 = idx0._device.data.clone(), idx0._bf16.clone()
    idx1, ms = append(idx0, extra)
    r1, r_ms = r_append(r0, extra)
    _assert_same_index(idx1, r1)
    _assert_same_stats(ms, r_ms)
    assert ms.op == "append" and ms.table_dists == len(extra) * idx0.pivots.shape[0]
    assert ms.new_blocks == idx1.n_blocks - idx0.n_blocks and not ms.sharded_in_place
    assert idx1._bf16_eps is None and idx0._bf16_eps == eps0
    assert torch.equal(idx1._device.data, torch.from_numpy(idx1.data))
    assert torch.equal(idx1._device.boxes, torch.from_numpy(idx1.boxes))
    assert torch.equal(idx1._device.valid, torch.from_numpy(idx1.valid))
    assert idx1._device.pivots is idx0._device.pivots
    np.testing.assert_array_equal(idx1._bf16.float().numpy(), bf16_round_np(idx1.data))
    assert torch.equal(idx0._device.data, old_data) and torch.equal(idx0._bf16, old_bf16)
    assert idx0.generation == 0 and idx0.n_blocks < idx1.n_blocks
    _check_all_paths(idx1, r1, q, t, k)
    assert idx1.bf16_margin() == r1.bf16_margin()

    # delete old and new ids: bf16 fields kept, the old mask untouched
    dead = [0, 17, 461, idx1.next_id - 1]
    old_valid_dev, old_valid = idx1._device.valid.clone(), idx1.valid.copy()
    bf16_1, eps1 = idx1._bf16, idx1._bf16_eps
    idx2, ms = delete(idx1, dead)
    r2, r_ms = r_delete(r1, dead)
    _assert_same_index(idx2, r2)
    _assert_same_stats(ms, r_ms)
    assert idx2.tombstones == len(dead) and ms.table_dists == 0
    assert idx2._bf16 is bf16_1 and idx2._bf16_eps == eps1
    assert torch.equal(idx1._device.valid, old_valid_dev)
    np.testing.assert_array_equal(idx1.valid, old_valid)
    assert idx2._device.valid is not idx1._device.valid
    assert torch.equal(idx2._device.valid, torch.from_numpy(idx2.valid))
    assert idx2._device.data is idx1._device.data
    hits = _check_all_paths(idx2, r2, q, t, k)
    assert not set(dead) & {h for row in hits for h in row}

    # compact == fresh build over the live rows, and == the reference's compact
    ids, rows = _live_rows_by_id(idx2)
    idx3, ms = compact(idx2)
    r3, r_ms = r_compact(r2)
    _assert_same_index(idx3, r3)
    _assert_same_stats(ms, r_ms)
    assert ms.refreshed_pivots and idx3.tombstones == 0 and idx3.generation == 3
    assert idx3._device is None and idx3._bf16 is None and idx3._bf16_eps is None
    fresh = flat_index._build_engine_index(
        metric, rows, n_pivots=idx2.pivots.shape[0], n_pairs=idx2.pairs.shape[0],
        block=idx2.block, seed=idx2.seed, device=torch.device("cpu"))
    for f in ("data", "pivots", "pairs", "deltas", "boxes", "valid"):
        np.testing.assert_array_equal(getattr(idx3, f), getattr(fresh, f), err_msg=f)
    mapped = np.where(fresh.perm >= 0, ids[np.clip(fresh.perm, 0, len(ids) - 1)], -1)
    np.testing.assert_array_equal(idx3.perm, mapped)
    _check_all_paths(idx3, r3, q, t, k)
    # and the hits of the fresh build, mapped to original ids
    fresh_hits, _ = flat_index.bss_query_batched(fresh, q, t)
    assert flat_index.bss_query_batched(idx3, q, t)[0] == [
        [int(ids[h]) for h in row] for row in fresh_hits]


@pytest.mark.parametrize("refresh", [False, True])
def test_compact_without_device_mirror_matches_reference(refresh):
    db = _space("jsd", 300, 7, seed=21)
    idx = flat_index.build_bss("jsd", db, n_pivots=6, n_pairs=8, block=32, device="cpu")
    r_idx = r_flat.build_bss("jsd", db, n_pivots=6, n_pairs=8, block=32)
    idx1, _ = delete(idx, list(range(0, 300, 3)))
    r1, _ = r_delete(r_idx, list(range(0, 300, 3)))
    assert idx1._device is None  # no mirror was ever built
    idx2, ms = compact(idx1, refresh_pivots=refresh)
    r2, r_ms = r_compact(r1, refresh_pivots=refresh)
    _assert_same_index(idx2, r2)
    _assert_same_stats(ms, r_ms)
    q = _space("jsd", 9, 7, seed=22)
    t = _snap(pairwise_np("jsd", q, db), 0.05)
    _check_all_paths(idx2, r2, q, t, 4)


def test_append_accounting_and_validation():
    db = _space("l2", 300, 8, seed=1)
    idx = flat_index.build_bss("l2", db, n_pivots=6, n_pairs=8, block=64, seed=2,
                               device="cpu")
    more = _space("l2", 33, 8, seed=3)
    idx1, ms = append(idx, more)
    assert isinstance(ms, MutationStats)
    assert ms.table_dists == 33 * 6
    assert ms.new_blocks == idx1.n_blocks - idx.n_blocks
    assert idx1._device is None and idx1._bf16 is None  # nothing to extend
    with pytest.raises(ValueError):
        append(idx, np.zeros((0, 8), np.float32))
    with pytest.raises(ValueError):
        append(idx, _space("l2", 4, 9, seed=4))  # wrong dim


def test_delete_validation():
    db = _space("l2", 200, 8, seed=5)
    idx = flat_index.build_bss("l2", db, n_pivots=6, n_pairs=8, block=64, device="cpu")
    with pytest.raises(ValueError):
        delete(idx, [])
    with pytest.raises(ValueError):
        delete(idx, [3, 3])
    with pytest.raises(ValueError):
        delete(idx, [200])  # never existed
    idx1, _ = delete(idx, [7])
    with pytest.raises(ValueError):
        delete(idx1, [7])  # already dead
    with pytest.raises(ValueError):
        compact(dataclasses.replace(idx, valid=np.zeros_like(idx.valid)))


def test_maybe_compact_thresholds_match_reference():
    db = _space("l2", 256, 8, seed=6)
    idx = flat_index.build_bss("l2", db, n_pivots=6, n_pairs=8, block=32, device="cpu")
    r_idx = r_flat.build_bss("l2", db, n_pivots=6, n_pairs=8, block=32)
    same, ms = maybe_compact(idx)
    assert same is idx and ms is None
    idx1, _ = delete(idx, list(range(80)))
    r1, _ = r_delete(r_idx, list(range(80)))
    idx2, ms = maybe_compact(idx1)
    r2, r_ms = r_maybe_compact(r1)
    assert ms.op == "compact" and idx2.tombstones == 0
    assert idx2.generation == idx1.generation + 1
    _assert_same_index(idx2, r2)
    _assert_same_stats(ms, r_ms)
    for rate, refreshed in ((0.1, True), (0.9, False)):
        got, ms = maybe_compact(idx1, block_exclusion_rate=rate, refresh_pivots=None)
        want, r_ms = r_maybe_compact(r1, block_exclusion_rate=rate, refresh_pivots=None)
        assert ms.refreshed_pivots is refreshed
        _assert_same_index(got, want)
        _assert_same_stats(ms, r_ms)


def test_generation_stamped_in_engine_stats():
    db = _space("jsd", 200, 6, seed=7)
    q = _space("jsd", 5, 6, seed=8)
    idx = flat_index.build_bss("jsd", db, n_pivots=6, n_pairs=8, block=32, device="cpu")
    idx1, _ = append(idx, _space("jsd", 20, 6, seed=9))
    for opts in (EngineOpts(), _BF16):
        _, st = flat_index.bss_query_batched(idx1, q, 0.1, opts=opts)
        assert st["generation"] == 1
        _, _, ks = flat_index.bss_knn_batched(idx1, q, 3, opts=opts)
        assert ks["generation"] == 1
    _, so = flat_index.bss_query(idx1, q, 0.1)
    assert so["generation"] == 1
