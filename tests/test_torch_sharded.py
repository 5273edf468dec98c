"""The port's sharded BSS engine (``repro_torch.parallel``) against the
port's single-device engine and the JAX package, on the CPU.

Shards are repeated ``"cpu"`` devices of a ``ShardMesh`` (1, 2, 4 and 8
shards).  The cases are the reference's matrix (``tests/
test_sharded_bss.py``: l2, cosine and JSD) plus Triangular, each with a
block count that no shard count above 1 divides, so the padding blocks are
always there.

* Against the port's single-device ``"torch"`` engine: hits, ``alive``,
  per-query counts, ``excluded``, kNN ids, distances and rounds bit for bit.
* Against JAX's single-device jnp engine (both pinned to
  ``realisation="dense"``, as the reference pins ``_DENSE_ALIVE_FRAC``):
  hits, counts, ids and rounds exact, distances within 1e-5, the bound
  ``tests/test_torch_knn.py`` holds the single-device engines to (torch
  and XLA sum a distance in another order; the sharded engine itself is
  bit-equal to the port's single device).  Thresholds
  are snapped to gaps of the float64 distances (``safe_threshold``), so
  float32 and float64 agree on every ``d <= t``.
* Against JAX's ``ShardedBSSIndex``: in process on a one-device mesh, and
  on 4 simulated devices (``tests/multidevice_shim.py``), whose per-shard
  work vectors and registry entries the port's 4-shard run must equal.
* The reference's edge cases, bf16 equal to fp32, the mesh rules, and
  serving over a mesh.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from multidevice_shim import run_simulated_mesh
from repro.core import flat_index as r_flat
from repro.core.backends import EngineOpts as REngineOpts
from repro.core.npdist import pairwise_np
from repro.parallel.shard_index import (
    ShardedBSSIndex as RShardedBSSIndex,
    sharded_knn_batched as r_sharded_knn,
    sharded_query_batched as r_sharded_query,
)
from repro_torch.core import flat_index as t_flat
from repro_torch.core.backends import EngineOpts
from repro_torch.obs import MetricsRegistry, fold_engine_stats, shard_imbalance
from repro_torch.parallel import ShardMesh, dp_axes, local_mesh, shard_devices
from repro_torch.parallel import shard_index
from repro_torch.parallel.shard_index import (
    ShardedBSSIndex,
    sharded_knn_batched,
    sharded_lower_bounds,
    sharded_query_batched,
)
from test_torch_bss_engine import _space, safe_threshold

N_PIVOTS = 8
TORCH = EngineOpts(backend="torch", realisation="dense")
TORCH16 = EngineOpts(backend="torch", realisation="dense", precision="bf16")
JNP = REngineOpts(backend="jnp", realisation="dense")
KNN_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_knn.py
SHARDS = (1, 2, 4, 8)

# tests/test_sharded_bss.py:_MATRIX, plus Triangular: metric, n, dim,
# block, nq, k; 11, 5, 11 and 7 blocks
CASES = [
    ("l2", 700, 12, 64, 23, 7),
    ("cosine", 513, 9, 128, 17, 5),
    ("jsd", 330, 11, 32, 11, 4),
    ("triangular", 420, 9, 64, 13, 6),
]
CASE_IDS = [c[0] for c in CASES]


def cpu_mesh(n: int) -> ShardMesh:
    return ShardMesh(("cpu",) * n)


def _built(metric, n, dim, block, nq, k):
    """(JAX index, port index on the CPU, queries, threshold) of a case;
    the port queries the very index JAX built."""
    data = _space(metric, n + nq, dim, seed=n)
    db, q = data[:n], data[n:]
    r_idx = r_flat.build_bss(metric, db, n_pivots=N_PIVOTS, n_pairs=10, block=block, seed=1)
    assert r_idx.n_blocks % 2, (metric, r_idx.n_blocks)  # the padding is exercised
    t_idx = t_flat.index_from_arrays(
        {f: getattr(r_idx, f) for f in t_flat.INDEX_FIELDS}, device="cpu")
    t = safe_threshold(pairwise_np(metric, q, db), 0.02)
    return r_idx, t_idx, q, t


def _alive(index, q, t, *, sharded=None, bq=8):
    """(Q, n_blocks) survival of the port's range pass: the sharded pass's
    merged mask over the real blocks, or the single-device pass's."""
    queries = t_flat._engine_queries(index.metric_name, q)
    t_vec = np.full(len(q), t, np.float32)
    metric = t_flat._engine_metric(index.metric_name)
    if sharded is not None:
        _, alive, _, _, _ = shard_index._range_pass(sharded, metric, queries, t_vec, bq=bq,
                                                    backend="torch")
        return alive[:, :index.n_blocks].numpy()
    _, alive, _ = t_flat._query_batched(metric, torch.from_numpy(queries),
                                        torch.from_numpy(t_vec), index.device,
                                        block=index.block, bq=bq, backend="torch")
    return alive.numpy()


def _assert_same_stats(got, want, *, skip=()):
    """Every key the single-device stats carry is equal in the sharded ones
    (bit for bit; arrays with their dtype), apart from ``engine``."""
    for key, w in want.items():
        if key in ("engine", *skip):
            continue
        g = got[key]
        if key == "excluded":
            for mech in w:
                assert g[mech].dtype == w[mech].dtype
                np.testing.assert_array_equal(g[mech], w[mech])
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key


def _assert_shard_work(stats, nq, n_shards):
    """One slot per shard, summing to the batch's exact-phase work."""
    sd, sb = stats["shard_dists"], stats["shard_blocks"]
    assert sd.shape == sb.shape == (n_shards,)
    assert sd.dtype == sb.dtype == np.int64
    n_pivots = int(stats["pivot_dists_per_query"])
    assert int(sd.sum()) == int(stats["per_query_dists"].sum()) - nq * n_pivots
    assert (sd >= 0).all() and (sb >= 0).all()


# ------------------------------------------- against the port's single device


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_equals_single_device_torch_bit_for_bit(case, n_shards):
    _, t_idx, q, t = _built(*case)
    k = case[-1]
    sidx = ShardedBSSIndex(t_idx, cpu_mesh(n_shards))
    assert sidx.n_blocks_pad % n_shards == 0 and sidx.n_blocks_pad >= t_idx.n_blocks
    hits, stats = sharded_query_batched(sidx, q, t, opts=TORCH)
    want_hits, want = t_flat.bss_query_batched(t_idx, q, t, opts=TORCH)
    assert hits == want_hits
    _assert_same_stats(stats, want)
    assert stats["engine"] == "sharded" and stats["n_shards"] == n_shards
    _assert_shard_work(stats, len(q), n_shards)
    np.testing.assert_array_equal(_alive(t_idx, q, t, sharded=sidx), _alive(t_idx, q, t))
    np.testing.assert_array_equal(sharded_lower_bounds(sidx, q),
                                  t_flat.bss_lower_bounds(t_idx, q))
    ids, dists, kst = sharded_knn_batched(sidx, q, k, opts=TORCH)
    w_ids, w_dists, w_kst = t_flat.bss_knn_batched(t_idx, q, k, opts=TORCH)
    np.testing.assert_array_equal(ids, w_ids)
    np.testing.assert_array_equal(dists, w_dists)
    _assert_same_stats(kst, w_kst)
    _assert_shard_work(kst, len(q), n_shards)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_bf16_equals_fp32(case, n_shards):
    """bf16 range and kNN equal the sharded fp32 run in every field; the
    re-check telemetry equals the single-device bf16 run's."""
    _, t_idx, q, t = _built(*case)
    k = case[-1]
    sidx = ShardedBSSIndex(t_idx, cpu_mesh(n_shards))
    h32, s32 = sharded_query_batched(sidx, q, t, opts=TORCH)
    h16, s16 = sharded_query_batched(sidx, q, t, opts=TORCH16)
    assert h16 == h32
    _assert_same_stats(s16, s32, skip=("precision",))
    assert s16["precision"] == "bf16"
    _, w16 = t_flat.bss_query_batched(t_idx, q, t, opts=TORCH16)
    _assert_same_stats(s16, w16)
    k32 = sharded_knn_batched(sidx, q, k, opts=TORCH)
    k16 = sharded_knn_batched(sidx, q, k, opts=TORCH16)
    np.testing.assert_array_equal(k16[0], k32[0])
    np.testing.assert_array_equal(k16[1], k32[1])
    _assert_same_stats(k16[2], k32[2], skip=("precision",))
    _assert_same_stats(k16[2], t_flat.bss_knn_batched(t_idx, q, k, opts=TORCH16)[2])
    # the lazy per-shard mirror holds the host-rounded bits
    rows = sidx.rows_per_shard
    for s, d16 in enumerate(sidx.data16):
        np.testing.assert_array_equal(
            d16.float().numpy(), t_flat.bf16_round_np(sidx._host_data[s * rows:(s + 1) * rows]))


# ------------------------------------------------------------- against JAX


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_matches_jax_single_device_jnp(case):
    """The reference's matrix: every shard count against JAX's
    single-device jnp engine and the float64 oracle."""
    r_idx, t_idx, q, t = _built(*case)
    k = case[-1]
    oracle, so = r_flat.bss_query(r_idx, q, t)
    r_hits, rs = r_flat.bss_query_batched(r_idx, q, t, opts=JNP)
    r_ids, r_dists, r_ks = r_flat.bss_knn_batched(r_idx, q, k, opts=JNP)
    r_alive = np.asarray(r_flat._query_batched_jit(
        r_flat._engine_metric(r_idx.metric_name),
        jax.numpy.asarray(r_flat._engine_queries(r_idx.metric_name, q)),
        jax.numpy.full(len(q), t, np.float32), r_idx.device, block=r_idx.block, bq=8,
        backend="jnp", interpret=False)[1])
    for n_shards in SHARDS:
        sidx = ShardedBSSIndex(t_idx, cpu_mesh(n_shards))
        hits, st = sharded_query_batched(sidx, q, t, opts=TORCH)
        assert hits == oracle == r_hits, n_shards
        np.testing.assert_array_equal(st["per_query_dists"], rs["per_query_dists"])
        np.testing.assert_array_equal(st["per_query_dists"], so["per_query_dists"])
        np.testing.assert_array_equal(st["excluded"]["hilbert"], rs["excluded"]["hilbert"])
        assert st["tiles_computed"] == rs["tiles_computed"]
        np.testing.assert_array_equal(_alive(t_idx, q, t, sharded=sidx), r_alive)
        ids, dists, ks = sharded_knn_batched(sidx, q, k, opts=TORCH)
        np.testing.assert_array_equal(ids, r_ids)
        np.testing.assert_allclose(dists, r_dists, **KNN_TOL)
        assert ks["rounds"] == r_ks["rounds"], n_shards
        np.testing.assert_array_equal(ks["per_query_dists"], r_ks["per_query_dists"])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_one_shard_matches_jax_sharded_in_process(case):
    """JAX's ``ShardedBSSIndex`` on a one-device mesh and the port's on a
    one-shard mesh: hits, the stats and the per-shard work vectors."""
    r_idx, t_idx, q, t = _built(*case)
    k = case[-1]
    r_sidx = RShardedBSSIndex(r_idx, Mesh(np.array(jax.devices()[:1]), ("data",)))
    sidx = ShardedBSSIndex(t_idx, cpu_mesh(1))
    r_hits, rs = r_sharded_query(r_sidx, q, t, opts=REngineOpts(backend="jnp"))
    hits, st = sharded_query_batched(sidx, q, t, opts=TORCH)
    assert hits == r_hits
    _assert_same_stats(st, rs, skip=("backend",))
    r_ids, r_dists, r_ks = r_sharded_knn(r_sidx, q, k, opts=REngineOpts(backend="jnp"))
    ids, dists, ks = sharded_knn_batched(sidx, q, k, opts=TORCH)
    np.testing.assert_array_equal(ids, r_ids)
    np.testing.assert_allclose(dists, r_dists, **KNN_TOL)
    _assert_same_stats(ks, r_ks, skip=("backend",))
    assert (sidx.n_blocks_pad, sidx.rows_per_shard) == (r_sidx.n_blocks_pad, r_sidx.rows_per_shard)
    np.testing.assert_array_equal(sidx.perm, r_sidx.perm)


_JAX_FOUR = """
    import json, sys
    import numpy as np, jax
    from jax.sharding import Mesh
    from repro.core import flat_index
    from repro.core.backends import EngineOpts
    from repro.obs import MetricsRegistry, fold_engine_stats
    from repro.parallel.shard_index import (
        ShardedBSSIndex, sharded_query_batched, sharded_knn_batched,
    )

    flat_index._DENSE_ALIVE_FRAC = -1.0
    data = np.load(sys.argv[1])
    idx = flat_index.build_bss("l2", data["db"], n_pivots=8, n_pairs=10,
                               block=64, seed=1)
    sidx = ShardedBSSIndex(idx, Mesh(np.array(jax.devices()[:4]), ("data",)))
    jnp_ = EngineOpts(backend="jnp")
    hits, st = sharded_query_batched(sidx, data["q"], float(data["t"]), opts=jnp_)
    ids, dists, ks = sharded_knn_batched(sidx, data["q"], 6, opts=jnp_)
    reg = MetricsRegistry()
    fold_engine_stats(reg, st)
    fold_engine_stats(reg, ks)
    snap = reg.snapshot()
    out = dict(
        hits=hits, ids=ids.tolist(), rounds=int(ks["rounds"]),
        per_query=st["per_query_dists"].tolist(),
        shard_dists=np.asarray(st["shard_dists"]).tolist(),
        shard_blocks=np.asarray(st["shard_blocks"]).tolist(),
        knn_shard_dists=np.asarray(ks["shard_dists"]).tolist(),
        knn_shard_blocks=np.asarray(ks["shard_blocks"]).tolist(),
        counters={k: v for k, v in snap["counters"].items() if k.startswith("shard/")},
        gauges={k: v for k, v in snap["gauges"].items() if k.startswith("shard/")},
        n_blocks_pad=sidx.n_blocks_pad,
    )
    with open(sys.argv[2], "w") as f:
        json.dump(out, f)
    print("JAX_FOUR_OK")
"""


def test_four_shards_match_jax_on_four_simulated_devices(tmp_path):
    """JAX's ``ShardedBSSIndex`` on 4 simulated devices (a subprocess) and
    the port's on 4 CPU shards of the same index: hits, kNN ids, rounds,
    ``shard_dists`` / ``shard_blocks`` of range and kNN, and the registry's
    ``shard/*`` counters and gauge after ``fold_engine_stats``."""
    data = _space("l2", 723, 12, seed=700)
    db, q = data[:700], data[700:]
    t = safe_threshold(pairwise_np("l2", q, db), 0.02)
    inp, out = tmp_path / "in.npz", tmp_path / "out.json"
    np.savez(inp, db=db, q=q, t=np.float64(t))
    proc = run_simulated_mesh(_JAX_FOUR, 4, str(inp), str(out))
    assert "JAX_FOUR_OK" in proc.stdout, proc.stdout + proc.stderr
    want = json.loads(out.read_text())
    r_idx = r_flat.build_bss("l2", db, n_pivots=N_PIVOTS, n_pairs=10, block=64, seed=1)
    t_idx = t_flat.index_from_arrays(
        {f: getattr(r_idx, f) for f in t_flat.INDEX_FIELDS}, device="cpu", mesh=cpu_mesh(4))
    assert t_idx.sharded().n_blocks_pad == want["n_blocks_pad"]
    hits, st = t_flat.bss_query_batched(t_idx, q, t, opts=TORCH)
    ids, _, ks = t_flat.bss_knn_batched(t_idx, q, 6, opts=TORCH)
    assert hits == want["hits"]
    assert ids.tolist() == want["ids"] and ks["rounds"] == want["rounds"]
    assert st["per_query_dists"].tolist() == want["per_query"]
    assert st["shard_dists"].tolist() == want["shard_dists"]
    assert st["shard_blocks"].tolist() == want["shard_blocks"]
    assert ks["shard_dists"].tolist() == want["knn_shard_dists"]
    assert ks["shard_blocks"].tolist() == want["knn_shard_blocks"]
    reg = MetricsRegistry()
    fold_engine_stats(reg, st)
    fold_engine_stats(reg, ks)
    snap = reg.snapshot()
    assert {k: v for k, v in snap["counters"].items() if k.startswith("shard/")} == want["counters"]
    assert {k: v for k, v in snap["gauges"].items() if k.startswith("shard/")} == want["gauges"]
    g = snap["gauges"]["shard/imbalance{engine=sharded,kind=range}"]
    assert g == shard_imbalance(st["shard_dists"]) >= 1.0
    assert "shard/imbalance" in reg.render()


# ------------------------------------------------------------------- edges


def _edge_index(mesh=None):
    db = _space("l2", 50, 6, seed=7)  # 2 blocks of 32
    q = _space("l2", 5, 6, seed=8)
    idx = t_flat.build_bss("l2", db, n_pivots=4, n_pairs=4, block=32, seed=3, device="cpu",
                           mesh=mesh)
    return db, q, idx


def test_edges_more_shards_than_blocks_and_k_above_rows():
    """tests/test_sharded_bss.py:_EDGES on the port: 2 blocks on 8 shards;
    k = 60 above ``n_valid`` (50) and ``rows_per_shard`` (32)."""
    db, q, idx = _edge_index(cpu_mesh(8))
    sidx = idx.sharded()
    assert sidx.n_blocks_pad == 8 and sidx.rows_per_shard == 32
    truth = pairwise_np("l2", q, db)
    _, _, plain = _edge_index()
    for opts in (TORCH, TORCH16):
        ki, kd, kst = t_flat.bss_knn_batched(idx, q, 60, opts=opts)
        assert ki.shape == (5, 60) and kst["n_shards"] == 8
        assert (ki[:, :50] >= 0).all() and (ki[:, 50:] == -1).all()
        assert np.isinf(kd[:, 50:]).all()
        for i in range(5):
            assert set(ki[i, :50].tolist()) == set(range(50))
            np.testing.assert_allclose(kd[i, :50], np.sort(truth[i]), rtol=1e-5, atol=1e-5)
        want = t_flat.bss_knn_batched(plain, q, 60, opts=opts)
        np.testing.assert_array_equal(ki, want[0])
        np.testing.assert_array_equal(kd, want[1])
        _assert_same_stats(kst, want[2])


def test_edges_whole_space_range_and_empty_batches():
    db, q, idx = _edge_index(cpu_mesh(8))
    t_all = float(pairwise_np("l2", q, db).max() * 2.0)
    for opts in (TORCH, TORCH16):
        hits, st = t_flat.bss_query_batched(idx, q, t_all, opts=opts)
        assert all(sorted(r) == list(range(50)) for r in hits)
        assert st["block_exclusion_rate"] == 0.0
        _assert_shard_work(st, len(q), 8)
        h0, s0 = t_flat.bss_query_batched(idx, np.zeros((0, 6), np.float32), 1.0, opts=opts)
        assert h0 == [] and s0["n_shards"] == 8 and s0["engine"] == "sharded"
        assert s0["shard_dists"].tolist() == [0] * 8
        k0, d0, ks0 = t_flat.bss_knn_batched(idx, np.zeros((0, 6), np.float32), 3, opts=opts)
        assert k0.shape == (0, 3) and d0.shape == (0, 3) and ks0["rounds"] == 0
        assert ks0["n_shards"] == 8 and ks0["precision"] == opts.precision
    with pytest.raises(ValueError, match="k must be positive"):
        t_flat.bss_knn_batched(idx, q, 0)


@pytest.mark.parametrize("r0", [1e-6, 100.0])
def test_edges_explicit_r0_too_tight_and_too_wide(r0):
    """The serving layer's ``t0_guess``: the sharded run equals the
    single-device run under the same r0, and JAX's."""
    db, q, idx = _edge_index(cpu_mesh(8))
    _, _, plain = _edge_index()
    got = t_flat.bss_knn_batched(idx, q, 5, r0=r0, opts=TORCH)
    want = t_flat.bss_knn_batched(plain, q, 5, r0=r0, opts=TORCH)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    _assert_same_stats(got[2], want[2])
    r_idx = r_flat.build_bss("l2", db, n_pivots=4, n_pairs=4, block=32, seed=3)
    r_ids, _, r_st = r_flat.bss_knn_batched(r_idx, q, 5, r0=r0, opts=JNP)
    np.testing.assert_array_equal(got[0], r_ids)
    assert got[2]["rounds"] == r_st["rounds"]
    np.testing.assert_array_equal(got[2]["per_query_dists"], r_st["per_query_dists"])


def test_per_query_radii_with_padding_rows():
    """The front's mixed-threshold batches: a (Q,) radius vector, -1 on
    padding rows, which hit nothing and are charged only the pivots."""
    _, t_idx, q, t = _built(*CASES[0])
    t_vec = np.where(np.arange(len(q)) % 3 == 2, -1.0, t).astype(np.float32)
    sidx = ShardedBSSIndex(t_idx, cpu_mesh(4))
    hits, st = sharded_query_batched(sidx, q, t_vec, opts=TORCH)
    want_hits, want = t_flat.bss_query_batched(t_idx, q, t_vec, opts=TORCH)
    assert hits == want_hits
    _assert_same_stats(st, want)
    pad = t_vec < 0
    assert all(not hits[i] for i in np.nonzero(pad)[0])
    np.testing.assert_array_equal(st["per_query_dists"][pad], N_PIVOTS)


# --------------------------------------------------------------- mesh rules


def test_mesh_validation_errors():
    _, _, idx = _edge_index()
    with pytest.raises(ValueError, match="data axis"):
        ShardedBSSIndex(idx, ShardMesh(("cpu",), axis_names=("model",)))
    with pytest.raises(ValueError, match="data axis"):
        t_flat.build_bss("l2", idx.data[:40], n_pivots=4, n_pairs=4, block=32,
                         mesh=ShardMesh(("cpu",), axis_names=("model",)))
    with pytest.raises(ValueError, match="no mesh"):
        idx.sharded()
    with pytest.raises(ValueError, match="mixes device types"):
        ShardMesh(("cpu", "cuda:0"))
    with pytest.raises(ValueError, match="holds"):
        ShardMesh(("cpu",) * 3, axis_names=("data", "model"), shape=(2, 1))
    with pytest.raises(ValueError, match="needs its shape"):
        ShardMesh(("cpu",) * 2, axis_names=("pod", "data"))
    with pytest.raises(TypeError, match="ShardMesh"):
        t_flat.build_bss("l2", idx.data[:40], n_pivots=4, n_pairs=4, block=32, mesh=object())
    with pytest.raises(ValueError, match="lead device"):
        t_flat.build_bss("l2", idx.data[:40], n_pivots=4, n_pairs=4, block=32,
                         device="meta", mesh=cpu_mesh(2))


def test_model_axis_of_size_one_and_pod_data_order():
    """``make_local_mesh``'s ("data", "model") with model 1 is accepted; a
    ("pod", "data") mesh partitions over the product, shard pod * |data| +
    data, whatever order the axes are listed in."""
    mesh = ShardMesh(("cpu",) * 4, axis_names=("data", "model"), shape=(4, 1))
    assert dp_axes(mesh) == ("data",)
    devs = tuple(torch.device("cpu", i) for i in range(6))
    pd = ShardMesh(devs, axis_names=("pod", "data"), shape=(2, 3))
    assert shard_devices(pd) == devs
    dp = ShardMesh(devs, axis_names=("data", "pod"), shape=(3, 2))
    # device (data=d, pod=p) is listed at d * 2 + p; shard p * 3 + d holds it
    assert shard_devices(dp) == tuple(devs[d * 2 + p] for p in range(2) for d in range(3))
    _, t_idx, q, t = _built(*CASES[0])
    want_hits, want = t_flat.bss_query_batched(t_idx, q, t, opts=TORCH)
    for m in (mesh, ShardMesh(("cpu",) * 4, axis_names=("pod", "data", "model"),
                              shape=(2, 2, 1))):
        hits, st = sharded_query_batched(ShardedBSSIndex(t_idx, m), q, t, opts=TORCH)
        assert hits == want_hits and st["n_shards"] == 4
        _assert_same_stats(st, want)


@pytest.mark.parametrize("case", CASES[:2], ids=CASE_IDS[:2])
def test_model_axis_replicates_bit_for_bit(case):
    """A ``(2, 2)`` ("data", "model") mesh partitions the blocks over the
    data axis alone and replicates over "model", as the reference's
    ``ShardedBSSIndex`` does (it reads only ``dp_axes``): range hits, every
    stat, ``alive``, kNN ids and distances equal the ``(2, 1)`` mesh's bit
    for bit."""
    _, t_idx, q, t = _built(*case)
    k = case[-1]
    out = {}
    for shape in ((2, 2), (2, 1)):
        mesh = ShardMesh(("cpu",) * (shape[0] * shape[1]), axis_names=("data", "model"),
                         shape=shape)
        sidx = ShardedBSSIndex(t_idx, mesh)
        assert sidx.n_shards == 2
        hits, st = sharded_query_batched(sidx, q, t, opts=TORCH)
        ids, dists, kst = sharded_knn_batched(sidx, q, k, opts=TORCH)
        out[shape] = (hits, st, _alive(t_idx, q, t, sharded=sidx), ids, dists, kst)
    a, b = out[(2, 2)], out[(2, 1)]
    assert a[0] == b[0]
    _assert_same_stats(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])
    np.testing.assert_array_equal(a[3], b[3])
    assert np.asarray(a[4]).tobytes() == np.asarray(b[4]).tobytes()
    _assert_same_stats(a[5], b[5])


def test_local_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        local_mesh(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    mesh = local_mesh(4)
    assert mesh.devices == (torch.device("cuda", 0),) * 4 and mesh.lead == torch.device("cuda", 0)
    assert local_mesh().devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="positive"):
        local_mesh(0)


def test_mesh_index_never_builds_the_unsharded_mirror():
    """The batched paths and the oracle of a mesh-built index read the
    shards only; ``index.device`` builds an unsharded copy on the lead
    device when a caller asks, equal to a meshless index's."""
    db, q, idx = _edge_index(cpu_mesh(4))
    _, _, plain = _edge_index()
    t = safe_threshold(pairwise_np("l2", q, db), 0.3)
    t_flat.bss_query_batched(idx, q, t)
    t_flat.bss_query_batched(idx, q, t, opts=EngineOpts(precision="bf16"))
    t_flat.bss_knn_batched(idx, q, 3)
    t_flat.bss_knn_batched(idx, q, 3, opts=EngineOpts(precision="bf16"))
    assert t_flat.bss_query(idx, q, t)[0] == t_flat.bss_query(plain, q, t)[0]
    assert idx._device is None and idx._bf16 is None
    assert idx.torch_device == idx.mesh.lead
    assert all(torch.equal(a, b) for a, b in zip(idx.device, plain.device))
    assert idx.sharded() is idx.sharded()
    other = cpu_mesh(2)
    assert idx.sharded(other).n_shards == 2 and idx.sharded(other).mesh == other


# ---------------------------------------------------------------- serving


def _serving_corpus():
    rng = np.random.default_rng(11)
    centres = rng.normal(size=(16, 24))
    corpus = centres[rng.integers(0, 16, size=900)] + 0.15 * rng.normal(size=(900, 24))
    users = centres[rng.integers(0, 16, size=31)] + 0.15 * rng.normal(size=(31, 24))
    return corpus.astype(np.float32), users.astype(np.float32)


def test_retrieval_server_on_a_mesh():
    """tests/test_sharded_bss.py:_SERVER on the port: ``RetrievalServer(
    mesh=)`` equals the meshless server and the float64 oracle."""
    from repro_torch.serve.retrieval import RetrievalServer

    corpus, users = _serving_corpus()
    mesh = cpu_mesh(4)
    srv = RetrievalServer(corpus, metric="cosine", block=64, mesh=mesh, opts=TORCH)
    plain = RetrievalServer(corpus, metric="cosine", block=64, device="cpu", opts=TORCH)
    assert srv.index.mesh is mesh
    got, want, ref = srv.top_k(users, k=8), srv.top_k_oracle(users, k=8), plain.top_k(users, k=8)
    for g, w, r in zip(got, want, ref):
        assert set(g.tolist()) == set(w.tolist()) == set(r.tolist())
        np.testing.assert_array_equal(g, r)
    hits = srv.range_query(users, min_score=0.6)
    assert hits == plain.range_query(users, min_score=0.6)
    assert srv.stats.dists_per_query == plain.stats.dists_per_query
    res = srv.search(users, "knn", k=4)
    assert res.stats["engine"] == "sharded" and res.stats["n_shards"] == 4
    snap = srv.metrics.snapshot()
    assert any(k.startswith("shard/dists{engine=sharded,kind=knn") for k in snap["counters"])


def test_front_over_a_mesh_built_index_equals_direct_sharded_calls():
    """tests/test_async_front.py:_MESH_FRONT on the port: an interleaved
    mixed-threshold range and kNN stream through the front over a
    4-shard index; each batch the front formed equals a direct sharded
    call on it, every field; ``explain`` and the registry carry the
    per-shard work vectors."""
    from test_torch_async_front import _assert_direct, _serve

    rng = np.random.default_rng(7)
    x = rng.random((1400, 12)).astype(np.float32)
    db, q = x[:1376], x[1376:]
    idx = t_flat.build_bss("l2", db, n_pivots=8, n_pairs=10, block=64, seed=9,
                           mesh=cpu_mesh(4))
    d = pairwise_np("l2", q, db)
    t1, t2 = safe_threshold(d, 0.02), safe_threshold(d, 0.05)
    reqs = [("knn", 3) if i % 3 == 1 else ("range", t1 if i % 3 else t2) for i in range(len(q))]
    res, stats, front = _serve(idx, q, reqs, opts=TORCH)
    assert stats["completed"] == len(q) and stats["errors"] == 0
    _assert_direct(idx, q, reqs, res, (8, 32), opts=TORCH)
    rec = front.explain()
    assert len(rec["shard_dists"]) == 4 and len(rec["shard_blocks"]) == 4
    assert rec["shard_imbalance"] == shard_imbalance(rec["shard_dists"]) >= 1.0
    snap = front.metrics().snapshot()
    for kind in ("range", "knn"):
        assert f"shard/imbalance{{engine=sharded,kind={kind}}}" in snap["gauges"]
        assert sum(v for k, v in snap["counters"].items()
                   if k.startswith(f"shard/dists{{engine=sharded,kind={kind},")) > 0
    # the rows again in one direct sharded call each: the same hits and ids
    r_rows = [i for i in range(len(q)) if reqs[i][0] == "range"]
    ref, rs = t_flat.bss_query_batched(
        idx, q[r_rows], np.array([reqs[i][1] for i in r_rows], np.float32), opts=TORCH)
    assert rs["n_shards"] == 4
    assert [res[i].hits for i in r_rows] == ref
    np.testing.assert_array_equal([res[i].n_dists for i in r_rows], rs["per_query_dists"])
    k_rows = [i for i in range(len(q)) if reqs[i][0] == "knn"]
    ki, kd, _ = t_flat.bss_knn_batched(idx, q[k_rows], 3, opts=TORCH)
    np.testing.assert_array_equal(np.stack([res[i].indices for i in k_rows]), ki)
    np.testing.assert_array_equal(np.stack([res[i].distances for i in k_rows]), kd)
