"""The range epilogue (``flat_index._range_epilogue``) against a pinned copy
of the host epilogue it replaced, on the CPU.

The epilogue reduces the hit counts and the paper's stats where the pass's
masks live, reads them with the hit positions in one copy, and cuts the hit
lists out of one flat list.  Each case records the epilogue's inputs (the
hit mask or a gathered pass's hit list, ``alive``, ``tile_mask``, bf16's
re-check telemetry, the sharded engine's padded survival) and holds the
returned hit lists and every stats key, value and dtype, to what the pinned
numpy code below computes from those very inputs.  The hit lists of every
realisation and precision are also held to the dense fp32 pass's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import flat_index
from repro_torch.core.backends import EngineOpts
from repro_torch.index import append, delete
from repro_torch.obs import schema as obs_schema
from repro_torch.parallel import ShardMesh, shard_index
from repro_torch.parallel.shard_index import ShardedBSSIndex

BUILD = dict(n_pivots=8, n_pairs=10, block=64, seed=5)
BQ = 8
N_QUERIES = 40
N_PADDING = 6  # per-query radii: the last rows are the front's padding (t < 0)


# --------------------------------------------------------------------------
# the host epilogue as it was, pinned


def _pinned_stats(index, alive: np.ndarray, tile_mask: np.ndarray) -> dict:
    n_pivots = index.pivots.shape[0]
    valid_per_block = index.valid.reshape(index.n_blocks, index.block).sum(axis=1)
    exact = alive.astype(np.int64) @ valid_per_block
    mean_exact = float(exact.mean()) if exact.size else 0.0
    return {
        "pivot_dists_per_query": float(n_pivots),
        "exact_dists_per_query": mean_exact,
        "dists_per_query": float(n_pivots) + mean_exact,
        "per_query_dists": n_pivots + exact,
        "block_exclusion_rate": float(1.0 - alive.mean()) if alive.size else 1.0,
        "tiles_computed": int(tile_mask.sum()),
        "tile_exclusion_rate": (
            float(1.0 - tile_mask.mean()) if tile_mask.size else 1.0
        ),
        "n_blocks": int(index.n_blocks),
        "generation": int(index.generation),
        "excluded": {
            "hilbert": (index.n_blocks - alive.sum(axis=1)).astype(np.int64),
        },
    }


def _pinned_bf16(stats: dict, eps: float, recheck_tiles: int, per_query_recheck) -> None:
    stats["precision"] = "bf16"
    stats["band_eps"] = float(eps)
    stats["recheck_tiles"] = int(recheck_tiles)
    stats["per_query_recheck"] = np.asarray(per_query_recheck, np.int64)
    stats["recheck_points_per_query"] = (
        float(stats["per_query_recheck"].mean())
        if stats["per_query_recheck"].size else 0.0
    )


def _pinned_shard_work(sidx, alive_pad: np.ndarray):
    nq = alive_pad.shape[0]
    vpb = sidx._valid.reshape(sidx.n_blocks_pad, sidx.index.block).sum(axis=1)
    vpb = vpb.reshape(sidx.n_shards, sidx.blocks_per_shard)
    alive = alive_pad.reshape(nq, sidx.n_shards, sidx.blocks_per_shard)
    sdist = (alive * vpb[None]).sum(axis=(0, 2), dtype=np.int64)
    sblk = (alive & (vpb > 0)[None]).sum(axis=(0, 2), dtype=np.int64)
    return sdist, sblk


def _pinned_hit_lists(perm, hit_q, hit_pos, nq):
    if nq == 0:  # the zero-query path returned before any of this
        return []
    orig = perm[hit_pos]
    counts = np.bincount(hit_q, minlength=nq)
    return [r.tolist() for r in np.split(orig, np.cumsum(counts)[:-1])]


def _pinned_epilogue(seen: dict):
    """What the replaced host code returned for the recorded inputs."""
    call = seen["call"]
    index, hits, alive, tile_mask = call["args"]
    kw = call["kwargs"]
    alive = alive.numpy()
    nq = alive.shape[0]
    if isinstance(hits, torch.Tensor):
        pos = torch.nonzero(hits).numpy()
        hit_q, hit_pos = pos[:, 0], pos[:, 1]
    else:
        hit_q, hit_pos = hits[0].numpy(), hits[1].numpy()
    results = _pinned_hit_lists(kw["perm"], hit_q, hit_pos, nq)
    stats = _pinned_stats(index, alive, tile_mask.numpy())
    stats["precision"] = "fp32"
    if "shard" in seen:
        sidx, alive_pad = seen["shard"]
        stats["n_shards"] = sidx.n_shards
        sdist, sblk = _pinned_shard_work(sidx, alive_pad.numpy())
        stats["shard_dists"], stats["shard_blocks"] = sdist, sblk
    if kw.get("eps") is not None:
        _pinned_bf16(stats, kw["eps"], int(kw["recheck_tiles"]), kw["band_counts"].numpy())
    stats = obs_schema.normalise_stats(
        stats, engine=kw.get("engine", "bss"), kind="range", backend=kw["backend"],
        n_queries=nq, excluded=stats["excluded"])
    return results, stats


# --------------------------------------------------------------------------


def _same(a, b, where="stats") -> None:
    """Equal bit for bit: dict keys, array dtypes and values, scalar types."""
    if isinstance(b, dict):
        assert a.keys() == b.keys(), where
        for k in b:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(b, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.fixture(scope="module")
def space():
    """Points in the plane, where the bound prunes: the adaptive
    realisation gathers the alive cells at the narrow radius."""
    rng = np.random.default_rng(11)
    x = rng.random((1700 + N_QUERIES, 2)).astype(np.float32)
    corpus, q = x[:1700], x[1700:]
    d = np.sqrt(((q[:, None, :] - corpus[None]) ** 2).sum(-1))
    return corpus, q, float(np.quantile(d, 0.001))


@pytest.fixture(scope="module")
def index(space):
    return flat_index.build_bss("l2", space[0], device="cpu", **BUILD)


@pytest.fixture
def seen(monkeypatch):
    """The epilogue's inputs of the next call (and, sharded, the padded
    survival the shard work reads)."""
    rec: dict = {}
    epilogue = flat_index._range_epilogue
    shard_work = ShardedBSSIndex.shard_work

    def spy(*args, **kwargs):
        rec["call"] = {"args": args, "kwargs": kwargs}
        return epilogue(*args, **kwargs)

    def spy_work(self, alive_pad, vpb):
        rec["shard"] = (self, alive_pad)
        return shard_work(self, alive_pad, vpb)

    monkeypatch.setattr(flat_index, "_range_epilogue", spy)
    monkeypatch.setattr(shard_index, "_range_epilogue", spy)
    monkeypatch.setattr(ShardedBSSIndex, "shard_work", spy_work)
    return rec


def _radii(kind: str, t: float) -> float | np.ndarray:
    if kind == "scalar":
        return t
    if kind == "per_query":
        rng = np.random.default_rng(2)
        t_vec = (t * rng.uniform(0.5, 2.0, N_QUERIES)).astype(np.float32)
        t_vec[-N_PADDING:] = -1.0
        return t_vec
    if kind == "none_excluded":
        return 10.0  # beyond the unit square's diameter
    return -1.0  # "all_excluded": no block survives a negative radius


def _check(index, q, t, opts, seen):
    got_hits, got_stats = flat_index.bss_query_batched(index, q, t, opts=opts)
    want_hits, want_stats = _pinned_epilogue(seen)
    _same(got_hits, want_hits, "hits")
    _same(got_stats, want_stats)
    for hits in got_hits:
        assert all(type(i) is int for i in hits)
    call = seen.pop("call")
    dense, _ = flat_index.bss_query_batched(
        index, q, t, opts=EngineOpts(backend="torch", realisation="dense", bq=opts.bq))
    assert got_hits == dense
    return got_hits, got_stats, call


RADII = ("scalar", "per_query", "none_excluded", "all_excluded")


@pytest.mark.parametrize("radii", RADII)
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("real", ["dense", "adaptive"])
def test_epilogue_matches_the_pinned_host_code(index, space, seen, real, prec, radii):
    _, q, t = space
    t = _radii(radii, t)
    opts = EngineOpts(backend="torch", realisation=real, precision=prec, bq=BQ)
    hits, stats, call = _check(index, q, t, opts, seen)
    gathered = not isinstance(call["args"][1], torch.Tensor)
    # the narrow radii leave few cells alive: the adaptive pass gathers them
    assert gathered == (real == "adaptive" and radii in ("scalar", "per_query",
                                                         "all_excluded"))
    if radii == "none_excluded":
        assert stats["block_exclusion_rate"] == 0.0
    elif radii == "all_excluded":
        assert stats["block_exclusion_rate"] == 1.0 and not any(hits)
    else:
        assert 0.0 < stats["block_exclusion_rate"] < 1.0 and any(hits)
    if radii == "per_query":
        assert hits[-N_PADDING:] == [[]] * N_PADDING
        assert (stats["per_query_dists"][-N_PADDING:] == BUILD["n_pivots"]).all()


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_zero_queries(index, seen, prec, sharded):
    if sharded:
        index = flat_index.build_bss("l2", index.data[index.valid], device="cpu",
                                     mesh=ShardMesh(("cpu",) * 2), **BUILD)
    opts = EngineOpts(backend="torch", precision=prec, bq=BQ)
    hits, stats = flat_index.bss_query_batched(index, np.zeros((0, 2), np.float32), 0.1,
                                               opts=opts)
    want_hits, want_stats = _pinned_epilogue(seen)
    assert hits == want_hits == []
    _same(stats, want_stats)
    assert stats["n_queries"] == 0 and stats["precision"] == prec


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("real", ["dense", "adaptive"])
def test_after_append_and_delete(space, seen, real, prec):
    corpus, q, t = space
    idx, _ = append(flat_index.build_bss("l2", corpus[:1500], device="cpu", **BUILD),
                    corpus[1500:])
    idx.device  # the device mirror is built: delete updates it in place of a rebuild
    idx, _ = delete(idx, range(0, 1700, 7))
    assert idx.generation == 2 and not idx.valid.all()
    opts = EngineOpts(backend="torch", realisation=real, precision=prec, bq=BQ)
    hits, _, _ = _check(idx, q, _radii("per_query", t), opts, seen)
    assert not set().union(*hits) & set(range(0, 1700, 7))


@pytest.mark.parametrize("radii", ["scalar", "per_query"])
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_epilogue(index, space, seen, n_shards, prec, radii):
    corpus, q, t = space
    mesh = ShardMesh(("cpu",) * n_shards)
    sidx = flat_index.build_bss("l2", corpus, device="cpu", mesh=mesh, **BUILD)
    assert sidx.sharded().n_blocks_pad > sidx.n_blocks  # padding blocks are there
    t = _radii(radii, t)
    opts = EngineOpts(backend="torch", precision=prec, bq=BQ)
    hits, stats = flat_index.bss_query_batched(sidx, q, t, opts=opts)
    want_hits, want_stats = _pinned_epilogue(seen)
    _same(hits, want_hits, "hits")
    _same(stats, want_stats)
    single, single_stats = flat_index.bss_query_batched(index, q, t, opts=opts)
    assert hits == single
    assert stats["shard_dists"].sum() == single_stats["per_query_dists"].sum() - (
        len(q) * BUILD["n_pivots"])
