"""The port's invariant audit (``repro_torch.analysis``) on the CPU: the l2
column is clean, each check catches a fault injected into a pass, the
rebuild audit counts the buckets a stream touches, the passes are the
originals again once the audit returns, and ``shard_bss`` serves as the
other two ways to shard an index do.  The card's run of the full matrix is
``tests/test_torch_cuda_invariants.py``."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch.analysis import audit, cli
from repro_torch.core import flat_index
from repro_torch.core.backends import EngineOpts
from repro_torch.forest import walk
from repro_torch.parallel import ShardMesh, shard_index

TORCH = EngineOpts(backend="torch", realisation="dense")
# the l2 column on the CPU: bss 2 legs, sharded 1 and 2 shards, forest,
# monotone, each in fp32 and bf16
L2_CELLS = 12


def _l2_column():
    return audit.run_audit(full=False, device="cpu")


def test_l2_column_is_clean_on_the_cpu():
    problems, cells = _l2_column()
    assert problems == []
    assert len(cells) == L2_CELLS
    names = {c["cell"] for c in cells}
    for kind in ("bss/l2/torch-adaptive", "bss/l2/torch-dense", "sharded1/l2/torch",
                 "sharded2/l2/torch", "forest/l2/torch", "monotone/l2/torch"):
        assert {f"{kind}/fp32", f"{kind}/bf16"} <= names
    fired = set().union(*(c["passes"] for c in cells))
    # every pass but the masked one that only "cuda" runs
    want = {audit._label(m, n) for m, ns in audit.PASSES.items() for n in ns}
    assert fired == want - {"flat_index._query_batched"}


def _with_item(fn):
    def faulty(*args, **kwargs):
        out = fn(*args, **kwargs)
        float(out.sum().item())
        return out
    return faulty


def _with_f64(fn):
    def faulty(*args, **kwargs):  # float32 -> float64 -> float32 keeps the bits
        return fn(*args, **kwargs).to(audit._F64).to(torch.float32)
    return faulty


def _mirror_into_alive(fn):
    def faulty(metric_name, queries, t, dev, data16, eps, **kw):
        hit, alive, tile_mask, rtiles, band = fn(metric_name, queries, t, dev, data16, eps, **kw)
        never = (data16[:1, :1].float() != data16[:1, :1].float()).any()  # always False
        return hit, alive | never, tile_mask, rtiles, band
    return faulty


@pytest.mark.parametrize("fault, fn, check", [
    ("item", "flat_index._dense_hit_mask", "sync"),
    ("f64", "flat_index._fused_lower_bounds", "f64"),
    ("taint", "flat_index._query_batched_bf16", "taint"),
    ("never", "flat_index._cells_exact", "coverage"),
])
def test_each_check_catches_its_fault(monkeypatch, fault, fn, check):
    """A pass made to call ``.item()``, to make a float64 tensor, to read the
    bf16 mirror into ``alive``, or to never fire: the audit reports that
    check on that pass and nothing else."""
    name = fn.split(".")[1]
    if fault == "never":  # the adaptive path never gathers cells
        monkeypatch.setattr(flat_index, "_DENSE_ALIVE_FRAC", -1.0)
    else:
        make = {"item": _with_item, "f64": _with_f64, "taint": _mirror_into_alive}[fault]
        faulty = make(getattr(flat_index, name))
        for module in (flat_index, shard_index):  # every namespace that holds it
            if hasattr(module, name):
                monkeypatch.setattr(module, name, faulty)
    problems, _ = _l2_column()
    assert problems
    assert {p.check for p in problems} == {check}
    if fault == "never":
        assert {p.fn for p in problems} == {fn, "flat_index._knn_round_cells",
                                            "flat_index._cells_exact_bf16",
                                            "flat_index._knn_round_cells_bf16"}
    else:
        assert {p.fn for p in problems} == {fn}


@pytest.mark.parametrize("sizes, touched", [
    ((1, 2, 3), [4]),
    ((5, 7), [8]),
    ((9,), [4, 8]),
    (tuple(range(1, 11)), [4, 8]),
])
def test_audit_rebuilds_counts_the_buckets_touched(sizes, touched):
    problems, info = audit.audit_rebuilds(device="cpu", sizes=sizes)
    assert problems == []
    assert info["touched"] == touched
    assert info["generations"] == [0, 1]
    assert set(info["shapes"]) == {
        "range/entry", "range/flat_index._fused_lower_bounds",
        "range/flat_index._dense_hit_mask", "knn/entry",
        "knn/flat_index._fused_lower_bounds", "knn/flat_index._knn_round"}
    assert all(seen == touched for seen in info["shapes"].values())
    assert max(info["loads"].values()) <= 1


def test_audit_rebuilds_reports_a_shape_off_the_ladder(monkeypatch):
    """A front whose ladder is not the one the audit predicts from: every
    entry and pass reports the extra shape."""
    from repro_torch.serve import front

    monkeypatch.setattr(front, "bucket_for", lambda n, buckets: n)
    problems, info = audit.audit_rebuilds(device="cpu", sizes=(1, 2))
    assert {p.check for p in problems} == {"shapes"}
    assert info["shapes"]["range/entry"] == [1, 2]


def test_passes_are_the_originals_after_the_audit(monkeypatch):
    originals = {(m, n): getattr(__import__(m, fromlist=[n]), n)
                 for m, ns in {**audit.PASSES, **audit.KERNEL_WRAPPERS}.items() for n in ns}
    seen = []
    real = flat_index.bss_knn_batched

    def probe(*args, **kwargs):  # the audit is running: its wrappers are in place
        seen.append(hasattr(flat_index._knn_round_cells, "__audit_original__")
                    and hasattr(shard_index._fused_lower_bounds, "__audit_original__"))
        return real(*args, **kwargs)

    monkeypatch.setattr(flat_index, "bss_knn_batched", probe)
    _l2_column()
    assert seen and all(seen)
    for (m, n), fn in originals.items():
        assert getattr(__import__(m, fromlist=[n]), n) is fn
    assert shard_index._fused_lower_bounds is flat_index._fused_lower_bounds
    assert shard_index._query_batched_bf16 is flat_index._query_batched_bf16
    assert walk.masked_pairwise_kernel_call is originals[
        ("repro_torch.kernels.pairwise_dist", "masked_pairwise_kernel_call")]


def test_passes_are_restored_when_a_pass_raises(monkeypatch):
    def broken(*args, **kwargs):
        raise ValueError("a broken pass")

    monkeypatch.setattr(walk, "_monotone_walk", broken)
    with pytest.raises(ValueError, match="a broken pass"):
        _l2_column()
    assert not hasattr(flat_index._fused_lower_bounds, "__audit_original__")
    assert not hasattr(shard_index._knn_round, "__audit_original__")


def _sharded_case():
    rng = np.random.default_rng(4)
    x = rng.random((700, 10)).astype(np.float32)
    return x[:660], x[660:], 0.45


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_shard_bss_serves_as_build_bss_with_a_mesh(n_shards):
    db, q, t = _sharded_case()
    mesh = ShardMesh(("cpu",) * n_shards)
    idx = flat_index.build_bss("l2", db, n_pivots=6, n_pairs=8, block=32, device="cpu")
    built = flat_index.build_bss("l2", db, n_pivots=6, n_pairs=8, block=32, device="cpu",
                                 mesh=mesh)
    sidx = shard_index.shard_bss(idx, mesh)
    assert isinstance(sidx, shard_index.ShardedBSSIndex) and sidx.n_shards == n_shards
    assert "shard_bss" in shard_index.__all__
    for opts in (TORCH, EngineOpts(backend="torch", realisation="dense", precision="bf16")):
        hits, stats = shard_index.sharded_query_batched(sidx, q, t, opts=opts)
        ids, dists, kstats = shard_index.sharded_knn_batched(sidx, q, 5, opts=opts)
        others = (
            (flat_index.bss_query_batched(built, q, t, opts=opts),
             flat_index.bss_knn_batched(built, q, 5, opts=opts)),
            (shard_index.sharded_query_batched(idx.sharded(mesh), q, t, opts=opts),
             shard_index.sharded_knn_batched(idx.sharded(mesh), q, 5, opts=opts)),
        )
        for (o_hits, o_stats), (o_ids, o_dists, o_kstats) in others:
            assert hits == o_hits
            np.testing.assert_array_equal(ids, o_ids)
            np.testing.assert_array_equal(dists, o_dists)
            for got, want in ((stats, o_stats), (kstats, o_kstats)):
                assert got.keys() == want.keys()
                for key, w in want.items():
                    if key == "excluded":
                        np.testing.assert_array_equal(got[key]["hilbert"], w["hilbert"])
                    elif isinstance(w, np.ndarray):
                        np.testing.assert_array_equal(got[key], w, err_msg=key)
                    else:
                        assert got[key] == w, key


def test_cli_report_parses(tmp_path, capsys):
    path = tmp_path / "report.json"
    assert cli.main(["--device", "cpu", "--json", str(path)]) == 0
    report = json.loads(path.read_text())
    assert report["ok"] is True and report["problems"] == []
    assert report["device"] == {"type": "cpu", "name": "cpu"}
    assert len(report["cells"]) == L2_CELLS
    assert report["rebuilds"]["touched"] == [4, 8]
    assert "0 problem(s)" in capsys.readouterr().out


def test_cli_without_a_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([])
