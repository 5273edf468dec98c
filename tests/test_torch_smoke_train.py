"""The training phases of ``chip_smoke.py`` (``lm train``, ``gnn train``)
run on the CPU at a reduced size, so a fault in their plumbing shows here
before a chip run: every check they make passes on a healthy port, and the
GNN cells' batches take the shapes of their specs.  The file imports no
jax."""

from __future__ import annotations

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

from repro_torch.configs.common import GNN_SHAPES  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.data.pipeline import NeighborSampler  # noqa: E402
from repro_torch.models.params import cast_model  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test, as ``test_torch_train.py`` runs: the
    suite runs several workers at once, and a thread pool per worker
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
SMALL_LM = dict(chip_smoke.LM_TRAIN, batch=2, seq=16, steps=3, check_layers=1,
                check_tokens=8, phi_batch=4, phi_seq=32, phi_check_tokens=8, warmup_seq=4)


def test_lm_train_llama_checks_pass_on_the_cpu():
    """The Llama step of ``lm train`` on a reduced bf16 Llama with remat:
    finite, falling losses, a step repeated bit for bit, the float32 copy
    within its bounds (the CPU against itself)."""
    model, cfg, _ = get_arch("llama3.2-1b").make_reduced()
    model = type(model)(dataclasses.replace(cfg, dtype=torch.bfloat16, remat=True))
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    failures, record = [], {}
    chip_smoke.lm_train_llama(torch, np, failures, record, CPU, model,
                              dict(SMALL_LM, lr=3e-3))
    assert failures == []
    row = record["lm train llama"]
    assert row["repeat"]["bit_equal"] and row["train"]["falls"]
    assert row["fp32"]["grad_rel_max"] == 0.0 and row["fp32"]["layers"] == 1


def test_lm_train_phi_checks_pass_on_the_cpu():
    """The Phi step on the reduced Phi with 4 microbatches and a capacity
    that drops pairs: finite, repeated bit for bit, drops counted."""
    _, cfg, _ = get_arch("phi3.5-moe-42b-a6.6b").make_reduced()
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16, microbatches=4, remat=True,
                              moe_capacity_factor=0.5)
    failures, record = [], {}
    chip_smoke.lm_train_phi(torch, np, failures, record, CPU, SMALL_LM, cfg=cfg)
    assert failures == []
    row = record["lm train phi"]
    assert row["moe_calls"] == 4 * cfg.n_layers and row["dropped"] > 0
    assert row["repeat"]["bit_equal"] and row["finite"]


def test_cut_layers_shares_the_first_layers():
    model, _, _ = get_arch("gemma2-9b").make_reduced()
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    cut = chip_smoke.cut_layers(model, 1)
    assert cut.cfg.n_layers == 1
    assert cut.wq.data_ptr() == model.wq.data_ptr() and cut.wq.shape[0] == 1
    assert cut.embed is model.embed or cut.embed.data_ptr() == model.embed.data_ptr()


def test_gnn_train_checks_pass_on_the_cpu(tmp_path):
    """``gnn train`` over full_graph_sm and molecule at their published
    padded shapes on the CPU: the layouts agree, AdamW steps fall in both,
    a step repeats bit for bit, and a checkpoint restored steps as the live
    state does; ogb_products is reckoned."""
    failures, record = [], {}
    chip_smoke.gnn_train(torch, np, failures, record, CPU, dict(chip_smoke.GNN_TRAIN, steps=2),
                         cells=("full_graph_sm", "molecule"), ckpt_dir=tmp_path / "ck")
    assert failures == []
    for cell in ("full_graph_sm", "molecule"):
        row = record[f"gnn train {cell}"]
        spec = get_arch("pna").cells[cell].inputs()
        assert row["layouts_agree"] and row["blocks"] == list(spec["edge_src"].shape)
        assert row["max_block_edges"] <= row["blocks"][1] and row["nodes"] == spec["x"].shape[0]
        for layout in ("flat", "partitioned"):
            assert row[layout]["repeat"]["bit_equal"] and not row[layout]["checkpoint_differing"]
    assert record["gnn train ogb_products"]["padded_edges"] == 512 * 126_872


def test_gnn_grads_against_cpu_reads_zero_on_the_cpu():
    bundle = get_arch("pna")
    cell = "molecule"
    model = bundle.model_for(cell).init_params(torch.Generator().manual_seed(0), device="cpu")
    _, part, _ = chip_smoke.gnn_layouts(np, cell, bundle.cells[cell].inputs(), 0)
    row = chip_smoke.grads_against_cpu(torch, model, cast_model(model, torch.float32, "cpu"),
                                       {k: torch.as_tensor(v) for k, v in part.items()})
    assert row["finite"] and row["loss_rel"] == 0.0 and row["grad_rel_max"] == 0.0


def _gnn_grads(dtype):
    bundle = get_arch("pna")
    model = bundle.model_for("molecule").init_params(torch.Generator().manual_seed(0),
                                                     device="cpu")
    _, part, _ = chip_smoke.gnn_layouts(np, "molecule", bundle.cells["molecule"].inputs(), 0)
    m = cast_model(model, dtype, "cpu")
    return chip_smoke.grads_of(m, {k: torch.as_tensor(v) for k, v in part.items()})


def test_gnn_grad_checks_refuse_a_wrong_term():
    """``gnn_grad_checks`` passes the CPU against itself, and refuses a
    "card" whose float32 leaf is off by a tenth of its largest (past
    ``GNN_F32_GRAD_REL``) or whose float64 leaf is off by 1e-4."""
    r32, r64 = _gnn_grads(torch.float32), _gnn_grads(torch.float64)
    row, ok = chip_smoke.gnn_grad_checks(torch, r32, r64, r32, r64)
    assert ok and row["f32_beyond_bound"] == {} and row["fp64"]["grad_rel_max"] == 0.0
    assert row["card_f32_vs_f64"] == row["cpu_f32_vs_f64"]

    def bumped(ref, by):
        loss, grads = ref
        grads = {k: v.clone() for k, v in grads.items()}
        w = grads["w_in"]
        w.view(-1)[0] += by * float(w.abs().max())
        return loss, grads

    row, ok = chip_smoke.gnn_grad_checks(torch, bumped(r32, 0.1), r64, r32, r64)
    assert not ok and list(row["f32_beyond_bound"]) == ["w_in"]
    row, ok = chip_smoke.gnn_grad_checks(torch, r32, bumped(r64, 1e-4), r32, r64)
    assert not ok and row["fp64"]["grad_rel_max"] > chip_smoke.GNN_REL


def test_segment_ops_against_cpu_runs_at_a_cells_shapes():
    """The smoke's bit check of the segment ops, forward and backward, at
    molecule's padded shapes: the CPU against itself differs nowhere."""
    spec = get_arch("pna").cells["molecule"].inputs()
    flat, _, _ = chip_smoke.gnn_layouts(np, "molecule", spec, 0)
    assert chip_smoke.segment_ops_against_cpu(torch, np, flat, 75, CPU) == []


def test_block_balanced_ids_fit_the_sampled_subgraph():
    """A NeighborSampler draw at minibatch_lg's fanout (1,024 seeds, 15-10)
    over a small graph, relabelled: every one of the 512 blocks holds 330
    in-edges (2 seeds × 15 + 30 first-hop nodes × 10), within the cell's
    E_loc of 360."""
    rng = np.random.default_rng(0)
    n, d = 5000, 15
    sampler = NeighborSampler(np.arange(n + 1) * d, rng.integers(0, n, n * d),
                              rng.standard_normal((n, 4), dtype=np.float32),
                              rng.integers(0, 41, n).astype(np.int32), 1024, (15, 10))
    batch = sampler.next()
    n_pad = batch["x"].shape[0]
    assert n_pad == GNN_SHAPES["minibatch_lg"]["n"]
    new_id = chip_smoke.block_balanced_ids(np, batch["edge_dst"], n_pad, 512)
    assert sorted(new_id.tolist()) == list(range(n_pad))
    moved = chip_smoke.relabel(np, batch, new_id)
    counts = np.bincount(moved["edge_dst"] // (n_pad // 512), minlength=512)
    assert counts.min() == counts.max() == 330
    assert moved["label_mask"].sum() == 1024
    assert np.array_equal(moved["x"][new_id], batch["x"])
    spec = get_arch("pna").cells["minibatch_lg"].inputs()
    assert spec["edge_src"].shape == (512, 360)


def _sharded_cfgs():
    """The reduced Llama (bf16, a vocabulary the model axis divides, the
    residual stream sequence-sharded) and the reduced Phi (bf16,
    expert-parallel) the sharded phase runs here."""
    _, llama, _ = get_arch("llama3.2-1b").make_reduced()
    _, phi, _ = get_arch("phi3.5-moe-42b-a6.6b").make_reduced()
    llama = dataclasses.replace(llama, dtype=torch.bfloat16, vocab=256,
                                seq_shard_activations=True, remat=True)
    phi = dataclasses.replace(phi, dtype=torch.bfloat16, vocab=256, expert_axis="model")
    return llama, phi


# At d_model 32 over 32 (Llama) and 128 (Phi) tokens, one bf16 rounding of
# each shard's row-parallel partial moves the mean loss by up to 8.0e-5 of
# it (read on (1, 4); 3.9e-5 and 3.2e-5 on the other meshes); at full width
# it stays under the smoke's 1e-5 (1.3e-6 and 4.2e-6 on the H100).  Only
# the bf16 meshes split over "model" take this bound; every other mesh
# keeps SHARDED_LOSS_REL.
SHARDED_SMALL = dict(chip_smoke.SHARDED_TRAIN, llama_batch=2, llama_seq=16, tt_batch=64,
                     phi_batch=8, phi_seq=16, dlrm_batch=64, split_loss_rel=2e-4)


def _sharded_train(llama, phi, sizes=SHARDED_SMALL):
    from repro_torch.launch.simdevices import simulated_mesh

    _, tower, _ = get_arch("two-tower-retrieval").make_reduced()
    _, dlrm, _ = get_arch("dlrm-rm2").make_reduced()
    failures, record = [], {}
    chip_smoke.sharded_train(
        torch, np, failures, record, CPU, sizes, llama_cfg=llama, tt_cfg=tower,
        gnn_cell="molecule", phi_cfg=phi, dlrm_cfg=dataclasses.replace(dlrm, dtype=torch.bfloat16),
        mesh_fn=lambda d, m: simulated_mesh(d * m, (d, m), ("data", "model")))
    return failures, record


def test_sharded_train_checks_pass_on_the_cpu():
    """The ``sharded train`` phase on the CPU at a reduced size (simulated
    meshes): the in-place apply equal to the functional one, every mesh's
    gradient repeated bit for bit, the model-split Llama meshes (1, 2),
    (1, 4), (2, 2) and the row split S = 2 within the training bound
    (float32 Llama) and no worse than the one-device step against the
    float32 copy's gradient (bf16), the expert-parallel Phi on (1, 2) and
    (2, 2) likewise with its MoE routing equal to one device's, the two
    tower's row splits and table splits (float64 over the whole batch; the
    (1, 2) table split bit for bit, its lookups too), the reduced DLRM's
    table splits (its float32 copy within the training bound), PNA's
    molecule cell over node shards (2, 1) and (2, 2) (float64 within the
    training bound, its halo counted) and the well-conditioned graph in
    float32 within it."""
    llama, phi = _sharded_cfgs()
    failures, record = _sharded_train(llama, phi)
    assert failures == []
    llama_row = record["sharded train llama"]
    assert llama_row["in_place_vs_functional"] == []
    assert llama_row["rows"] == record["sharded train phi"]["rows"] == "model"
    for name in ("llama", "phi"):
        for tag in ("", " float32"):
            row = record[f"sharded train {name}{tag}"]
            labels = [k for k in row if isinstance(row[k], dict) and "mesh" in row[k]]
            want = {"llama": {"S2", "1x4", "2x2"} | ({"1x2"} if not tag else set()),
                    "phi": {"1x2", "2x2"}}[name]
            assert set(labels) == want, (name, tag, labels)
            for label in labels:
                m = row[label]
                assert m["ok"] and m["repeated_bit_for_bit"] and not m["exact"]
                assert m["compute_bytes"] > 0
                assert ("reckoned_bytes" in m) == (not tag)
                if tag:
                    assert m["strict"] and all(r["grad_rel"] <= chip_smoke.SHARDED_GRAD_REL
                                               for r in m["leaves"].values())
                    assert m["loss_bound"] == chip_smoke.SHARDED_LOSS_REL
                else:
                    assert set(m["against_reference"]) == set(m["leaves"])
                    assert m["loss_bound"] == (SHARDED_SMALL["split_loss_rel"]
                                               if label != "S2" else chip_smoke.SHARDED_LOSS_REL)
                    assert set(m["loss_against_reference"]) == {"sharded", "one_device"}
                assert m["loss_rel"] <= m["loss_bound"]
    moe = record["sharded train phi moe block"]
    assert set(moe) == {"1x2", "2x2"}
    assert all(r["ids_equal"] and r["loads_equal"] and r["drops_equal"] for r in moe.values())
    f64 = record["sharded train two tower float64"]
    assert f64["batch"]["user_ids"][0] == 64 and f64["S4"]["strict"]
    for name in ("two tower", "two tower float32"):
        gaps = record[f"sharded train {name}"]["S4"]["against_reference"]
        assert all(r["sharded"] <= r["bound"] for r in gaps.values())
    assert record["sharded train two tower"]["rows"] == "in_batch"
    assert set(record["sharded train two tower"]) >= {"S2", "S4", "1x2", "2x2"}
    for name in ("two tower", "dlrm"):
        row = record[f"sharded train {name}"]
        assert row["1x2"]["exact"] and row["1x2"]["differing_leaves"] == []
        for label in ("1x2", "2x2"):
            assert all(row[label]["lookups_bit_for_bit"].values()), (name, label)
        assert row["1x2"]["compute_bytes"] == row["2x2"]["compute_bytes"]
    tt = record["sharded train two tower"]
    assert tt["1x2"]["compute_bytes"] < tt["S2"]["compute_bytes"]  # the table pieces
    assert record["sharded train dlrm"]["rows"] == "split"
    assert record["sharded train dlrm float32"]["2x2"]["strict"]
    for tag in ("pna", "pna float64", "pna conditioned"):
        row = record[f"sharded train {tag}"]
        assert row["rows"] == "node" and set(row) >= {"S2", "2x2"}, tag
        for label in ("S2", "2x2"):
            m = row[label]
            assert m["ok"] and not m["exact"] and m["halo_bytes"] > 0, (tag, label)
            assert m["strict"] == (tag != "pna") and m["reference_held"] is False
    assert record["sharded train pna"]["2x2"]["against_reference"]


def test_sharded_train_checks_catch_a_dropped_partial(monkeypatch):
    """The phase's checks on the model-split Llama with the last shard's
    partial dropped from every reduction over the model axis (the
    row-parallel products' reduce-scatter among them): the float32 copy's
    training bound fails on every model-split mesh."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.simdevices import simulated_mesh
    from repro_torch.models.transformer import LMModel
    from repro_torch.optim import adamw
    from repro_torch.parallel import collectives
    from repro_torch.train.step import to_device

    real = collectives._sum
    monkeypatch.setattr(collectives, "_sum",
                        lambda parts, device, dtype: real(parts[:max(1, len(parts) - 1)],
                                                          device, dtype))
    llama, _ = _sharded_cfgs()
    model = LMModel(dataclasses.replace(llama, dtype=torch.float32))
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = to_device(TokenStream(vocab=llama.vocab, batch=2, seq=16, seed=0).next(), "cpu")
    meshes = [(chip_smoke.mesh_label((d, m)), simulated_mesh(d * m, (d, m), ("data", "model")))
              for d, m in ((1, 2), (1, 4), (2, 2))]
    failures = []
    chip_smoke.sharded_against_one(torch, np, failures, "llama float32", "lm", model,
                                   adamw(lr=3e-4), batch, meshes, CPU, 3e-4, strict=True)
    assert len(failures) == 3 and all("llama float32" in f for f in failures)


def test_reference_gaps_catch_a_wrong_gradient():
    """A row-split gradient with one shard's half dropped lies far beyond
    twice the one-device gradient's rounding gap to the wider reference;
    one with the same rounding passes."""
    gen = torch.Generator().manual_seed(0)
    ref = {"w": torch.randn(64, 32, generator=gen, dtype=torch.float64)}
    one = {"w": ref["w"].to(torch.bfloat16)}
    good = {"w": (ref["w"] + 1e-3 * torch.randn(64, 32, generator=gen,
                                               dtype=torch.float64)).to(torch.bfloat16)}
    dropped = {"w": torch.cat([ref["w"][:32], ref["w"][32:] / 2]).to(torch.bfloat16)}
    ok = chip_smoke.reference_gaps(torch, good, one, ref, 2)["w"]
    bad = chip_smoke.reference_gaps(torch, dropped, one, ref, 2)["w"]
    assert ok["sharded"] <= ok["bound"]
    assert bad["sharded"] > bad["bound"] and bad["sharded"] > 0.1


def test_dryrun_line_reckons_the_cells_that_do_not_fit():
    record = {}
    chip_smoke.dryrun_line(record)
    got = record["dryrun"]
    assert list(got) == [f"{a}/{s}" for a, s in chip_smoke.DRYRUN_CELLS]
    assert all(r["per_device_bytes"]["total"] > 0 for r in got.values())
