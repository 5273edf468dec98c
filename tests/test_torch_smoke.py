"""Pieces of ``chip_smoke.py`` that run without a card: the thresholds it
takes from one distance matrix per metric equal ``calibrate_threshold``'s
bit for bit, and the script refuses to run without a CUDA device."""

from __future__ import annotations

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

from repro_torch.data.metricsets import calibrate_threshold, colors_surrogate  # noqa: E402


@pytest.mark.parametrize("metric", ["l2", "jsd", "triangular"])
def test_thresholds_equal_calibrate_threshold(metric):
    corpus = colors_surrogate(1500, dim=16, seed=3)
    sels = (1e-5, 1e-4, 1e-3)
    th = chip_smoke.Thresholds(np, corpus, sels, (metric,))
    th.start_check()
    failures = []
    out = th.verify(failures)
    assert failures == []
    assert th.get(metric) == [calibrate_threshold(metric, corpus, s) for s in sels]
    assert out[metric]["equal"] is True


def test_verify_reports_a_threshold_that_differs(monkeypatch):
    corpus = colors_surrogate(600, dim=8, seed=4)
    monkeypatch.setattr(chip_smoke, "calibration_distances",
                        lambda np_, m, c: np.array([0.0, 1.0]))
    th = chip_smoke.Thresholds(np, corpus, (0.5,), ("l2",))
    failures = []
    th.verify(failures)
    assert len(failures) == 1 and "differ from calibrate_threshold" in failures[0]


def test_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_oracle_top_k_is_the_stable_argsort():
    """Ascending distance, lowest id first on ties, also where more rows tie
    at the kth than the top k holds."""
    rng = np.random.default_rng(6)
    d = rng.integers(0, 40, size=(16, 3000)).astype(np.float64) / 8  # lint: disable=R3
    d[0, :500] = 0.5
    for k in (1, 10, 100):
        np.testing.assert_array_equal(chip_smoke.oracle_top_k(np, d, k),
                                      np.argsort(d, axis=1, kind="stable")[:, :k])


class _Rolled:
    """A tower that answers each row with the next row's embedding."""

    def __init__(self, model):
        self.model = model

    def user_embed(self, ids):
        return self.model.user_embed(ids.roll(1, dims=0))


@pytest.mark.parametrize("wrong", ["none", "bf16", "fp32"])
def test_tower_check_fails_a_tower_that_returns_another_row(wrong):
    """The two-tower phase's tower check on the CPU at the reduced config:
    a bf16 copy and a float32 copy pass against the float32 model; either
    one answering with another item's row fails."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.recsys import cast_model

    model, cfg, _ = get_arch("two-tower-retrieval").make_reduced()
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    ids = np.random.default_rng(7).integers(0, cfg.vocab, size=(64, cfg.n_user_fields))
    bf16 = cast_model(model, torch.bfloat16, "cpu")
    fp32 = cast_model(model, torch.float32, "cpu")
    if wrong == "bf16":
        bf16 = _Rolled(bf16)
    elif wrong == "fp32":
        fp32 = _Rolled(fp32)
    failures = []
    row = chip_smoke.tower_check(torch, np, failures, bf16, fp32, model, ids,
                                 torch.as_tensor(ids), "user_embed")
    assert (failures == []) == (wrong == "none"), (row, failures)


@pytest.mark.parametrize("wrong", ["none", "bf16", "fp32"])
def test_tower_check_of_trained_towers_holds_the_float32_copy(wrong):
    """``bf16_rows=False`` (the trained towers of the two-tower phase, whose
    rows lie closer together than a bf16 row's rounding) still fails a
    float32 copy that answers with another row, and a bf16 one whose rows
    are off by more than the cosine bound (as another row is at the reduced
    config); the bf16 rows' nearest-row share is printed, not held."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.recsys import cast_model

    model, cfg, _ = get_arch("two-tower-retrieval").make_reduced()
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    ids = np.random.default_rng(7).integers(0, cfg.vocab, size=(64, cfg.n_user_fields))
    bf16 = cast_model(model, torch.bfloat16, "cpu")
    fp32 = cast_model(model, torch.float32, "cpu")
    if wrong == "bf16":
        bf16 = _Rolled(bf16)
    elif wrong == "fp32":
        fp32 = _Rolled(fp32)
    failures = []
    row = chip_smoke.tower_check(torch, np, failures, bf16, fp32, model, ids,
                                 torch.as_tensor(ids), "user_embed", bf16_rows=False)
    assert (failures == []) == (wrong == "none"), (row, failures)
    assert row["bf16_rows_held"] is False
    assert (row["min_cosine"] < chip_smoke.TOWER_MIN_COS) == (wrong == "bf16")


def _reduced_two_tower_cfg():
    from repro_torch.configs.registry import get_arch

    return get_arch("two-tower-retrieval").make_reduced()[1]


@pytest.fixture
def one_torch_thread(monkeypatch):
    """One intra-op thread, here and in the subprocesses a test starts: the
    suite runs several workers at once, and a thread pool per worker
    oversubscribes the cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_two_tower_train_phase_runs_on_the_cpu(tmp_path, one_torch_thread):
    """The smoke's ``two tower train`` phase at the reduced config on the
    CPU: finite losses, the checkpoint restored bit for bit with the
    stream's state, one further step from the live and the restored state
    bit-equal, and the model handed on holds the restored parameters."""
    from repro_torch.pytree import leaves

    failures, record = [], {}
    ckpt = tmp_path / "ckpt"
    model = chip_smoke.two_tower_train(torch, np, failures, record, torch.device("cpu"),
                                       cfg=_reduced_two_tower_cfg(), batch=16, steps=4,
                                       ckpt_dir=ckpt)
    assert failures == []
    row = record["two tower train"]
    assert row["train"]["finite"] and len(row["train"]["host_ms_per_step"]) == 4
    assert row["init_towers"]["user_embed"]["bf16_rows_held"]
    assert row["checkpoint"]["differing_leaves"] == [] and row["checkpoint"]["stream_restored"]
    assert row["checkpoint"]["bytes"] > row["init"]["param_bytes"]
    assert row["train"]["further_step_differing_leaves"] == []
    assert row["train"]["further_step_same_loss"]
    assert not ckpt.exists()
    assert all(p.device.type == "cpu" and torch.isfinite(p).all()
               for p in leaves(model.param_tree()))


def test_two_tower_train_phase_fails_a_restore_that_differs(tmp_path, monkeypatch,
                                                            one_torch_thread):
    """A restored leaf one bit off fails the phase."""
    from repro_torch.checkpoint import manager

    original = manager.CheckpointManager.restore

    def off_by_a_bit(self, like, *args, **kwargs):
        state, extra = original(self, like, *args, **kwargs)
        w = state["params"]["user_w"][0]
        w.view(torch.int32).view(-1)[0] ^= 1
        return state, extra

    monkeypatch.setattr(manager.CheckpointManager, "restore", off_by_a_bit)
    failures, record = [], {}
    chip_smoke.two_tower_train(torch, np, failures, record, torch.device("cpu"),
                               cfg=_reduced_two_tower_cfg(), batch=16, steps=2,
                               ckpt_dir=tmp_path / "ckpt")
    assert record["two tower train"]["checkpoint"]["differing_leaves"] == ["params/user_w/0"]
    assert any("restored state differs" in f for f in failures)
    assert any("from the restored state differs" in f for f in failures)


def test_printed_losses_reads_the_launchers_lines():
    lines = ["step 10: loss=2.7783 (26 ms)", "done: final loss nan over 20 steps (0 ...)",
             "trained 20 steps on cuda: loss 4.164 -> 4.159", "indexed 5000 items"]
    got = chip_smoke.printed_losses(lines)
    assert got[0] == 2.7783 and np.isnan(got[1]) and got[2:] == [4.164, 4.159]


def test_launchers_run_on_the_cpu_with_finite_losses(tmp_path, one_torch_thread):
    """The training launchers run beside the quickstart (the training
    launcher on the reduced two-tower, Llama-3.2-1B and PNA, and the
    example), with ``--device cpu`` added, exit 0 and print finite losses
    (the serving launcher's CPU runs are in ``tests/test_torch_import.py``)."""
    failures = []
    commands = chip_smoke.launcher_commands(tmp_path / "ckpt")
    assert [name for name, _ in commands][:2] == ["serve", "serve --min-score 0.5"]
    procs = chip_smoke.start_launchers(commands[2:], ("--device", "cpu"))
    rows = chip_smoke.finish_launchers(failures, procs)
    assert failures == []
    assert [r["name"] for r in rows] == ["train", "train llama3.2-1b", "train pna",
                                         "retrieval serving example"]
    assert all(len(r["losses"]) >= 2 for r in rows)
