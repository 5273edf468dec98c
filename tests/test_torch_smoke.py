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
