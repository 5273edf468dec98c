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
