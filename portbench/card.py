"""The card a run measures: its name, SM count, clocks and power limit, and
its peaks from ``peaks.json`` (the entry whose key starts the card's
name)."""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"
QUERY = "name,clocks.max.sm,power.limit"


def _smi() -> dict:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={QUERY}", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    name, mhz, watts = (f.strip() for f in out.split(","))
    return {"smi_name": name, "max_sm_mhz": float(mhz), "power_limit_w": float(watts)}


def describe(device) -> dict:
    """The card's stamp and its rates (``{}`` off the card)."""
    import torch

    if torch.device(device).type != "cuda":
        return {}
    props = torch.cuda.get_device_properties(device)
    out = {"kind": torch.cuda.get_device_name(device), "sms": props.multi_processor_count}
    out.update(_smi())
    peaks = json.loads(PEAKS.read_text())
    for key, rates in peaks.items():
        if out["kind"].startswith(key):
            out["fp32_flops"] = rates["fp32_flops"]
            out["hbm_bytes_per_s"] = rates["hbm_bytes_per_s"]
            if "max_sm_mhz" in out:
                out["sfu_per_s"] = rates["sfu_per_sm_clock"] * out["sms"] * out["max_sm_mhz"] * 1e6
    return out
