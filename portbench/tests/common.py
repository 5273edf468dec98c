"""A copy of the benchmark at a size a CPU test holds: the repository's
``BENCHMARK.json`` and ``portbench/`` in a temporary directory, with the
configurations and traffic shrunk.  Runs of it go through the harness on
the CPU (the program's plain ``"torch"`` backend); the command itself
refuses to run without a card."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for _p in (REPO, REPO / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

TINY = {"sisap-colors": dict(n_points=3000, dim=24)}
TINY_BATCH = 48


def read(path: Path) -> dict:
    return json.loads(path.read_text())


def write(path: Path, obj: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def tiny_root(tmp: Path) -> Path:
    """The benchmark copied under ``tmp`` and shrunk; returns its root."""
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = read(REPO / "BENCHMARK.json")
    write(tmp / "BENCHMARK.json", bench)
    for cfg in bench["configs"]:
        path = tmp / cfg["file"]
        body = read(path)
        body.update(TINY.get(cfg["name"], {}))
        write(path, body)
    for path in (tmp / "portbench" / "traffic").glob("*.json"):
        body = read(path)
        body.update(batch=TINY_BATCH)
        write(path, body)
    return tmp


def run(root: Path, workload: str, seed: int = 2**31 + 11, seconds: float = 0.5,
        trace: bool = False, control: str | None = None) -> dict:
    from portbench import harness

    cell = harness.load_cell(workload, root)
    return harness.run_cell(cell, seed, seconds, trace, device="cpu", control=control)
