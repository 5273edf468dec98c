"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``PYTHONPATH=src python -m portbench.run ...``
does the same).  It needs as many CUDA cards as the cell asks for and exits
with code 2 and no result where there are fewer.  It prints the card, the
phases' seconds and the numbers compared (each beside its limit) on
standard error, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``compared``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()  # where the process's start cannot be read
ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro")  # top-level names, compared whole


def _process_age() -> float:
    """Seconds since this process started (its start time in /proc), or 0
    where that cannot be read."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, uptime - start)


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    age = _process_age()
    t_start = time.perf_counter() - age if age else T_START

    # every build and kernel cache inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))

    import torch

    try:
        from portbench import harness

        cell = harness.load_cell(args.workload, ROOT)
        import repro_torch  # noqa: F401  (the system under test)
    except (ImportError, OSError, KeyError) as e:
        print(f"portbench: cannot set up {args.workload!r}: {e!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda:0", t_start=t_start)
    harness.log("run " + json.dumps(out["extra"]))
    found = banned_modules()
    if found:
        print(f"portbench: the process loaded {found}; the port must not", file=sys.stderr)
        return 3
    result = out["result"]
    result["compared"] = out["compared"]
    for name, c in out["compared"].items():
        harness.log(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
