"""``python -m repro_torch.analysis``: run the port's audit, print every
problem, exit non-zero on any (the counterpart of ``python -m
repro.analysis``).

    python -m repro_torch.analysis [--ci] [--device cuda|cpu] [--json PATH]

* default: the l2 column of the audit matrix (every entry point, backend,
  realisation and precision) and the rebuild audit through the serving
  front;
* ``--ci``: all four supermetrics, writing the JSON report to ``--json``
  (default ``ANALYSIS_torch_report.json`` in the working directory).

Like every entry point of the port it runs on the card unless the caller
asks for the CPU: ``--device`` defaults to ``cuda`` and raises without one.
The reference's AST lint, which also scans the port, stays
``python -m repro.analysis --lint-only``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPORT = "ANALYSIS_torch_report.json"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="runtime invariant audit of the port's engine passes",
    )
    ap.add_argument("--ci", action="store_true",
                    help="the full metric matrix and a JSON report")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engines run (default: the CUDA device)")
    ap.add_argument("--json", type=Path, default=None,
                    help=f"write the JSON report here (default {REPORT} under --ci)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.analysis.audit import audit_rebuilds, run_audit
    from repro_torch.core.flat_index import resolve_device

    device = resolve_device(None if args.device == "cuda" else args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})", flush=True)
    problems, cells = run_audit(full=args.ci, device=device,
                                log=lambda s: print(f"  {s}", flush=True))
    rebuild_problems, rebuilds = audit_rebuilds(device=device)
    problems += rebuild_problems
    for p in problems:
        print(p.format())
    print(f"audit ({'full' if args.ci else 'l2 column'}, {len(cells)} cells): "
          f"{len(problems)} problem(s); rebuilds: touched buckets {rebuilds['touched']}, "
          f"library loads {rebuilds['loads']}")

    json_path = args.json or (Path(REPORT) if args.ci else None)
    if json_path is not None:
        report = {
            "device": {"type": device.type, "name": name},
            "full": args.ci,
            "cells": cells,
            "problems": [p.__dict__ for p in problems],
            "rebuilds": rebuilds,
            "ok": not problems,
        }
        json_path.write_text(json.dumps(report, indent=2, sort_keys=True))
        print(f"report: {json_path}")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
