"""The readings the limits of a cell are set from (``portbench/limits``):
the program's compared numbers over several seeds, and the control's, the
reference computed in the configuration's lower precision (``control`` in
its file) and put in the program's place, at the cell's own size.

    python3 portbench/controls.py --workload <name> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 8 --out readings.json

Each run is a short window of the cell, then the comparison every run of
the benchmark makes.  The benchmark's own runs never run the control.
Prints one line per run and, last, each number's lower reading (the
largest over the program's runs) and upper reading (the smallest over the
control's).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    from portbench import harness

    cell = harness.load_cell(args.workload, ROOT)
    runs = []
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in (int(s) for s in seeds.split(",") if s):
            out = harness.run_cell(cell, seed, args.seconds, False, device="cuda:0",
                                   control=cell.config["control"] if side == "control" else None)
            row = {"side": side, "seed": seed, "correct": out["result"]["correct"],
                   "numbers": {k: v["value"] for k, v in out["compared"].items()},
                   "extra": out["extra"]}
            runs.append(row)
            print(json.dumps(row), flush=True)
    summary = {}
    for side, pick in (("program", max), ("control", min)):
        rows = [r["numbers"] for r in runs if r["side"] == side]
        if rows:
            summary[side] = {k: pick(r[k] for r in rows) for k in rows[0]}
    print(json.dumps({"workload": args.workload, "readings": summary}), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"runs": runs, "readings": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
