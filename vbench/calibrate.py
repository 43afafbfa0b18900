"""Readings for the limits of the check: the program's numbers and the
control's on the same sweeps, seed after seed, in one process.

    python3 vbench/calibrate.py --workload prod.refine.cuda --seeds 1,2,3 --seconds 3

Each seed is a whole run of the cell (set-up, a short window at the cell's
own load, the check); each control is the cell's check's (`vbench/checks/`,
its `CONTROLS`: the sweep check's is the reference in bfloat16 put in the
program's place), judged by the cell's limits. One JSON line a seed; the
benchmark's own runs never run a control. Exits 1 if a control came out
correct on any seed, or the program not correct.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "vbench":
    sys.path.pop(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from vbench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = harness.load_cell(args.workload, ROOT)
    rc = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(cell, seed, args.seconds, False, control=True,
                               log=lambda m: print(m, file=sys.stderr, flush=True))
        control_correct = {name: cell.check.verdict(numbers, cell.limits)[0]
                           for name, numbers in res["control"].items()}
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "control_correct": control_correct,
                          "program": {k: v["value"] for k, v in res["checks"].items()},
                          "control": res["control"], "metrics": res["metrics"]}), flush=True)
        if any(control_correct.values()) or not res["correct"]:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
