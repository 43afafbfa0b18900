"""Run one cell of the benchmark and print its result line.

    python3 vbench/run.py --workload prod.refine.cuda --seed 7 --seconds 30 --trace 0

from the root of a checkout, on a machine with the card the cell asks for.
It measures the port (`src/repro_torch`) and nothing else: with no CUDA
card, or fewer cards than the cell asks for, it exits 2 and prints no
result; if the JAX package or JAX itself was loaded once the window has
closed, it exits 3 and prints no result. The last line of standard output
is the result (JSON); the last lines of standard error are the numbers the
check compared, each beside its limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Run as a script, this folder heads the path, where `traceview` and the
# rest would shadow top-level names: the checkout's root takes its place.
if sys.path and Path(sys.path[0]).resolve() == ROOT / "vbench":
    sys.path.pop(0)
#: Top-level module names that may not be loaded in a run.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among `modules` (default: loaded)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from vbench import harness

    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _say(f"{args.workload} needs {cell.chips} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                              t0=T0, log=_say)
    found = forbidden_modules()
    if found:
        _say(f"forbidden modules loaded: {', '.join(found)}")
        return 3
    for name, row in result["checks"].items():
        _say(f"check {name} {row['value']!r} limit {row['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
