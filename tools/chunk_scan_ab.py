#!/usr/bin/env python3
"""Time chunk_scan's general entry of one or more source trees on one CUDA
card, one process a tree, in the order given.

    python3 tools/chunk_scan_ab.py [TREE ...]     (default: this checkout)

A tree is a directory holding `src/repro_torch` (this checkout, or an
earlier commit unpacked with `git archive` under the git-ignored `build/`).
Every tree's kernel is built first, all builds started together. Then each
tree in turn, in a process of its own that imports that tree's
`repro_torch`, calls `ops.chunk_scan` (rwkv6 mode, H 32, dk = dv = 64) at
five shapes, on inputs made from numpy seed 0:

  served_2x4096  B 2, S 4096, chunk 32, bf16 k/q/v, no s0 (rwkv6-1.6b's
                 served prefill waves, one call a layer)
  served_2x512   B 2, S 512, the same
  served_1x512   B 1, S 512, the same
  s0_2x2048      B 2, S 2048, chunk 64, bf16, with s0
  f32_2x512      B 2, S 512, chunk 32, float32, with s0

w and u are float32. Times are ms a call: `ms` by CUDA events over 20 raw
calls, `graph_ms` over 10 calls replayed from a CUDA graph (device time with
no host gaps). Every tree's y and final state must agree with the first
tree's within chunk_scan's tolerances (bf16: 5e-2 on y, 2e-2 on the state;
float32: 3e-5, 1e-4 past 1,000 tokens); `max_abs_err` gives the gaps.
Prints the card's name and power limit, then one JSON line a tree; exits
non-zero without a card or when a tree disagrees.
"""

from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from _timing import card_line, cuda_ms, graph_ms

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"served_2x4096": (2, 4096, 32, "bfloat16", False),
          "served_2x512": (2, 512, 32, "bfloat16", False),
          "served_1x512": (1, 512, 32, "bfloat16", False),
          "s0_2x2048": (2, 2048, 64, "bfloat16", True),
          "f32_2x512": (2, 512, 32, "float32", True)}  # b, s, chunk, k/q/v type, s0
H, DK, DV = 32, 64, 64


def inputs(b: int, s: int, dtype: str, s0: bool) -> dict:
    """w, k, v, q, u and s0 of one shape on the card, from numpy seed 0."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)

    def dev(a, t=torch.float32):
        return torch.tensor(a.astype(np.float32), device="cuda").to(t)

    kind = getattr(torch, dtype)
    w = dev(rng.uniform(0.6, 1.0, (b, s, H, DK)))
    k, v, q = (dev(rng.standard_normal((b, s, H, d)) * 0.3, kind) for d in (DK, DV, DK))
    u = dev(rng.standard_normal((H, DK)) * 0.1)
    state = dev(rng.standard_normal((b, H, DK, DV)) * 0.1) if s0 else None
    return dict(args=(w, k, v, q, u), s0=state)


def worker(tree: Path, out: Path) -> dict:
    """Time `tree`'s general entry; its outputs go to `out` (one .pt)."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.kernels.chunk_scan import ops

    times, results = {}, {}
    for name, (b, s, chunk, dtype, s0) in SHAPES.items():
        inp = inputs(b, s, dtype, s0)

        def run(inp=inp, chunk=chunk):
            return ops.chunk_scan(*inp["args"], include_current=False, chunk=chunk,
                                  s0=inp["s0"])

        times[name] = {"ms": cuda_ms(run, 20), "graph_ms": graph_ms(run, 10, 5)}
        y, state = run()
        torch.cuda.synchronize()
        results[name] = (y.cpu(), state.cpu())
        del inp
        torch.cuda.empty_cache()
    torch.save(results, out)
    return {"tree": str(tree), "times": times}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--build"]:
        sys.path.insert(0, str(Path(argv[1]) / "src"))
        from repro_torch.kernels.chunk_scan import kernel

        kernel.build()
        return 0
    if argv[:1] == ["--worker"]:
        print(json.dumps(worker(Path(argv[1]), Path(argv[2]))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chunk_scan_ab: no CUDA device", file=sys.stderr)
        return 2
    trees = [Path(t).resolve() for t in argv] or [ROOT]
    print(card_line(), flush=True)
    with ThreadPoolExecutor(max_workers=len(trees)) as pool:
        list(pool.map(lambda t: subprocess.run([sys.executable, __file__, "--build", str(t)],
                                               check=True), set(trees)))
    out_dir = ROOT / "build" / "chunk_scan_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    first, failed = None, False
    for i, tree in enumerate(trees):
        out = out_dir / f"{i}.pt"
        proc = subprocess.run([sys.executable, __file__, "--worker", str(tree), str(out)],
                              capture_output=True, text=True, check=True)
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        results = torch.load(out)
        first = first or results
        row["max_abs_err"], row["agree"] = {}, {}
        for name, (y, state) in results.items():
            y0, state0 = first[name]
            b, s, chunk, dtype, _ = SHAPES[name]
            if dtype == "bfloat16":
                tol_y, tol_s = 5e-2, 2e-2
            else:
                tol_y = tol_s = 3e-5 if s <= 1000 else 1e-4
            row["max_abs_err"][name] = [float((y.float() - y0.float()).abs().max()),
                                        float((state - state0).abs().max())]
            row["agree"][name] = bool(
                torch.allclose(y.float(), y0.float(), atol=tol_y, rtol=tol_y)
                and torch.allclose(state, state0, atol=tol_s, rtol=tol_s))
        failed |= not all(row["agree"].values())
        print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
