#!/usr/bin/env python3
"""Time variants of chunk_scan's general entry on one CUDA card: the
source's design constants changed one at a time.

    python3 tools/chunk_scan_variants.py

Each variant is `csrc/chunk_scan.cu` of this checkout with one of its
design constants set as below, written to the git-ignored
`build/chunk_scan_variants/` and built like the source itself
(`repro_torch.kernels._build`), all builds started together; each is
launched through `kernel.launch`:

  base      kSub 8, 3 copy stages, 16 columns, 256 prep and 128 scan
            threads (the source as it stands)
  sub16     16-row sub-chunks
  stages2   two copy stages
  dvb32     32 state columns a scan block
  prep128   128 prep threads
  scan256   256 scan threads (32 row groups: thinner tiles, more warps)

At rwkv6-1.6b's three served shapes (H 32, dk = dv = 64, chunk 32, bf16
k/q/v, no s0) and at H 80 (Zamba2's head count in rwkv6 mode), on inputs
from numpy seed 0, each variant's y and state are held against the plain
version (bf16: 5e-2 on y, 2e-2 on the state), then timed: `ms` by CUDA
events over 20 calls, `prep_ms` / `scan_ms` each kernel's device time from
the profiler over 5 calls. Prints the card's name and power limit, then one
JSON line a variant and shape; exits non-zero without a card or when a
variant disagrees.
"""

from __future__ import annotations

import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from _timing import card_line, cuda_ms

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
VARIANTS = {"base": {}, "sub16": {"kSub": 16}, "stages2": {"kMaxStages": 2},
            "dvb32": {"kDvb": 32}, "prep128": {"kPrepThreads": 128},
            "scan256": {"kScanThreads": 256}}
SHAPES = [(2, 4096, 32), (2, 512, 32), (1, 512, 32), (2, 4096, 80)]  # b, s, h
DK = DV = 64
CHUNK = 32


def build(name: str, out: Path):
    """The variant's source written under `out`, built and bound."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.chunk_scan import kernel

    text = kernel.SOURCE.read_text()
    for const, value in VARIANTS[name].items():
        text, hits = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                             text)
        if hits != 1:
            raise SystemExit(f"{name}: {const} not found once in {kernel.SOURCE.name}")
    src = out / f"{name}.cu"
    src.write_text(text)
    return kernel.bind(_build.load(src, f"chunk_scan_{name}"))


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.chunk_scan import kernel, ops

    if not torch.cuda.is_available():
        print("chunk_scan_variants: no CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    out = ROOT / "build" / "chunk_scan_variants"
    out.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda n: build(n, out), VARIANTS)))
    failed = False
    for b, s, h in SHAPES:
        rng = np.random.default_rng(0)

        def dev(a, t=torch.float32):
            return torch.tensor(a.astype(np.float32), device="cuda").to(t)

        w = dev(rng.uniform(0.6, 1.0, (b, s, h, DK)))
        k, v, q = (dev(rng.standard_normal((b, s, h, d)) * 0.3, torch.bfloat16)
                   for d in (DK, DV, DK))
        u = dev(rng.standard_normal((h, DK)) * 0.1)
        y_p, st_p = ops.chunk_scan_plain(w, k, v, q, u, include_current=False, chunk=CHUNK)
        for name, lib in libs.items():
            y = torch.empty_like(v)
            st = torch.empty(b, h, DK, DV, device="cuda")

            def run(lib=lib, y=y, st=st):
                kernel.launch(w, k, v, q, u, None, y, st, include_current=False, chunk=CHUNK,
                              lib=lib)

            run()
            torch.cuda.synchronize()
            agree = bool(torch.allclose(y.float(), y_p.float(), atol=5e-2, rtol=5e-2)
                         and torch.allclose(st, st_p, atol=2e-2, rtol=2e-2))
            failed |= not agree
            ms = cuda_ms(run, 20)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    run()
                torch.cuda.synchronize()
            split = {("prep_ms" if "prep_kernel" in ev.key else "scan_ms"):
                     ev.device_time_total / 5e3 for ev in prof.key_averages()
                     if "prep_kernel" in ev.key or "scan_kernel" in ev.key}
            print(json.dumps({"variant": name, "b": b, "s": s, "h": h, "ms": ms, **split,
                              "agree": agree}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
