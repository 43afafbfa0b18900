#!/usr/bin/env python3
"""The deepest cut of each arch whose train step one card holds.

For each arch, the most layer groups (`launch.dryrun.group_layers`) whose
train step at (batch, length) peaks within the limit, by `launch.dryrun`'s
estimate on `meta` (no allocation: it runs on a CPU or beside a card), with
one microbatch, AdamW or the config's optimizer, and a MoE arch at one
card's share of its experts (`configs.expert_share(cfg, 0, 8)`, as served).
A binary search over the group count; each probe is one estimate.

    PYTHONPATH=src python tools/depth_cuts.py [--limit-gb 70] [--batch 2] [--seq-len 4096]
        [--arch zamba2-2.7b ...]

Prints one JSON line an arch: its groups and layers, the deepest fitting
cut, that cut's estimated peak and parameters, and the next cut's peak.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

# The archs the train phase cuts or leaves reduced (ROADMAP item 13e).
ARCHS = ("zamba2-2.7b", "gemma-7b", "gemma2-9b", "gemma2-9b-sw", "phi3-medium-14b",
         "llama-3.2-vision-90b", "arctic-480b", "llama4-maverick-400b-a17b")


def deepest_cut(cfg, b: int, s: int, limit: float) -> dict:
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params

    def peak(g):
        return dryrun.estimate(dryrun.at_groups(cfg, g), "train", b, s)["peak_bytes"]

    lo, hi = 0, dryrun.num_groups(cfg)  # lo fits (0: nothing), search (lo, hi]
    peaks = {}
    while lo < hi:
        mid = (lo + hi + 1) // 2
        peaks[mid] = peak(mid)
        if peaks[mid] <= limit:
            lo = mid
        else:
            hi = mid - 1
    nxt = lo + 1 if lo < dryrun.num_groups(cfg) else None
    if nxt is not None and nxt not in peaks:
        peaks[nxt] = peak(nxt)
    cut = dryrun.at_groups(cfg, lo) if lo else None
    return {"groups": dryrun.num_groups(cfg), "group_layers": dryrun.group_layers(cfg),
            "layers": cfg.num_layers, "fit_groups": lo,
            "fit_layers": lo * dryrun.group_layers(cfg),
            "fit_peak_gb": peaks[lo] / 1e9 if lo else None,
            "fit_params_b": count_params(M.build_schema(cut)) / 1e9 if cut else None,
            "next_peak_gb": peaks[nxt] / 1e9 if nxt is not None else None}


def main(argv=None) -> int:
    import torch

    from repro_torch import configs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="*", default=list(ARCHS))
    ap.add_argument("--limit-gb", type=float, default=70.0)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=4096)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    for arch in args.arch:
        cfg = configs.get(arch)
        if cfg.num_experts:
            cfg = configs.expert_share(cfg, 0, 8)
        cfg = dataclasses.replace(cfg, microbatch=1)
        t0 = time.perf_counter()
        out = deepest_cut(cfg, args.batch, args.seq_len, args.limit_gb * 1e9)
        print(json.dumps({"arch": arch, "batch": args.batch, "seq_len": args.seq_len,
                          "limit_gb": args.limit_gb, "optimizer": cfg.optimizer, **out,
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
