"""Training launcher.

The reference's `repro.launch.train` on the port, with its flags and
`--device` (CUDA unless `--device cpu` is given, as `launch.serve`'s).
Without `--full` it trains the reduced config, so the whole path — config,
data pipeline, optimizer, checkpointing — runs end to end on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --device cpu --steps 8 --seq-len 32 --global-batch 4 [--ckpt out/ckpt.npz]

`--full` trains the published widths and depth on one card. AdamW keeps 12
bytes a parameter (bf16 weights and gradients, float32 moments) beside the
activations, so an arch of more than about 5 B parameters (qwen2-7b whole:
7.62 B, 91.4 GB of weights and state alone) runs out of memory on an 80 GB
card, as `serve --full` does for the models it cannot hold; `chip_smoke.py`
trains such an arch cut in depth itself.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.train.loop import train
from repro_torch.train.optim import OptConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help=f"one of {configs.names()}")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="use the full (published) config instead of reduced")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[train] {cfg.name}: {cfg.num_layers}L d={cfg.d_model} on {where}")

    opt_cfg = OptConfig(name=cfg.optimizer, lr=args.lr,
                        warmup_steps=min(20, args.steps),
                        decay_steps=args.steps)
    params, history = train(
        cfg,
        num_steps=args.steps,
        seq_len=args.seq_len,
        global_batch=args.global_batch,
        opt_cfg=opt_cfg,
        seed=args.seed,
        ckpt_path=args.ckpt or None,
        on_metrics=lambda step, m: print(
            f"[train] step {step:5d} loss {m['loss']:.4f} "
            f"gnorm {m['grad_norm']:.3f} ({m['wall_s']:.1f}s)"
        ),
        device=dev,
    )
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=1)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"[train] done: loss {first:.4f} -> {last:.4f}")
    return history


if __name__ == "__main__":
    main()
