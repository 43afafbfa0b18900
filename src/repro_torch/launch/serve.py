"""Serving launcher: batched generation over the length-bucketed engine.

The reference's `repro.launch.serve` on the port, with its flags. Weights
are drawn from `--seed` at the config's widths (`--full`: the published
ones; otherwise the reduced smoke-test variant); it runs on CUDA unless
`--device cpu` is given. Ported archs: the dense family (`qwen2-7b`,
`gemma-7b`, `gemma2-9b`, `gemma2-9b-sw`, `phi3-medium-14b`), the ssm family
(`rwkv6-1.6b`), the hybrid family (`zamba2-2.7b`), the audio family
(`whisper-base`; the engine feeds zero frames), the VLM family
(`llama-3.2-vision-90b`; zero patches) and the MoE family (`arctic-480b`,
`llama4-maverick-400b-a17b`). The VLM and the MoE archs at their published
widths need more memory than one 80 GB card holds (87.7 B, 477 B and 401 B
parameters), so `--full` runs them out of memory there; `chip_smoke.py`
serves them cut in depth (and the MoE archs at one card's share of their
experts):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch arctic-480b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b --full \\
      --requests 4 --prompt-len 512 --max-new 32 --cache-len 8192 --max-batch 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base --full \\
      --requests 3 --prompt-len 4 --max-new 128 --cache-len 448 --max-batch 2
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help=f"one of {configs.names()}")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve] {cfg.name} on {where}")
    params = M.init_model(cfg, seed=args.seed, device=dev)

    eng = Engine(cfg, params, cache_len=args.cache_len, max_batch=args.max_batch,
                 seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        eng.submit(Request(
            uid=i,
            prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new,
            temperature=args.temperature,
        ))
    results = eng.run()
    for r in results[:4]:
        print(f"[serve] req {r.uid}: prefill {r.prefill_s*1e3:.1f}ms "
              f"decode {r.decode_s*1e3:.1f}ms "
              f"({r.tokens_per_s:.1f} tok/s) -> {r.tokens[:8].tolist()}")
    # Aggregate decode throughput: one decode wall per wave (results in the
    # same wave share one decode_s), not a per-request double count.
    wave_decode = {r.wave_id: r.decode_s for r in results}
    tput = sum(len(r.tokens) for r in results) / max(sum(wave_decode.values()), 1e-9)
    print(f"[serve] {len(results)} requests done, "
          f"aggregate decode throughput {tput:.1f} tok/s")
    return results


if __name__ == "__main__":
    main()
