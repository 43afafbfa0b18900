#!/usr/bin/env python3
"""Time the Gibbs resample kernel's entries (exact and packed-table) of one
or more source trees on one CUDA card, one process a tree, in the order
given.

    python3 tools/lda_gibbs_ab.py [TREE ...]     (default: this checkout)

A tree is a directory holding `src/repro_torch` (this checkout, or an
earlier commit unpacked with `git archive` under the git-ignored `build/`).
Every tree's kernel is built first, all builds started together. Then each
tree in turn, in a process of its own that imports that tree's
`repro_torch`, launches `kernel.launch` / `kernel.launch_many` at four
shapes and `kernel.launch_quant` at four more, on inputs made from numpy
seed 0:

  single   N 600,193, K 12, D = V = 10,000, int32 fixed-point tables (the
           popular product of `chip_smoke.py`'s `scale` phase)
  batched  M 32 x 65,536 slots, K 12, D 1,024, V 4,000, int32 tables, each
           model's slots past its length (32,768 to 65,536) weight-0 padding
           (the zoo's larger bucket)
  block    N 4,096, K 12, D 487, V 4,000, float32 tables (one block of the
           case study on the `torch` route)
  case     N 29,232, K 12, D 487, V 4,000, int32 tables (all of the case
           study's tokens in one launch, as the `cuda` route takes them)
  quant8, quant4
           `single` with its word table packed to int8 / int4 codes and row
           scales (the popular product's packed `cuda` sweep)
  case8, case4
           `case` packed the same way (the case study's packed sweep)

in the injected mode, which every tree's entries take, and in the Philox
mode where the tree's `launch` (`launch_quant`) takes a `philox` key. Times are ms a launch:
`ms` by CUDA events over 200 raw launches, `graph_ms` over 20 launches
replayed from a CUDA graph (device time with no host gaps), as
`chip_smoke.py` times them. Every tree's topics in the injected mode must
equal the first tree's (`differ` counts the tokens that do not). Prints the
card's name and power limit, then one JSON line a tree; exits non-zero
without a card or when topics differ.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from _timing import card_line, cuda_ms, graph_ms

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"single": (1, 600_193, 10_000, 10_000, 8, None),
          "batched": (32, 65_536, 1_024, 4_000, 8, None),
          "block": (1, 4_096, 487, 4_000, None, None),
          "case": (1, 29_232, 487, 4_000, 8, None),
          "quant8": (1, 600_193, 10_000, 10_000, 8, 8),
          "quant4": (1, 600_193, 10_000, 10_000, 8, 4),
          "case8": (1, 29_232, 487, 4_000, 8, 8),
          "case4": (1, 29_232, 487, 4_000, 8, 4)}  # m, n, d, v, w_bits, packed bits
K = 12


def pack(real, bits: int):
    """A real-unit (V, K) table row-quantized as the packed sweep does it:
    scale = max / levels, codes = clip(rint(x / scale)) (0 for an all-zero
    row), nibble-packed low first for 4 bits."""
    import numpy as np

    levels = np.float32((1 << bits) - 1)
    x = np.maximum(real.astype(np.float32), np.float32(0))
    scales = (x.max(axis=-1) / levels).astype(np.float32)
    safe = np.where(scales > 0, scales, np.float32(1))[:, None]
    codes = np.clip(np.rint(x / safe), 0, levels).astype(np.uint8)
    if bits == 4:
        codes = np.pad(codes, ((0, 0), (0, codes.shape[1] % 2)))
        codes = (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(np.uint8)
    return codes, scales


def inputs(shape: str) -> dict:
    """Ids, count tables, noise and Philox keys of one shape on the card:
    documents in order, words from a Zipf law."""
    import numpy as np
    import torch

    m, n, d, v, w_bits, bits = SHAPES[shape]
    rng = np.random.default_rng(0)
    docs = np.sort(rng.integers(0, d, (m, n)), axis=1).astype(np.int32)
    words = ((rng.zipf(1.3, (m, n)) - 1) % v).astype(np.int32)
    z = rng.integers(0, K, (m, n)).astype(np.int32)
    weights = rng.uniform(0.2, 1.0, (m, n)).astype(np.float32)
    if m > 1:
        lengths = rng.integers(n // 2, n + 1, m)
        weights[np.arange(n)[None, :] >= lengths[:, None]] = 0.0
    n_dt = rng.gamma(0.6, 4.0, (m, d, K)).astype(np.float32)
    n_wt = rng.gamma(0.4, 2.0, (m, v, K)).astype(np.float32)
    n_t = n_wt.sum(1)
    scale = 1.0
    if w_bits is not None:
        scale = 2.0 ** -(w_bits + 1)
        n_dt, n_wt, n_t = (np.round(x / scale).astype(np.int32) for x in (n_dt, n_wt, n_t))
    noise = rng.gumbel(size=(m, n, K)).astype(np.float32)
    keys = np.stack([np.arange(m) * 7919 + 5, np.arange(m) * 4 + 8], 1).astype(np.int64)
    t = [torch.tensor(a if m > 1 else a[0], device="cuda")
         for a in (docs, words, z, weights, n_dt, n_wt, n_t, noise)]
    hp = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * v, scale=scale)
    args = t[:7]
    if bits is not None:
        codes, scales = pack(n_wt[0] * np.float32(scale), bits)
        args = [*t[:5], torch.tensor(codes, device="cuda"), torch.tensor(scales, device="cuda"),
                t[6]]
        hp["bits"] = bits
    return dict(m=m, bits=bits, args=args, noise=t[7], keys=torch.tensor(keys, device="cuda"),
                hp=hp)


def worker(tree: Path, out: Path) -> dict:
    """Time `tree`'s kernel; its injected topics go to `out` (one .pt)."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.kernels.lda_gibbs import kernel

    philox = {name: "philox" in inspect.signature(getattr(kernel, name)).parameters
              for name in ("launch", "launch_quant")}
    times, topics = {}, {}
    for shape in SHAPES:
        inp = inputs(shape)
        many = inp["m"] > 1
        launch = kernel.launch_many if many else (
            kernel.launch if inp["bits"] is None else kernel.launch_quant)
        key = inp["keys"] if many else (5, 8)
        modes = (("injected", inp["noise"], {}),)
        if philox["launch" if inp["bits"] is None else "launch_quant"]:
            modes += (("philox", None, {"philox": key}),)
        for mode, noise, extra in modes:
            z_out = torch.empty_like(inp["args"][2])

            def run(noise=noise, extra=extra, z_out=z_out, inp=inp, launch=launch):
                launch(*inp["args"], noise, z_out, **inp["hp"], **extra)

            times[f"{shape}/{mode}"] = {"ms": cuda_ms(run), "graph_ms": graph_ms(run)}
            run()
            torch.cuda.synchronize()
            if mode == "injected":
                topics[shape] = z_out.cpu()
    torch.save(topics, out)
    return {"tree": str(tree), "philox": philox, "times": times}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--build"]:
        sys.path.insert(0, str(Path(argv[1]) / "src"))
        from repro_torch.kernels.lda_gibbs import kernel

        kernel.build()
        return 0
    if argv[:1] == ["--worker"]:
        print(json.dumps(worker(Path(argv[1]), Path(argv[2]))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("lda_gibbs_ab: no CUDA device", file=sys.stderr)
        return 2
    trees = [Path(t).resolve() for t in argv] or [ROOT]
    print(card_line(), flush=True)
    with ThreadPoolExecutor(max_workers=len(trees)) as pool:
        list(pool.map(lambda t: subprocess.run([sys.executable, __file__, "--build", str(t)],
                                               check=True), set(trees)))
    out_dir = ROOT / "build" / "lda_gibbs_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    first, failed = None, False
    for i, tree in enumerate(trees):
        out = out_dir / f"{i}.pt"
        proc = subprocess.run([sys.executable, __file__, "--worker", str(tree), str(out)],
                              capture_output=True, text=True, check=True)
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        topics = torch.load(out)
        first = first or topics
        row["differ"] = {s: int((topics[s] != first[s]).sum()) for s in SHAPES}
        failed |= any(row["differ"].values())
        print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
