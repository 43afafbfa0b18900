#!/usr/bin/env python3
"""Time the AliasLDA MH kernel's entries of one or more source trees on one
CUDA card, one process a tree, in the order given.

    python3 tools/alias_mh_ab.py [TREE ...]     (default: this checkout)

A tree is a directory holding `src/repro_torch` (this checkout, or an
earlier commit unpacked with `git archive` under the git-ignored `build/`).
Every tree's kernel is built first, all builds started together. Then each
tree in turn, in a process of its own that imports that tree's
`repro_torch`, launches `kernel.launch` / `kernel.launch_many` at four
shapes, S = 4 MH rounds, on inputs made from numpy seed 0 (the alias tables
from the tree's own `core.alias.sweep_tables`):

  single   N 600,193, K 12, D = V = 10,000, int32 fixed-point tables (the
           popular product of `chip_smoke.py`'s `large_fit` phase)
  packed   the same with float32 tables (the packed `alias` int8 sweep's
           decoded, fake-quantized tables)
  batched  M 32 x 65,536 slots, K 12, D 1,024, V 4,000, int32 tables, each
           model's slots past its length (32,768 to 65,536) weight-0 padding
           (the zoo's larger bucket on `alias`)
  case     N 29,232, K 12, D 487, V 4,000, int32 tables (the case study on
           `alias`: all its tokens in one launch)

in the injected mode, which every tree's `launch` takes, and in the Philox
mode where the tree's `launch` takes a `philox` key; where it also takes a
`body`, each of the direct body and the log tables beside the body the
kernel picks. Times are ms a launch: `ms` by CUDA events over 200 raw
launches, `graph_ms` over 20 launches replayed from a CUDA graph (device
time with no host gaps), as `chip_smoke.py` times them. Every tree's topics
in the injected mode must equal the first tree's, and every body's the
picked one's (`differ` counts the tokens that do not). Prints the card's
name and power limit, then one JSON line a tree; exits non-zero without a
card or when topics differ.
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
SHAPES = {"single": (1, 600_193, 10_000, 10_000, 8),
          "packed": (1, 600_193, 10_000, 10_000, None),
          "batched": (32, 65_536, 1_024, 4_000, 8),
          "case": (1, 29_232, 487, 4_000, 8)}  # m, n, d, v, w_bits
K, S = 12, 4


def inputs(shape: str) -> dict:
    """Ids, count and alias tables, draws and Philox keys of one shape on the
    card: documents in order, words from a Zipf law."""
    import numpy as np
    import torch

    from repro_torch.core import alias
    from repro_torch.core.types import LDAConfig

    m, n, d, v, w_bits = SHAPES[shape]
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
    scale = 1.0
    if w_bits is not None:
        scale = 2.0 ** -(w_bits + 1)
        n_dt, n_wt = (np.round(x / scale) * scale for x in (n_dt, n_wt))
    n_t = n_wt.sum(1, dtype=np.float32)
    cfg = LDAConfig(num_topics=K, vocab_size=v, num_docs=d)
    tables = alias.sweep_tables(cfg, torch.tensor(n_dt, device="cuda"),
                                torch.tensor(n_wt, device="cuda"))
    if w_bits is not None:
        n_dt, n_wt, n_t = (np.round(x / scale).astype(np.int32) for x in (n_dt, n_wt, n_t))
    draws = (rng.integers(0, K, (m, S, n)).astype(np.int32),
             rng.random((m, S, n)).astype(np.float32), rng.random((m, S, n)).astype(np.float32))
    keys = np.stack([np.arange(m) * 7919 + 5, np.arange(m) * 4 + 8], 1).astype(np.int64)

    def dev(a):
        return torch.tensor(a if m > 1 else a[0], device="cuda")

    tables = tuple(t if m > 1 else t[0].contiguous() for t in tables)
    return dict(m=m, args=[dev(a) for a in (docs, words, z, weights, n_dt, n_wt, n_t)]
                + list(tables), draws=[dev(a) for a in draws],
                keys=torch.tensor(keys, device="cuda"),
                hp=dict(alpha=0.1, beta=0.01, beta_bar=0.01 * v, scale=scale))


def worker(tree: Path, out: Path) -> dict:
    """Time `tree`'s kernel; its topics go to `out` (one .pt)."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.kernels.alias_mh import kernel

    params = inspect.signature(kernel.launch).parameters
    philox, bodies = "philox" in params, ("body" in params)
    times, topics = {}, {}
    for shape in SHAPES:
        inp = inputs(shape)
        many = inp["m"] > 1
        launch = kernel.launch_many if many else kernel.launch
        key = inp["keys"] if many else (5, 8)
        modes = [("injected", inp["draws"], {})]
        if philox:
            modes.append(("philox", [None] * 3, {"philox": key, "mh_steps": S}))
        for mode, draws, extra in modes:
            for body in ("auto", "direct", "tables") if bodies else ("auto",):
                z_out = torch.empty_like(inp["args"][2])
                kw = dict(extra, body=body) if bodies else extra

                def run(draws=draws, kw=kw, z_out=z_out, inp=inp, launch=launch):
                    launch(*inp["args"], *draws, z_out, **inp["hp"], **kw)

                name = f"{shape}/{mode}" + ("" if body == "auto" else f"/{body}")
                times[name] = {"ms": cuda_ms(run), "graph_ms": graph_ms(run)}
                run()
                torch.cuda.synchronize()
                topics[name] = z_out.cpu()
    torch.save(topics, out)
    return {"tree": str(tree), "philox": philox, "bodies": bodies, "times": times}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--build"]:
        sys.path.insert(0, str(Path(argv[1]) / "src"))
        from repro_torch.kernels.alias_mh import kernel

        kernel.build()
        return 0
    if argv[:1] == ["--worker"]:
        print(json.dumps(worker(Path(argv[1]), Path(argv[2]))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("alias_mh_ab: no CUDA device", file=sys.stderr)
        return 2
    trees = [Path(t).resolve() for t in argv] or [ROOT]
    print(card_line(), flush=True)
    with ThreadPoolExecutor(max_workers=len(trees)) as pool:
        list(pool.map(lambda t: subprocess.run([sys.executable, __file__, "--build", str(t)],
                                               check=True), set(trees)))
    out_dir = ROOT / "build" / "alias_mh_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    first, failed = None, False
    for i, tree in enumerate(trees):
        out = out_dir / f"{i}.pt"
        proc = subprocess.run([sys.executable, __file__, "--worker", str(tree), str(out)],
                              capture_output=True, text=True, check=True)
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        topics = torch.load(out)
        first = first or topics
        row["differ"] = {s: int((topics[f"{s}/injected"] != first[f"{s}/injected"]).sum())
                         for s in SHAPES}
        row["differ_bodies"] = {name: int((z != topics[name.rsplit("/", 1)[0]]).sum())
                                for name, z in topics.items()
                                if name.endswith(("/direct", "/tables"))}
        failed |= any(row["differ"].values()) or any(row["differ_bodies"].values())
        print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
