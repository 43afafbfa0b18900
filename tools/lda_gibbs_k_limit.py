#!/usr/bin/env python3
"""Launch the Gibbs resample kernel's K > 32 body near the top of its K
range, for one or more source trees on one CUDA card, one process a tree.

    python3 tools/lda_gibbs_k_limit.py [TREE ...]     (default: this checkout)

A tree is a directory holding `src/repro_torch` (this checkout, or an
earlier commit unpacked with `git archive` under the git-ignored `build/`).
The body keeps 2 K floats of dynamic shared memory a block: 48 KB at K
6,144, past the 48 KB a kernel has without opting in from K 6,145, 64 KB at
the 8,192 the entries admit. Each tree's single entry (`kernel.launch`) and
batched entry (`kernel.launch_many`, M 2) run at K 6,144, 6,145 and 8,192
on N 4,096 tokens, D 64, V 512 (float32 tables, inputs from numpy seed 0),
with injected noise and with Philox noise drawn in the kernel. A launch the
card refuses is reported with its error (`refused`); a launch that runs is
held against the tree's plain version (`ops.resample_plain` /
`resample_many_plain`, in the Philox mode on `ops.philox_noise` of the same
key): `mismatch` counts tokens that differ by more than a near-tie (score
gap 1e-5), and its ms (CUDA events over 20 raw launches) is given.

Prints the card's name and power limit, then one JSON line a tree; exits
non-zero without a card or when a launch that ran disagrees.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from _timing import card_line, cuda_ms

ROOT = Path(__file__).resolve().parents[1]
KS = (6144, 6145, 8192)
N, D, V, M = 4096, 64, 512, 2
NEAR_TIE = 1e-5


def inputs(m: int, k: int) -> tuple:
    """Ids, float32 count tables and Gumbel noise of M models (m > 1) or
    one, on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    docs = rng.integers(0, D, (m, N)).astype(np.int32)
    words = rng.integers(0, V, (m, N)).astype(np.int32)
    z = rng.integers(0, k, (m, N)).astype(np.int32)
    weights = rng.uniform(0.2, 1.0, (m, N)).astype(np.float32)
    n_dt = rng.gamma(0.6, 4.0, (m, D, k)).astype(np.float32)
    n_wt = rng.gamma(0.4, 2.0, (m, V, k)).astype(np.float32)
    noise = rng.gumbel(size=(m, N, k)).astype(np.float32)
    arrays = (docs, words, z, weights, n_dt, n_wt, n_wt.sum(1), noise)
    return tuple(torch.tensor(a if m > 1 else a[0], device="cuda") for a in arrays)


def check(ops, kernel, m: int, k: int, philox) -> dict:
    """One entry at one K in one noise mode: refused, or its mismatches
    against the plain version and its ms."""
    import torch

    many = m > 1
    args = inputs(m, k)
    ids, noise = args[:7], args[7]
    hp = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * V)
    z_out = torch.empty_like(ids[2])
    launch = kernel.launch_many if many else kernel.launch
    key = None if philox is None else (
        torch.tensor([[philox[0] + i, philox[1]] for i in range(m)], dtype=torch.int64,
                     device="cuda") if many else philox)

    def run():
        launch(*ids, noise if key is None else None, z_out, scale=1.0,
               philox=key if many else (key or (0, 0)), **hp)

    try:
        run()
        torch.cuda.synchronize()
    except RuntimeError as err:
        return {"refused": str(err)}
    g = noise if key is None else ops.philox_noise(ids[2], ids[6], key)
    plain = ops.resample_many_plain if many else ops.resample_plain
    z_p = plain(*ids, g, **hp)
    scores = ops.perturbed_scores(*ids, g, **hp).reshape(-1, k)
    z_k, z_p = z_out.reshape(-1).long(), z_p.reshape(-1).long()
    gap = scores.gather(1, z_p[:, None])[:, 0] - scores.gather(1, z_k[:, None])[:, 0]
    bad = (z_k != z_p) & (gap >= NEAR_TIE)
    return {"mismatch": int(bad.sum()), "near_tie_flips": int(((z_k != z_p) & ~bad).sum()),
            "ms": cuda_ms(run, reps=20)}


def worker(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels.lda_gibbs import kernel, ops

    kernel.build()
    out = {}
    for entry, m in (("single", 1), ("batched", M)):
        for k in KS:
            for mode, philox in (("injected", None), ("philox", (12345, 4 * k))):
                out[f"{entry}/K{k}/{mode}"] = {"smem_bytes": 2 * k * 4,
                                              **check(ops, kernel, m, k, philox)}
    return {"tree": str(tree), "checks": out}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--worker"]:
        print(json.dumps(worker(Path(argv[1]))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("lda_gibbs_k_limit: no CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    failed = False
    for tree in [Path(t).resolve() for t in argv] or [ROOT]:
        proc = subprocess.run([sys.executable, __file__, "--worker", str(tree)],
                              capture_output=True, text=True, check=True)
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        failed |= any(c.get("mismatch", 0) for c in row["checks"].values())
        print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
