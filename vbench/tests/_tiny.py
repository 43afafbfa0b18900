"""Cells of the benchmark cut to sizes a CPU test run holds, and cells
that only new files under a temporary directory define."""

import copy
import json
import shutil
from pathlib import Path

from vbench import harness

TINY = {
    "prod.refine.cuda": {"num_topics": 40, "base_vocab": 60, "vocab_size": 300,
                         "products": [{"count": 1, "reviews": 200, "tokens": 20000}]},
    # auto routes a fit of 100,000 tokens or more to the alias sampler
    "prod.refine.alias": {"num_topics": 40, "base_vocab": 200, "vocab_size": 1000,
                          "products": [{"count": 1, "reviews": 2000, "tokens": 120000}]},
    # zamba2-2.7b's smoke-test widths (`ArchConfig.reduced`): one group of
    # two Mamba2 layers, GQA (4 heads over 2), a 64-slot ring
    "zamba2.serve.docqa": {"num_layers": 2, "d_model": 128, "num_heads": 4, "num_kv_heads": 2,
                           "head_dim": 32, "d_ff": 256, "vocab_size": 512, "ssm_state": 16,
                           "ssm_heads": 4, "ssm_head_dim": 32, "hybrid_attn_every": 2,
                           "sliding_window": 64},
}
#: The mixes' steps at a CPU test's size.
TINY_MIX = {"zamba2.serve.docqa": {"serve": {"cache_len": 64},
                                   "request": {"lengths": [23, 31, 40, 47]}}}

#: A zoo of small products at K 12 in two sizes, so the batch engine
#: stacks them in two buckets.
ZOO = {"name": "zoo-tiny", "source": "a test's size", "inputs": "rlda_products",
       "num_topics": 12, "base_vocab": 50, "tiers": 5, "vocab_size": 250, "alpha": 0.1,
       "beta": 0.01, "w_bits": 8, "zipf_exponent": 1.0, "reduced": [], "assumed": {},
       "products": [{"count": 3, "reviews": 30, "tokens": 300},
                    {"count": 3, "reviews": 60, "tokens": 600}]}
ZOO_MIX = {"serve": None,
           "request": {"verb": "fit_batch_prepared", "backend": "auto", "sweeps": 4}}


def copy_benchmark(dest: Path) -> dict:
    """A checkout under `dest` with the benchmark's files and
    `BENCHMARK.json`; returns the parsed `BENCHMARK.json`."""
    shutil.copytree(harness.REPO / "vbench", dest / "vbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(harness.REPO / "BENCHMARK.json", dest)
    return harness.load_benchmark(dest)


def add_cell(root: Path, bench: dict, cell: str, config: dict, mix_name: str, mix: dict,
             limits: dict, check: str = "") -> None:
    """Define `cell` by new files and entries only: its configuration,
    mix and cell files (naming `check`, if given), and its entries in
    `bench`, written back."""
    home = root / "vbench"
    (home / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
    (home / "traffic" / f"{mix_name}.json").write_text(json.dumps(mix))
    spec = {"check": check, "limits": limits} if check else {"limits": limits}
    (home / "workloads" / f"{cell}.json").write_text(json.dumps(spec))
    bench["configs"].append({"name": config["name"], "source": "s", "reduced": [], "why": "w",
                             "file": f"vbench/configs/{config['name']}.json"})
    bench["workloads"].append({"name": cell, "config": config["name"], "traffic": mix_name,
                               "chips": 1, "why": "w"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def zoo_checkout(dest: Path) -> Path:
    """A checkout whose benchmark also has the tiny zoo cell
    `zoo.fit.batched`, in new files only."""
    bench = copy_benchmark(dest)
    add_cell(dest, bench, "zoo.fit.batched", ZOO, "fit.batched", ZOO_MIX, {"count_dev": 2.0})
    return dest


def tiny_cell(name: str, root: Path = harness.REPO):
    """The cell `name` at a CPU test's size."""
    cell = harness.load_cell(name, root)
    cell.config.update(copy.deepcopy(TINY.get(name, {})))
    for step, update in TINY_MIX.get(name, {}).items():
        cell.mix[step].update(copy.deepcopy(update))
    return cell


def run_tiny(name: str, root: Path = harness.REPO, seed: int = 2147483999,
             seconds: float = 0.3, trace: bool = False):
    """One run of the tiny cell on the CPU, its first request tapped (the
    sweep check's sample)."""
    cell = tiny_cell(name, root)
    if hasattr(cell.check, "FIRST"):
        cell.check.FIRST = 1
    return harness.run_cell(cell, seed, seconds, trace, device="cpu", log=lambda m: None)
