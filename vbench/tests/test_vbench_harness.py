"""The harness finds every piece by name, takes a cell that only new files
define (a new configuration, input generator, mix, verb and metric), refuses
to measure without a card, names every kernel of a family, and loads
nothing of JAX."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
from _tiny import add_cell, copy_benchmark, run_tiny

from vbench import harness, readers, run

ROOT = harness.REPO
BENCH = harness.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vbench"] and 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("vbench/") and (ROOT / c["file"]).is_file()
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m.get("bound", 0.01) <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_piece_is_found_by_name(name):
    cell = harness.load_cell(name, ROOT)
    assert cell.verbs["request"].__file__.endswith(f"verbs/{cell.mix['request']['verb']}.py")
    assert callable(cell.verbs["request"].issue)
    if cell.mix.get("serve"):
        assert callable(cell.verbs["serve"].serve)
    assert callable(cell.make_inputs)
    assert {"source", "assumed", "reduced", "inputs"} <= set(cell.config)
    assert cell.end_to_end and cell.per_layer
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m["read"])
        assert (ROOT / "vbench" / "metrics" / f"{m['name']}.py").is_file()
    assert set(cell.limits) == {"count_dev"}


#: A request verb that only a new file defines: waves of one fit a product,
#: each released, which bypass the batch engine.
FIT_EACH = """
from vbench.check import Product
from vbench.loop import Done


def issue(session, spec, seed, keep):
    kept, service = [], session.service
    for i, prep in enumerate(session.inputs):
        h = service.fit_prepared(prep, backend=spec["backend"], num_sweeps=spec["sweeps"],
                                 seed=seed + i)
        kept.append(Product(h.cfg, h.model.corpus, None, h.model.state))
        service.release(h)
    return Done(spec["sweeps"], spec["sweeps"] * session.live_tokens, len(kept),
                kept if keep else None)
"""


def test_a_cell_of_new_files_loads_and_runs_without_an_edit(tmp_path):
    bench = copy_benchmark(tmp_path)
    home = tmp_path / "vbench"
    before = {p: p.read_bytes() for p in (ROOT / "vbench").rglob("*") if p.is_file()}
    (home / "verbs" / "fit_each.py").write_text(FIT_EACH)
    shutil.copy(home / "inputs" / "rlda_products.py", home / "inputs" / "products_copy.py")
    (home / "metrics" / "models_per_wave.py").write_text(
        "def read(ctx):\n    return sum(r.models for r in ctx.requests) / len(ctx.requests)\n")
    config = {"name": "small-k8", "source": "s", "inputs": "products_copy", "num_topics": 8,
              "base_vocab": 40, "tiers": 5, "vocab_size": 200, "alpha": 0.1, "beta": 0.01,
              "w_bits": 8, "zipf_exponent": 1.0, "reduced": [], "assumed": {},
              "products": [{"count": 2, "reviews": 20, "tokens": 400}]}
    mix = {"serve": None, "request": {"verb": "fit_each", "backend": "cuda", "sweeps": 3}}
    bench["per_layer"].append({"name": "models_per_wave", "unit": "models", "better": "higher",
                               "source": "host_clock", "layer": "service",
                               "moves": "fit_tokens_per_s", "workloads": ["small.fit.each"]})
    next(m for m in bench["end_to_end"] if m["name"] == "fit_tokens_per_s")["workloads"].append(
        "small.fit.each")
    add_cell(tmp_path, bench, "small.fit.each", config, "fit.each", mix, {"count_dev": 2.0})

    cell = harness.load_cell("small.fit.each", tmp_path)
    assert cell.config["num_topics"] == 8 and cell.mix["request"]["verb"] == "fit_each"
    assert [m["name"] for m in cell.end_to_end] == ["fit_tokens_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["models_per_wave"]
    res = run_tiny("small.fit.each", tmp_path)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["checks"]["sweeps_missing"]["value"] == 0
    assert {p: p.read_bytes() for p in (ROOT / "vbench").rglob("*") if p.is_file()} == before


def test_a_missing_verb_is_named(tmp_path):
    bench = copy_benchmark(tmp_path)
    cfg = json.loads((ROOT / BENCH["configs"][0]["file"]).read_text())
    cfg["name"] = "prod-copy"
    add_cell(tmp_path, bench, "prod.nothing", cfg, "nothing",
             {"serve": None, "request": {"verb": "no_such_verb", "sweeps": 1}}, {})
    with pytest.raises(FileNotFoundError, match="no_such_verb"):
        harness.load_cell("prod.nothing", tmp_path)


def test_run_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc = run.main(["--workload", "prod.refine.cuda", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "CUDA" in out.err


def test_run_needs_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files,
    the command exits nonzero and prints no result."""
    shutil.copytree(ROOT / "vbench", tmp_path / "vbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, "vbench/run.py", "--workload", "prod.refine.cuda",
                           "--seed", "1", "--seconds", "1"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_readers_refuse_a_cpu_run():
    from vbench.loop import Request

    ctx = readers.Context("cpu", 1.0, 1.0, [Request(0, 0.0, 1.0, 3, 300, 0)],
                          {"num_topics": 12}, [], alias_rounds=4)
    for path in sorted((ROOT / "vbench" / "metrics").glob("*.py")):
        assert harness.load_reader(path)(ctx) is None, path.name


def test_import_guard_compares_whole_top_level_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.api.service", "reprox",
                                  "jaxtyping", "jaxlib.xla_client", "repro.core.gibbs",
                                  "flax"]) == ["flax", "jaxlib", "repro"]
    assert run.forbidden_modules(["repro_torch", "repro_torch.kernels"]) == []


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix() for p in
                                        (ROOT / "vbench").rglob("*.py")
                                        if "tests" not in p.parts))
def test_no_source_of_the_benchmark_imports_jax_or_the_reference(path):
    assert not _imported_roots(ROOT / path) & (run.FORBIDDEN | {"benchmarks"})


def test_the_run_path_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['.', 'src']; "
            "from vbench import harness, check, loop, readers, traceview, tap; "
            "from vbench.run import forbidden_modules; "
            "[harness.load_cell(w['name']) for w in harness.load_benchmark()['workloads']]; "
            "import repro_torch.api.service, repro_torch.serving.batch_engine; "
            "print(forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(")


@pytest.mark.parametrize("family,names", [("lda_gibbs", readers.GIBBS_KERNELS),
                                          ("alias_mh", readers.ALIAS_KERNELS)])
def test_every_kernel_of_a_family_is_listed(family, names):
    """Each `__global__` kernel of the family's CUDA source is in its list
    (or is a test entry), and no list names another family's kernel."""
    src = ROOT / "src" / "repro_torch" / "kernels" / family / "csrc" / f"{family}.cu"
    found = set(_GLOBAL.findall(src.read_text()))
    assert found == set(names) | set(readers.TEST_ONLY), src
    assert not set(readers.GIBBS_KERNELS) & set(readers.ALIAS_KERNELS)
