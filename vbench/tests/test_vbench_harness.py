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
from _tiny import TINY, TINY_MIX, add_cell, copy_benchmark, run_tiny

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


def assert_pieces(cell: harness.Cell, root: Path) -> None:
    """What every cell needs of its pieces, found by name under `root`."""
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
        assert (root / "vbench" / "metrics" / f"{m['name']}.py").is_file()
    for part in ("Tap", "check", "verdict", "unread", "context"):
        assert callable(getattr(cell.check, part)), part
    assert isinstance(cell.check.LIMITS, frozenset)
    assert set(cell.limits) == cell.check.LIMITS


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_piece_is_found_by_name(name):
    assert_pieces(harness.load_cell(name, ROOT), ROOT)


#: The limits each check of the repository declares (its other numbers are
#: exact, limit 0).
CHECK_LIMITS = {"sweeps": {"count_dev"},
                "logits": {"logit_dev", "token_gap", "mixer_dev", "state_dev"}}


@pytest.mark.parametrize("check", sorted(CHECK_LIMITS))
def test_each_check_declares_the_limits_it_reads(check):
    """A check's `LIMITS` are exactly the numbers its verdict holds to a
    cell's limits: the rest keep the limit 0."""
    mod = harness.load_module(ROOT / "vbench" / "checks" / f"{check}.py")
    assert mod.LIMITS == CHECK_LIMITS[check]
    _, table = mod.verdict(mod.unread({}), dict.fromkeys(mod.LIMITS, 1.0))
    assert {name for name, row in table.items() if row["limit"] == 1.0} == mod.LIMITS
    assert all(row["limit"] == 0.0 for name, row in table.items() if name not in mod.LIMITS)


#: What each RLDA cell reported before a cell could bring its own check:
#: its metrics, in order, and their readers.
RLDA_METRICS = {
    "prod.refine.cuda": ["fit_tokens_per_s", "refine_p95_ms", "setup_s",
                         "launches_per_sweep.prod", "gibbs_roofline.prod",
                         "device_idle_share.prod", "sweep_mfu.prod", "rebuild_ms_per_sweep.prod",
                         "service_idle_ms_per_request.prod"],
    "prod.refine.alias": ["fit_tokens_per_s", "refine_p95_ms", "setup_s",
                          "launches_per_sweep.prod", "alias_roofline.prod",
                          "device_idle_share.prod", "sweep_mfu.prod", "rebuild_ms_per_sweep.prod",
                          "alias_tables_ms_per_sweep.prod", "service_idle_ms_per_request.prod"],
}
RLDA_READERS = {"fit_tokens_per_s": readers.tokens_per_s, "refine_p95_ms": readers.request_p95_ms,
                "setup_s": readers.setup_s, "launches_per_sweep.prod": readers.launches_per_sweep,
                "gibbs_roofline.prod": readers.gibbs_roofline,
                "alias_roofline.prod": readers.alias_roofline,
                "device_idle_share.prod": readers.idle_share, "sweep_mfu.prod": readers.sweep_mfu}


@pytest.mark.parametrize("name", sorted(RLDA_METRICS))
def test_the_rlda_cells_keep_the_sweep_check_metrics_and_readers(name):
    from vbench import check, tap

    cell = harness.load_cell(name, ROOT)
    assert Path(cell.check.__file__) == ROOT / "vbench" / "checks" / "sweeps.py"
    assert issubclass(cell.check.Tap, tap.SweepTap) and cell.check.verdict is check.verdict
    assert cell.limits == {"count_dev": 2.0}
    assert [m["name"] for m in cell.end_to_end + cell.per_layer] == RLDA_METRICS[name]
    for m in cell.end_to_end + cell.per_layer:
        if m["name"] in RLDA_READERS:
            assert m["read"] is RLDA_READERS[m["name"]], m["name"]
    # the sweep check's sample: one request drawn among the first 8, as before
    import random

    seed = harness.sub_seed(2147483999, "check")
    armed = cell.check.Tap(random.Random(seed)).armed
    assert armed == set(random.Random(seed).sample(range(8), 1))


def test_the_serving_config_holds_the_registered_widths():
    """Every `ArchConfig` field the file gives is the port's registered
    value: nothing is cut (`reduced` is empty)."""
    import dataclasses

    from repro_torch import configs

    cfg = json.loads((ROOT / "vbench" / "configs" / "zamba2-2.7b.json").read_text())
    reg = configs.get(cfg["arch"])
    given = [f.name for f in dataclasses.fields(reg) if f.name in cfg]
    assert len(given) >= 20 and cfg["reduced"] == []
    assert {f: cfg[f] for f in given} == {f: getattr(reg, f) for f in given}


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


def _snapshot() -> dict:
    """The bytes of every file of the benchmark in the repository."""
    return {p: p.read_bytes() for p in [ROOT / "BENCHMARK.json", *(ROOT / "vbench").rglob("*")]
            if p.is_file()}


def test_a_cell_of_new_files_loads_and_runs_without_an_edit(tmp_path):
    bench = copy_benchmark(tmp_path)
    home = tmp_path / "vbench"
    before = _snapshot()
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
    assert _snapshot() == before


#: A metric that only a new file defines: completed waves a second.
WAVES_PER_S = """
def read(ctx):
    waves = [w for r in ctx.requests if r.error is None for w in r.waves]
    return len(waves) / ctx.window_s if waves and ctx.window_s > 0 else None
"""


#: What a copy of the `logits` check adds: a limit that no check of the
#: repository declares, and a number that it holds to it.
COPY_DEV = """

LIMITS = LIMITS | {"copy_dev"}
_logits_numbers = check


def check(cell, inputs, tap, products, control=None):
    return {**_logits_numbers(cell, inputs, tap, products, control), "copy_dev": 0.0}
"""
SERVE_CELL = "smoke.serve.short"
SERVE_LIMITS = {"logit_dev": 1.0, "token_gap": 1.0, "mixer_dev": 0.05, "state_dev": 0.05,
                "copy_dev": 0.05}


def serving_checkout(root: Path, limits: dict = SERVE_LIMITS, check_tail: str = COPY_DEV) -> None:
    """A checkout under `root` whose benchmark also has `SERVE_CELL`: a
    served model at smoke-test widths with its own configuration, input
    generator, verbs, metric and check (`logits_copy`: the `logits` check
    and `check_tail`), each a new file, and new entries."""
    bench = copy_benchmark(root)
    home = root / "vbench"
    for kind, src, dst in (("inputs", "lm_weights", "lm_copy"), ("verbs", "serve_engine", "engine_copy"),
                           ("verbs", "waves", "waves_copy")):
        shutil.copy(home / kind / f"{src}.py", home / kind / f"{dst}.py")
    (home / "checks" / "logits_copy.py").write_text(
        (home / "checks" / "logits.py").read_text() + check_tail)
    (home / "metrics" / "waves_per_s.py").write_text(WAVES_PER_S)
    config = json.loads((home / "configs" / "zamba2-2.7b.json").read_text())
    config.update(TINY["zamba2.serve.docqa"], name="hybrid-smoke", inputs="lm_copy")
    mix = json.loads((home / "traffic" / "serve.docqa.json").read_text())
    mix["serve"].update(TINY_MIX["zamba2.serve.docqa"]["serve"], verb="engine_copy")
    mix["request"].update(verb="waves_copy", lengths=[19, 40])
    bench["per_layer"].append({"name": "waves_per_s", "unit": "waves/s", "better": "higher",
                               "source": "host_clock", "layer": "service",
                               "moves": "serve_tokens_per_s", "workloads": [SERVE_CELL]})
    for m in bench["end_to_end"]:
        if m["name"] in ("serve_tokens_per_s", "ttft_mean_ms"):
            m["workloads"].append(SERVE_CELL)
    add_cell(root, bench, SERVE_CELL, config, "serve.short", mix, limits, check="logits_copy")


def test_a_serving_cell_of_new_files_loads_and_runs_without_an_edit(tmp_path):
    """A cell that brings its own check, with a limit that no check of the
    repository declares, and its own served system: a configuration, an
    input generator, a serve verb that builds an `Engine`, a request verb,
    a check module and a metric, each a new file, run on the CPU at
    smoke-test widths."""
    before = _snapshot()
    serving_checkout(tmp_path)
    repo_limits = set().union(*(harness.load_module(p).LIMITS
                                for p in (ROOT / "vbench" / "checks").glob("*.py")))
    assert "copy_dev" not in repo_limits

    loaded = harness.load_cell(SERVE_CELL, tmp_path)
    assert_pieces(loaded, tmp_path)
    assert Path(loaded.check.__file__).name == "logits_copy.py"
    assert loaded.check.LIMITS == CHECK_LIMITS["logits"] | {"copy_dev"}
    assert [m["name"] for m in loaded.end_to_end] == ["serve_tokens_per_s", "ttft_mean_ms",
                                                      "setup_s"]
    assert [m["name"] for m in loaded.per_layer] == ["waves_per_s"]
    res = run_tiny(SERVE_CELL, tmp_path)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res["checks"]) == ["logit_dev", "token_gap", "mixer_dev", "state_dev",
                                   "not_argmax", "steps_missing", "inputs_altered", "unchecked",
                                   "copy_dev"]
    assert res["checks"]["copy_dev"] == {"value": 0.0, "limit": 0.05}
    assert _snapshot() == before


@pytest.mark.parametrize("limits,check_tail,message", [
    ({**SERVE_LIMITS, "expert_dev": 0.1}, COPY_DEV, r"undeclared \['expert_dev'\]"),
    ({k: v for k, v in SERVE_LIMITS.items() if k != "copy_dev"}, COPY_DEV,
     r"missing \['copy_dev'\], undeclared \[\]"),
    (SERVE_LIMITS, COPY_DEV + "\ndel LIMITS\n", "declares no LIMITS"),
], ids=["undeclared", "missing", "no-LIMITS"])
def test_a_cell_whose_limits_differ_from_its_check_is_refused(tmp_path, limits, check_tail,
                                                               message):
    """`load_cell` refuses the new serving cell when its file gives a limit
    that its check does not declare, or leaves one out, or when the check
    declares none; the error names the cell and the check."""
    serving_checkout(tmp_path, limits, check_tail)
    with pytest.raises(ValueError, match=message) as err:
        harness.load_cell(SERVE_CELL, tmp_path)
    assert f"cell {SERVE_CELL!r}" in str(err.value) and "'logits_copy'" in str(err.value)


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


@pytest.mark.parametrize("source,names", [
    ("chunk_scan/csrc/chunk_scan_mamba2.cu", readers.MAMBA2_SCAN_KERNELS),
    ("decode_attn/csrc/decode_attn.cu", readers.DECODE_ATTN_KERNELS)])
def test_every_serving_kernel_is_listed(source, names):
    """The serving rooflines' kernel lists hold every `__global__` kernel
    of their CUDA sources, and no name of one is part of another kernel's
    name in the port."""
    def kernels(path):
        return set(_GLOBAL.findall(re.sub(r"//[^\n]*", "", path.read_text())))

    found = kernels(ROOT / "src" / "repro_torch" / "kernels" / source)
    assert found == set(names)
    every = {n for cu in (ROOT / "src" / "repro_torch" / "kernels").rglob("*.cu")
             for n in kernels(cu)}
    assert not {(n, k) for n in names for k in every - found if n in k}


@pytest.mark.parametrize("family,names", [("lda_gibbs", readers.GIBBS_KERNELS),
                                          ("alias_mh", readers.ALIAS_KERNELS)])
def test_every_kernel_of_a_family_is_listed(family, names):
    """Each `__global__` kernel of the family's CUDA source is in its list
    (or is a test entry), and no list names another family's kernel."""
    src = ROOT / "src" / "repro_torch" / "kernels" / family / "csrc" / f"{family}.cu"
    found = set(_GLOBAL.findall(src.read_text()))
    assert found == set(names) | set(readers.TEST_ONLY), src
    assert not set(readers.GIBBS_KERNELS) & set(readers.ALIAS_KERNELS)
