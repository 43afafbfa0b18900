"""The PyTorch port's import boundary and device policy.

`repro_torch` (and `chip_smoke.py`, which runs on a machine without JAX)
must import neither `jax` nor the reference package `repro`; its entry
points run on CUDA unless the caller asks for the CPU, and raise — never
fall back — when CUDA is absent.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_neither_jax_nor_reference(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_port_package_has_no_top_level_init():
    # A namespace package, like src/repro.
    assert not (REPO / "src" / "repro_torch" / "__init__.py").exists()
    for name in ("lda_gibbs", "alias_mh", "alias_tables"):
        assert (REPO / "src" / "repro_torch" / "kernels" / name / "csrc"
                / f"{name}.cu").exists()


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.api as api\n"
        "from repro_torch.api import VedaliaClient, VedaliaServer, codec\n"
        "import repro_torch.core.gibbs, repro_torch.core.perplexity\n"
        "import repro_torch.kernels.lda_gibbs.ops, repro_torch.kernels.lda_gibbs.kernel\n"
        "import repro_torch.kernels.alias_mh.ops, repro_torch.kernels.alias_mh.kernel\n"
        "import repro_torch.kernels.alias_tables.ops, repro_torch.kernels.alias_tables.kernel\n"
        "import repro_torch.core.alias, repro_torch.kernels._build\n"
        "import repro_torch.data.reviews, repro_torch.obs\n"
        "import repro_torch.core.batch, repro_torch.serving\n"
        "from repro_torch.serving import batch_engine, scheduler, topic_engine\n"
        "from repro_torch.serving import TopicEngine, WaveScheduler\n"
        "import repro_torch.stream.sources, repro_torch.stream.router\n"
        "import repro_torch.stream.scheduler, repro_torch.stream.snapshot\n"
        "from repro_torch.stream import IncrementalScheduler, StreamRouter, restore_server\n"
        "from repro_torch.core.quant import quantize_rows_torch, fake_quantize_rows\n"
        "import repro_torch.core.sparse, repro_torch.chital, repro_torch.chital.runtime\n"
        "import repro_torch.chital.simulator, repro_torch.offload\n"
        "from repro_torch.offload import DeviceFleet, OffloadCoordinator\n"
        "import repro_torch.core.distributed, repro_torch.pserver\n"
        "from repro_torch.pserver import PServerFit, PServerPlan, build_plan\n"
        "from repro_torch.pserver import comm, sampler, sweep, sync, topology\n"
        "from repro_torch.api.backends import DistributedSampler, PServerSampler\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=False)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("entry", ["VedaliaServer", "VedaliaService", "VedaliaClient"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device resolves, nothing to raise")
    import repro_torch.api as api

    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(api, entry)()
    # Asking for the CPU explicitly is the only way onto it.
    obj = getattr(api, entry)(device="cpu")
    assert obj is not None


def test_resolve_device():
    from repro_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_serving_slice_imports_no_jax_and_ships_its_kernel_sources():
    for name in ("chunk_scan", "decode_attn"):
        assert (REPO / "src" / "repro_torch" / "kernels" / name / "csrc"
                / f"{name}.cu").exists()
    code = (
        "import sys\n"
        "import repro_torch.configs, repro_torch.configs.base\n"
        "import repro_torch.configs.whisper_base, repro_torch.configs.llama_3_2_vision_90b\n"
        "import repro_torch.configs.arctic_480b\n"
        "import repro_torch.configs.llama4_maverick_400b_a17b\n"
        "import repro_torch.models.params, repro_torch.models.layers\n"
        "import repro_torch.models.ssm, repro_torch.models.attention, repro_torch.models.moe\n"
        "import repro_torch.models.model, repro_torch.models.convert\n"
        "import repro_torch.kernels.chunk_scan.ops, repro_torch.kernels.chunk_scan.kernel\n"
        "import repro_torch.kernels.decode_attn.ops, repro_torch.kernels.decode_attn.kernel\n"
        "import repro_torch.serving.engine, repro_torch.launch.serve\n"
        "from repro_torch.serving import Engine, Request, Result\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=False)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("entry", ["Engine", "init_model", "launch.serve"])
def test_serving_entry_points_default_to_cuda_and_raise_without_it(entry):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device resolves, nothing to raise")
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving import Engine

    cfg = configs.get("zamba2-2.7b").reduced()
    calls = {
        "Engine": lambda **kw: Engine(cfg, {}, **kw),
        "init_model": lambda **kw: M.init_model(cfg, **kw),
        "launch.serve": lambda **kw: serve.main(
            ["--arch", "zamba2-2.7b", "--requests", "1", "--max-new", "2"]
            + (["--device", kw["device"]] if kw else [])),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    # Asking for the CPU explicitly is the only way onto it.
    assert calls[entry](device="cpu") is not None


@pytest.mark.parametrize("arch", ["qwen2-7b", "rwkv6-1.6b", "whisper-base",
                                  "llama-3.2-vision-90b", "arctic-480b",
                                  "llama4-maverick-400b-a17b"])
def test_each_family_serves_on_cuda_by_default_and_on_the_cpu_when_asked(arch):
    """The dense, ssm, audio, vlm and moe families' entry points
    (`init_model`, `Engine`, `launch.serve`) resolve to CUDA unless asked,
    and serve on the CPU."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, Request

    cfg = configs.get(arch).reduced()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            M.init_model(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--arch", arch, "--requests", "1", "--max-new", "2"])
    params = M.init_model(cfg, device="cpu")
    eng = Engine(cfg, params, cache_len=32, max_batch=1, device="cpu")
    eng.submit(Request(uid=0, prompt=np.arange(8, dtype=np.int32), max_new_tokens=3))
    assert eng.run()[0].tokens.shape == (3,)
    results = serve.main(["--arch", arch, "--requests", "1", "--prompt-len", "8",
                          "--max-new", "2", "--cache-len", "32", "--device", "cpu"])
    assert results[0].tokens.shape == (2,)


def test_pod_modules_import_no_jax_and_set_no_environment():
    """`launch.mesh`, `sharding.specs`, `launch.dryrun` and
    `launch.dryrun_rlda` import neither JAX nor the reference, and set no
    environment variable when imported (the reference's dry runs set
    `XLA_FLAGS`; the port has no such need)."""
    code = (
        "import os, sys\n"
        "before = dict(os.environ)\n"
        "import repro_torch.launch.mesh, repro_torch.sharding, repro_torch.sharding.specs\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.dryrun_rlda\n"
        "from repro_torch.models.model import abstract_model, abstract_cache, abstract_batch\n"
        "from repro_torch.models.model import model_pspecs, cache_pspecs, batch_pspecs\n"
        "from repro_torch.models.params import abstract_params, partition_specs\n"
        "assert dict(os.environ) == before\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=False)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_production_sweep_runs_on_cuda_by_default_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device resolves, nothing to raise")
    from repro_torch.launch import dryrun_rlda

    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_rlda.run_one(False, num_tokens=4096, outdir=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_rlda.main(["--tokens", "4096"])
