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
    for name in ("lda_gibbs", "alias_mh"):
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
        "import repro_torch.core.alias, repro_torch.kernels._build\n"
        "import repro_torch.data.reviews, repro_torch.obs\n"
        "import repro_torch.core.batch, repro_torch.serving\n"
        "from repro_torch.serving import batch_engine, scheduler, topic_engine\n"
        "from repro_torch.serving import TopicEngine, WaveScheduler\n"
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
