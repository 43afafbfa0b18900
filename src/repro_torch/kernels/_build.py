"""Build and load the port's hand-written CUDA kernels (`*/csrc/*.cu`).

Each kernel source is compiled at first use with `nvcc` for ``sm_90a`` into
a shared library with a plain C interface, loaded with `ctypes` (no
PyTorch headers in the build, so it takes seconds). Libraries land in
``build/repro_torch/`` at the root of the checkout, named by the hash of
their source and flags, so an edited source is rebuilt and concurrent
processes never load a half-written file.

Nothing here runs at import: the kernel modules are imported on hosts
without `nvcc` or a card, where only their plain versions are reachable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# No fast math and no fused multiply-add: `logf` and unfused arithmetic keep
# the kernels within an ulp of their plain PyTorch versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's kernels are built on a "
                       "host with the CUDA toolkit (set CUDA_HOME)")


def library_path(source: Path, name: str) -> Path:
    digest = hashlib.sha1(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(source: Path, name: str) -> tuple[Path, str]:
    """Compile `source` into ``lib<name>-<hash>.so`` if it is not built yet;
    returns (path, the compiler's report — ptxas registers/spills — or ""
    when cached)."""
    out = library_path(source, name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stderr


def load(source: Path, name: str) -> ctypes.CDLL:
    """Build if needed, then load the library (the caller declares the
    entry point's `argtypes` and `restype`)."""
    path, _ = build(source, name)
    return ctypes.CDLL(str(path))
