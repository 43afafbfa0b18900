"""Build, load and launch the Hopper Gibbs-resample kernel (`csrc/lda_gibbs.cu`).

The CUDA source is compiled at first use with `nvcc` for ``sm_90a`` into a
shared library with a plain C interface, loaded with `ctypes` (no PyTorch
headers in the build, so it takes seconds). The library lands in
``build/repro_torch/`` at the root of the checkout, named by the hash of
its source and flags, so an edited source is rebuilt and concurrent
processes never load a half-written file.

Nothing here runs at import: this module is imported on hosts without
`nvcc` or a card, where only the plain version in `ops` is reachable.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "lda_gibbs.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the lda_gibbs kernel is built on a "
                       "host with the CUDA toolkit (set CUDA_HOME)")


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"liblda_gibbs-{digest[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet; returns (path, the
    compiler's report — ptxas registers/spills — or "" when cached)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stderr


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lda_gibbs_resample.argtypes = [p, p, p, p, p, p, p, i, p, p, i, i, f, f, f, f, p]
    lib.lda_gibbs_resample.restype = ctypes.c_int
    return lib


def launch(docs: torch.Tensor, words: torch.Tensor, z: torch.Tensor,
           weights: torch.Tensor, n_dt: torch.Tensor, n_wt: torch.Tensor,
           n_t: torch.Tensor, noise: torch.Tensor, z_out: torch.Tensor, *,
           alpha: float, beta: float, beta_bar: float, scale: float) -> None:
    """Launch on PyTorch's current stream. Arguments are validated by the
    caller (`ops.resample`); raises if the launch is refused."""
    n, k = noise.shape
    err = _lib().lda_gibbs_resample(
        docs.data_ptr(), words.data_ptr(), z.data_ptr(), weights.data_ptr(),
        n_dt.data_ptr(), n_wt.data_ptr(), n_t.data_ptr(),
        int(n_dt.dtype == torch.int32), noise.data_ptr(), z_out.data_ptr(),
        n, k, alpha, beta, beta_bar, scale,
        torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lda_gibbs_resample launch failed: CUDA error {err}")
