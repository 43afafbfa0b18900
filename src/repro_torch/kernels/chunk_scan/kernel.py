"""Load and launch the Hopper chunked-scan kernel (`csrc/chunk_scan.cu`).

The source is built at first use by `repro_torch.kernels._build` (nvcc for
``sm_90a`` into ``build/repro_torch/``, a plain C interface loaded with
`ctypes`). Nothing here runs at import: this module is imported on hosts
without `nvcc` or a card, where only the plain version in `ops` is
reachable.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "chunk_scan.cu"
NAME = "chunk_scan"
MAMBA2_SOURCE = Path(__file__).resolve().parent / "csrc" / "chunk_scan_mamba2.cu"
MAMBA2_NAME = "chunk_scan_mamba2"
MAX_SMEM_BYTES = 232448  # what one block can opt into on sm_90


def build() -> tuple[Path, str]:
    """Compile the general entry's library if it is not built yet; returns
    (path, the compiler's report — ptxas registers/spills — or "" when
    cached)."""
    return _build.build(SOURCE, NAME)


def build_mamba2() -> tuple[Path, str]:
    """The same for the Mamba2 entry's library (`csrc/chunk_scan_mamba2.cu`)."""
    return _build.build(MAMBA2_SOURCE, MAMBA2_NAME)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE, NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.chunk_scan.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.chunk_scan.restype = ctypes.c_int
    lib.chunk_scan_smem_bytes.argtypes = [i, i, i]
    lib.chunk_scan_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(chunk: int, dk: int, dv: int) -> int:
    """Shared memory one block needs (the kernel's own layout)."""
    return _lib().chunk_scan_smem_bytes(chunk, dk, dv)


def launch(w, k, v, q, u, s0, y, s_out, *, include_current: bool, chunk: int) -> None:
    """Launch on PyTorch's current stream. Arguments are validated by the
    caller (`ops.chunk_scan`); `u` and `s0` may be None (zeros); raises if
    the launch is refused."""
    b, s, h, dk = k.shape
    err = _lib().chunk_scan(
        w.data_ptr(), k.data_ptr(), v.data_ptr(), q.data_ptr(),
        None if u is None else u.data_ptr(), None if s0 is None else s0.data_ptr(),
        y.data_ptr(), s_out.data_ptr(), b, s, h, dk, v.shape[-1], chunk,
        int(include_current), int(v.dtype == torch.bfloat16),
        torch.cuda.current_stream(v.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chunk_scan launch failed: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def _mamba2_lib() -> ctypes.CDLL:
    lib = _build.load(MAMBA2_SOURCE, MAMBA2_NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.chunk_scan_mamba2.argtypes = [p] * 12 + [i] * 8 + [p]
    lib.chunk_scan_mamba2.restype = ctypes.c_int
    lib.chunk_scan_mamba2_smem_bytes.argtypes = [i, i, i, i]
    lib.chunk_scan_mamba2_smem_bytes.restype = ctypes.c_int
    return lib


def mamba2_smem_bytes(chunk: int, dk: int, dv_block: int, itemsize: int) -> int:
    """Shared memory the Mamba2 entry's larger kernel needs (its own layout)."""
    return _mamba2_lib().chunk_scan_mamba2_smem_bytes(chunk, dk, dv_block, itemsize)


def launch_mamba2(w, k, q, v, s0, y, s_out, *, chunk: int, dv_block: int) -> None:
    """Launch the Mamba2 entry's two kernels (prep, then scan) on PyTorch's
    current stream: w (B, S, H) float32, k and q (B, S, dk), v (B, S, H,
    dv). Arguments are validated by the caller (`ops.chunk_scan_mamba2`);
    `s0` may be None (zeros). The float32 scratch (k widened, q and the
    chunks' q k^T transposed, the decays) is allocated here. Raises if a
    launch is refused."""
    b, s, h, dv = v.shape
    dk = k.shape[-1]
    n, cp = s // chunk, -(-chunk // 4) * 4
    dev = v.device
    kf = torch.empty((b, s, dk), dtype=torch.float32, device=dev)
    qt = torch.empty((b, n, dk, cp), dtype=torch.float32, device=dev)
    gt = torch.empty((b, n, chunk, cp), dtype=torch.float32, device=dev)
    lx = torch.empty((3, b, s, h), dtype=torch.float32, device=dev)
    elc = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    err = _mamba2_lib().chunk_scan_mamba2(
        w.data_ptr(), k.data_ptr(), q.data_ptr(), v.data_ptr(),
        None if s0 is None else s0.data_ptr(), y.data_ptr(), s_out.data_ptr(), kf.data_ptr(),
        qt.data_ptr(), gt.data_ptr(), lx.data_ptr(), elc.data_ptr(), b, s, h, dk, dv, chunk,
        dv_block, int(v.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chunk_scan_mamba2 launch failed: CUDA error {err}")
