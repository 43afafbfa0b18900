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
MAX_SMEM_BYTES = 232448  # what one block can opt into on sm_90


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet; returns (path, the
    compiler's report — ptxas registers/spills — or "" when cached)."""
    return _build.build(SOURCE, NAME)


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
