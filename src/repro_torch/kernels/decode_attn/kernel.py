"""Load and launch the Hopper flash-decode kernel (`csrc/decode_attn.cu`).

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attn.cu"
NAME = "decode_attn"


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet; returns (path, the
    compiler's report — ptxas registers/spills — or "" when cached)."""
    return _build.build(SOURCE, NAME)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE, NAME)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, f, f, i, p]
    lib.decode_attn.restype = ctypes.c_int
    return lib


def launch(q, k_cache, v_cache, out, *, length: int, pos: int, window: int, ring: bool,
           cap: float) -> None:
    """Launch on PyTorch's current stream. Arguments are validated by the
    caller (`ops.decode_attention`); raises if the launch is refused."""
    b, s, hkv, hd = k_cache.shape
    err = _lib().decode_attn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        b, s, hkv, hd, q.shape[1] // hkv, pos, length, window, int(ring), cap,
        hd ** -0.5, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attn launch failed: CUDA error {err}")
