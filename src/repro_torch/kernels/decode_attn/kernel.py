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
    compiler's ptxas report, kept beside the library when cached)."""
    return _build.build(SOURCE, NAME)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE, NAME)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, f, i, i, i, i, i,
                                i, p]
    lib.decode_attn.restype = ctypes.c_int
    lib.decode_attn_merge.argtypes = [p, p, i, i, i, i, i, p]
    lib.decode_attn_merge.restype = ctypes.c_int
    return lib


def launch(q, k_cache, v_cache, out, ws, *, length: int, pos: int, window: int, ring: bool,
           cap: float, plan) -> None:
    """Launch the split kernel (and, when ``plan.parts > 1``, the merge
    kernel over the float32 workspace `ws`) on PyTorch's current stream.
    Arguments are validated by the caller (`ops.decode_attention`); raises
    if a launch is refused."""
    b, s, hkv, hd = k_cache.shape
    vec = (hd * q.element_size()) % 16 == 0 and k_cache.data_ptr() % 16 == 0 \
        and v_cache.data_ptr() % 16 == 0
    err = _lib().decode_attn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), b, s, hkv, hd, q.shape[1] // hkv, pos, length,
        window, int(ring), cap, hd ** -0.5, int(q.dtype == torch.bfloat16), plan.tile,
        int(vec), plan.stages, plan.parts, plan.tiles_per_part,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attn launch failed: CUDA error {err}")


def launch_merge(ws, out) -> None:
    """The merge kernel alone over a (B, Hq, P, hd + 2) float32 workspace
    (P > 1): `out` (B, Hq, hd) gets the merged partials in its type. For
    holding the merge against `ops.merge_partials` on the card."""
    b, hq, parts, w = ws.shape
    hd = w - 2
    if parts < 2:
        raise ValueError("the merge kernel takes P >= 2 partials")
    err = _lib().decode_attn_merge(ws.data_ptr(), out.data_ptr(), b, hq, hd, parts,
                                   int(out.dtype == torch.bfloat16),
                                   torch.cuda.current_stream(ws.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attn merge launch failed: CUDA error {err}")
