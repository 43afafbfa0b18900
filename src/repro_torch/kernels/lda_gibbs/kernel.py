"""Load and launch the Hopper Gibbs-resample kernel (`csrc/lda_gibbs.cu`):
`launch` for one model, `launch_many` for M stacked models, `launch_quant`
for one model whose word-topic table is packed (int8 or int4 codes with
per-row scales).

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "lda_gibbs.cu"
NAME = "lda_gibbs"
_nvcc = _build.nvcc


def library_path() -> Path:
    return _build.library_path(SOURCE, NAME)


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet; returns (path, the
    compiler's report — ptxas registers/spills — or "" when cached)."""
    return _build.build(SOURCE, NAME)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE, NAME)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lda_gibbs_resample.argtypes = [p, p, p, p, p, p, p, i, p, p, i, i, f, f, f, f, p]
    lib.lda_gibbs_resample.restype = ctypes.c_int
    lib.lda_gibbs_resample_batched.argtypes = [p, p, p, p, p, p, p, i, p, p, i, i, i, i, i,
                                               f, f, f, f, p]
    lib.lda_gibbs_resample_batched.restype = ctypes.c_int
    lib.lda_gibbs_resample_quant.argtypes = [p, p, p, p, p, p, p, p, i, i, p, p, i, i,
                                             f, f, f, f, p]
    lib.lda_gibbs_resample_quant.restype = ctypes.c_int
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


def launch_many(docs, words, z, weights, n_dt, n_wt, n_t, noise, z_out, *,
                alpha: float, beta: float, beta_bar: float, scale: float) -> None:
    """Launch over M stacked models — ids (M, N), tables (M, D, K),
    (M, V, K), (M, K), noise (M, N, K) — on PyTorch's current stream.
    Arguments are validated by the caller (`ops.resample_many`); raises if
    the launch is refused."""
    m, n, k = noise.shape
    err = _lib().lda_gibbs_resample_batched(
        docs.data_ptr(), words.data_ptr(), z.data_ptr(), weights.data_ptr(),
        n_dt.data_ptr(), n_wt.data_ptr(), n_t.data_ptr(),
        int(n_dt.dtype == torch.int32), noise.data_ptr(), z_out.data_ptr(),
        m, n, n_dt.shape[1], n_wt.shape[1], k, alpha, beta, beta_bar, scale,
        torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lda_gibbs_resample_batched launch failed: CUDA error {err}")


def launch_quant(docs, words, z, weights, n_dt, codes, scales, n_t, noise, z_out, *,
                 bits: int, alpha: float, beta: float, beta_bar: float,
                 scale: float) -> None:
    """Launch over one model with a packed word table — `codes` (V, K)
    uint8 for bits 8, (V, ceil(K/2)) nibble-packed for bits 4, `scales`
    (V,) float32 — and stored n_dt/n_t (`scale` converts them to real
    units) on PyTorch's current stream. Arguments are validated by the
    caller (`ops.resample_quant`); raises if the launch is refused."""
    n, k = noise.shape
    err = _lib().lda_gibbs_resample_quant(
        docs.data_ptr(), words.data_ptr(), z.data_ptr(), weights.data_ptr(),
        n_dt.data_ptr(), codes.data_ptr(), scales.data_ptr(), n_t.data_ptr(),
        int(n_dt.dtype == torch.int32), bits, noise.data_ptr(), z_out.data_ptr(),
        n, k, alpha, beta, beta_bar, scale,
        torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lda_gibbs_resample_quant launch failed: CUDA error {err}")
