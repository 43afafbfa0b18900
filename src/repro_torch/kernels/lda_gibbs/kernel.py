"""Load and launch the Hopper Gibbs-resample kernel (`csrc/lda_gibbs.cu`):
`launch` for one model, `launch_many` for M stacked models, `launch_quant`
for one model whose word-topic table is packed (int8 or int4 codes with
per-row scales) — each with injected noise or Philox noise drawn in the
kernel —, `pack_rows`, which builds a packed sweep's word table from the
stored counts, and `philox_words`, a test entry holding the kernels'
Philox against cuRAND's.

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
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "lda_gibbs.cu"
NAME = "lda_gibbs"
_nvcc = _build.nvcc


def library_path() -> Path:
    return _build.library_path(SOURCE, NAME)


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet; returns (path, the
    compiler's ptxas report, kept beside the library when cached)."""
    return _build.build(SOURCE, NAME)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE, NAME)
    p, i, f, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint64
    lib.lda_gibbs_workspace.argtypes = [i, i, i, i, i]
    lib.lda_gibbs_workspace.restype = ctypes.c_longlong
    lib.lda_gibbs_resample.argtypes = [p, p, p, p, p, p, p, i, p, p, u64, u64, p, i, i, i, i,
                                       f, f, f, f, p]
    lib.lda_gibbs_resample.restype = ctypes.c_int
    lib.lda_gibbs_resample_batched.argtypes = [p, p, p, p, p, p, p, i, p, p, p, p, i, i, i, i,
                                               i, f, f, f, f, p]
    lib.lda_gibbs_resample_batched.restype = ctypes.c_int
    lib.lda_gibbs_resample_quant.argtypes = [p, p, p, p, p, p, p, p, i, i, p, p, u64, u64, p,
                                             i, i, i, i, f, f, f, f, p]
    lib.lda_gibbs_resample_quant.restype = ctypes.c_int
    lib.lda_gibbs_pack_word_table.argtypes = [p, i, i, p, p, i, i, f, p]
    lib.lda_gibbs_pack_word_table.restype = ctypes.c_int
    lib.lda_gibbs_philox_words.argtypes = [p, p, p, p, i, p]
    lib.lda_gibbs_philox_words.restype = ctypes.c_int
    return lib


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=256)
def _workspace_floats(m: int, n: int, d: int, v: int, k: int) -> int:
    return _lib().lda_gibbs_workspace(m, n, d, v, k)


def _workspace(m: int, n: int, d: int, v: int, k: int, device) -> Optional[torch.Tensor]:
    """The scratch a call of these shapes takes (the sweep's log tables of
    the count rows, which the kernel sizes), or None."""
    floats = _workspace_floats(m, n, d, v, k)
    return torch.empty(floats, dtype=torch.float32, device=device) if floats else None


def launch(docs: torch.Tensor, words: torch.Tensor, z: torch.Tensor,
           weights: torch.Tensor, n_dt: torch.Tensor, n_wt: torch.Tensor,
           n_t: torch.Tensor, noise: Optional[torch.Tensor], z_out: torch.Tensor, *,
           alpha: float, beta: float, beta_bar: float, scale: float,
           philox: tuple[int, int] = (0, 0)) -> None:
    """Launch on PyTorch's current stream, with injected `noise` (N, K) or,
    when it is None, Philox noise under `philox` = (seed, offset). Arguments
    are validated by the caller (`ops.resample`); raises if the launch is
    refused."""
    n, k = z.shape[0], n_t.shape[0]
    d, v = n_dt.shape[0], n_wt.shape[0]
    work = _workspace(1, n, d, v, k, z.device)
    err = _lib().lda_gibbs_resample(
        docs.data_ptr(), words.data_ptr(), z.data_ptr(), weights.data_ptr(),
        n_dt.data_ptr(), n_wt.data_ptr(), n_t.data_ptr(),
        int(n_dt.dtype == torch.int32), _ptr(noise), _ptr(work), philox[0], philox[1],
        z_out.data_ptr(), n, d, v, k, alpha, beta, beta_bar, scale,
        torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lda_gibbs_resample launch failed: CUDA error {err}")


def launch_many(docs, words, z, weights, n_dt, n_wt, n_t, noise, z_out, *,
                alpha: float, beta: float, beta_bar: float, scale: float,
                philox: Optional[torch.Tensor] = None) -> None:
    """Launch over M stacked models — ids (M, N), tables (M, D, K),
    (M, V, K), (M, K) — with injected `noise` (M, N, K) or, when it is None,
    Philox noise under `philox`, an (M, 2) int64 table of (seed, offset) rows
    on the card, on PyTorch's current stream. Arguments are validated by the
    caller (`ops.resample_many`); raises if the launch is refused."""
    m, n = z.shape
    d, v, k = n_dt.shape[1], n_wt.shape[1], n_t.shape[1]
    work = _workspace(m, n, d, v, k, z.device)
    err = _lib().lda_gibbs_resample_batched(
        docs.data_ptr(), words.data_ptr(), z.data_ptr(), weights.data_ptr(),
        n_dt.data_ptr(), n_wt.data_ptr(), n_t.data_ptr(),
        int(n_dt.dtype == torch.int32), _ptr(noise), _ptr(work), _ptr(philox),
        z_out.data_ptr(), m, n, d, v, k, alpha, beta, beta_bar, scale,
        torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lda_gibbs_resample_batched launch failed: CUDA error {err}")


def launch_quant(docs, words, z, weights, n_dt, codes, scales, n_t, noise, z_out, *,
                 bits: int, alpha: float, beta: float, beta_bar: float,
                 scale: float, philox: tuple[int, int] = (0, 0)) -> None:
    """Launch over one model with a packed word table — `codes` (V, K)
    uint8 for bits 8, (V, ceil(K/2)) nibble-packed for bits 4, `scales`
    (V,) float32 — and stored n_dt/n_t (`scale` converts them to real
    units) on PyTorch's current stream, with injected `noise` (N, K) or,
    when it is None, Philox noise under `philox` = (seed, offset): the
    noise `launch` draws under that key. Arguments are validated by the
    caller (`ops.resample_quant`); raises if the launch is refused."""
    n, k = z.shape[0], n_t.shape[0]
    d, v = n_dt.shape[0], codes.shape[0]
    work = _workspace(1, n, d, v, k, z.device)
    err = _lib().lda_gibbs_resample_quant(
        docs.data_ptr(), words.data_ptr(), z.data_ptr(), weights.data_ptr(),
        n_dt.data_ptr(), codes.data_ptr(), scales.data_ptr(), n_t.data_ptr(),
        int(n_dt.dtype == torch.int32), bits, _ptr(noise), _ptr(work), philox[0], philox[1],
        z_out.data_ptr(), n, d, v, k, alpha, beta, beta_bar, scale,
        torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lda_gibbs_resample_quant launch failed: CUDA error {err}")


def pack_rows(n_wt: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor, *, bits: int,
              scale: float) -> None:
    """Pack the stored (V, K) word table `n_wt` (`scale` converts it to real
    units) into `codes` (V, K) uint8 for bits 8, (V, ceil(K/2)) for bits 4,
    and `scales` (V,) float32, in one launch on PyTorch's current stream.
    Arguments are validated by the caller (`ops.pack_word_table`); raises if
    the launch is refused."""
    v, k = n_wt.shape
    err = _lib().lda_gibbs_pack_word_table(
        n_wt.data_ptr(), int(n_wt.dtype == torch.int32), bits, codes.data_ptr(),
        scales.data_ptr(), v, k, scale, torch.cuda.current_stream(n_wt.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lda_gibbs_pack_word_table launch failed: CUDA error {err}")


def philox_words(counters: torch.Tensor, keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' Philox4x32-10 and cuRAND's `curand_Philox4x32_10` on the
    card (a test entry): counters (n, 4) and keys (n, 2), int32 tensors
    holding uint32 words, -> (ours, cuRAND's), each (n, 4) int32."""
    if counters.device.type != "cuda" or keys.device != counters.device:
        raise ValueError("philox_words runs on the card")
    counters, keys = counters.to(torch.int32).contiguous(), keys.to(torch.int32).contiguous()
    n = counters.shape[0]
    if counters.shape != (n, 4) or keys.shape != (n, 2):
        raise ValueError("counters must be (n, 4) and keys (n, 2)")
    ours, theirs = torch.empty_like(counters), torch.empty_like(counters)
    err = _lib().lda_gibbs_philox_words(counters.data_ptr(), keys.data_ptr(), ours.data_ptr(),
                                        theirs.data_ptr(), n,
                                        torch.cuda.current_stream(counters.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lda_gibbs_philox_words launch failed: CUDA error {err}")
    return ours, theirs
