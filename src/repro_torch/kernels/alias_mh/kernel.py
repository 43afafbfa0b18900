"""Load and launch the Hopper AliasLDA MH kernel (`csrc/alias_mh.cu`):
`launch` for one model, `launch_many` for M stacked models (each with
injected draws or Philox draws made in the kernel), and `philox_words`, a
test entry holding the kernel's Philox against cuRAND's.

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "alias_mh.cu"
NAME = "alias_mh"
#: `body` values: the kernel picks by shape, or the direct body, or the log tables.
BODIES = {"auto": -1, "direct": 0, "tables": 1}


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet; returns (path, the
    compiler's ptxas report, kept beside the library when cached)."""
    return _build.build(SOURCE, NAME)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE, NAME)
    p, i, f, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint64
    lib.alias_mh_workspace.argtypes = [i, i, i, i, i, i, i]
    lib.alias_mh_workspace.restype = ctypes.c_longlong
    lib.alias_mh_resample.argtypes = [p, p, p, p, p, p, p, i, p, p, p, p, p, p, p, u64, u64,
                                      p, i, p, i, i, i, i, i, f, f, f, f, p]
    lib.alias_mh_resample.restype = ctypes.c_int
    lib.alias_mh_resample_batched.argtypes = [p, p, p, p, p, p, p, i, p, p, p, p, p, p, p, p,
                                              p, i, p, i, i, i, i, i, i, f, f, f, f, p]
    lib.alias_mh_resample_batched.restype = ctypes.c_int
    lib.alias_mh_philox_words.argtypes = [p, p, p, p, i, p]
    lib.alias_mh_philox_words.restype = ctypes.c_int
    return lib


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=256)
def _workspace_floats(m: int, n: int, d: int, v: int, k: int, s: int, body: int) -> int:
    return _lib().alias_mh_workspace(m, n, d, v, k, s, body)


def _workspace(m, n, d, v, k, s, body, device) -> Optional[torch.Tensor]:
    """The scratch a call of these shapes takes (the call's log tables,
    which the kernel sizes), or None."""
    floats = _workspace_floats(m, n, d, v, k, s, body)
    return torch.empty(floats, dtype=torch.float32, device=device) if floats else None


def launch(docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w, thresh_d,
           alias_d, j_prop, u_prop, u_acc, z_out, *, alpha: float, beta: float,
           beta_bar: float, scale: float, philox: tuple[int, int] = (0, 0),
           mh_steps: Optional[int] = None, body: str = "auto") -> None:
    """Launch on PyTorch's current stream with injected (S, N) draws or,
    when they are None, Philox draws under `philox` = (seed, offset) over
    `mh_steps` rounds. `body` forces the direct body or the log tables
    (default: the kernel picks by shape). Arguments are validated by the
    caller (`ops.mh_resample`); raises if the launch is refused."""
    n = z.shape[0]
    d, v, k = n_dt.shape[0], n_wt.shape[0], n_t.shape[0]
    s = mh_steps if j_prop is None else j_prop.shape[0]
    work = _workspace(1, n, d, v, k, s, BODIES[body], z.device)
    err = _lib().alias_mh_resample(
        docs.data_ptr(), words.data_ptr(), z.data_ptr(), weights.data_ptr(),
        n_dt.data_ptr(), n_wt.data_ptr(), n_t.data_ptr(),
        int(n_dt.dtype == torch.int32), thresh_w.data_ptr(), alias_w.data_ptr(),
        thresh_d.data_ptr(), alias_d.data_ptr(), _ptr(j_prop), _ptr(u_prop), _ptr(u_acc),
        philox[0], philox[1], _ptr(work), BODIES[body], z_out.data_ptr(),
        n, d, v, k, s, alpha, beta, beta_bar, scale,
        torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"alias_mh_resample launch failed: CUDA error {err}")


def launch_many(docs, words, z, weights, n_dt, n_wt, n_t, thresh_w, alias_w, thresh_d,
                alias_d, j_prop, u_prop, u_acc, z_out, *, alpha: float, beta: float,
                beta_bar: float, scale: float, philox: Optional[torch.Tensor] = None,
                mh_steps: Optional[int] = None, body: str = "auto") -> None:
    """Launch over M stacked models — ids (M, N), count and alias tables
    (M, D, K) / (M, V, K), totals (M, K) — with injected (M, S, N) draws or,
    when they are None, Philox draws under `philox`, an (M, 2) int64 table
    of (seed, offset) rows on the card, over `mh_steps` rounds, on PyTorch's
    current stream. Arguments are validated by the caller
    (`ops.mh_resample_many`); raises if the launch is refused."""
    m, n = z.shape
    d, v, k = n_dt.shape[1], n_wt.shape[1], n_t.shape[1]
    s = mh_steps if j_prop is None else j_prop.shape[1]
    work = _workspace(m, n, d, v, k, s, BODIES[body], z.device)
    err = _lib().alias_mh_resample_batched(
        docs.data_ptr(), words.data_ptr(), z.data_ptr(), weights.data_ptr(),
        n_dt.data_ptr(), n_wt.data_ptr(), n_t.data_ptr(),
        int(n_dt.dtype == torch.int32), thresh_w.data_ptr(), alias_w.data_ptr(),
        thresh_d.data_ptr(), alias_d.data_ptr(), _ptr(j_prop), _ptr(u_prop), _ptr(u_acc),
        _ptr(philox), _ptr(work), BODIES[body], z_out.data_ptr(),
        m, n, d, v, k, s, alpha, beta, beta_bar, scale,
        torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"alias_mh_resample_batched launch failed: CUDA error {err}")


def philox_words(counters: torch.Tensor, keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's Philox4x32-10 and cuRAND's `curand_Philox4x32_10` on the
    card (a test entry): counters (n, 4) and keys (n, 2), int32 tensors
    holding uint32 words, -> (ours, cuRAND's), each (n, 4) int32."""
    if counters.device.type != "cuda" or keys.device != counters.device:
        raise ValueError("philox_words runs on the card")
    counters, keys = counters.to(torch.int32).contiguous(), keys.to(torch.int32).contiguous()
    n = counters.shape[0]
    if counters.shape != (n, 4) or keys.shape != (n, 2):
        raise ValueError("counters must be (n, 4) and keys (n, 2)")
    ours, theirs = torch.empty_like(counters), torch.empty_like(counters)
    err = _lib().alias_mh_philox_words(counters.data_ptr(), keys.data_ptr(), ours.data_ptr(),
                                       theirs.data_ptr(), n,
                                       torch.cuda.current_stream(counters.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"alias_mh_philox_words launch failed: CUDA error {err}")
    return ours, theirs
