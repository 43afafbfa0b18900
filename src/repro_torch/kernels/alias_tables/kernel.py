"""Load and launch the Hopper alias-table build (`csrc/alias_tables.cu`):
`launch` builds a sweep's two tables of K columns in one kernel launch, and
`scan_log_x` gives PyTorch's scan split for a row count (a test entry).

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "alias_tables.cu"
NAME = "alias_tables"


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet; returns (path, the
    compiler's ptxas report, kept beside the library when cached)."""
    return _build.build(SOURCE, NAME)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE, NAME)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.alias_tables_workspace.argtypes = [ll, i]
    lib.alias_tables_workspace.restype = ll
    lib.alias_tables_scan_log_x.argtypes = [ll, i]
    lib.alias_tables_scan_log_x.restype = i
    f = ctypes.c_float
    lib.alias_tables_build.argtypes = [p, f, p, p, p, ll, p, f, p, p, p, ll, i, p, p]
    lib.alias_tables_build.restype = i
    return lib


def scan_log_x(rows: int, k: int) -> int:
    """PyTorch's `get_log_num_threads_x_inner_scan(rows, k)` as the kernel
    computes it: its scans take chunks of 2^(log_x + 1) columns."""
    return _lib().alias_tables_scan_log_x(rows, k)


def launch(words, docs, k: int) -> None:
    """Build a sweep's two tables in one launch on PyTorch's current stream:
    `words` and `docs` are each ``(counts, prior, row_sum, thresh, alias)``,
    contiguous (R, K) float32 counts, a float prior, (R,) float32 sums of
    counts + prior or None to sum in the kernel (see `ops.sums_in_kernel`),
    and the (R, K) float32 / int32 outputs, on one card. Arguments are
    validated by the caller (`ops.build_tables`); raises if the launch is
    refused."""
    cw, pw, sw, tw, aw = words
    cd, pd, sd, td, ad = docs
    rows_w, rows_d = cw.numel() // k, cd.numel() // k
    lib = _lib()
    nbytes = lib.alias_tables_workspace(rows_w + rows_d, k)
    if nbytes < 0:
        raise RuntimeError("alias_tables_workspace failed: no launch plan for this card")
    work = torch.empty(nbytes, dtype=torch.uint8, device=cw.device) if nbytes else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.alias_tables_build(ptr(cw), pw, ptr(sw), ptr(tw), ptr(aw), rows_w,
                                 ptr(cd), pd, ptr(sd), ptr(td), ptr(ad), rows_d, k,
                                 ptr(work), torch.cuda.current_stream(cw.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"alias_tables_build launch failed: CUDA error {err}")
