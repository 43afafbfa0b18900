"""Load and launch the Hopper chunked-scan kernels: the general entry
(`csrc/chunk_scan.cu`) and the Mamba2 entry (`csrc/chunk_scan_mamba2.cu`),
two launches each (prep, then scan).

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
    (path, the compiler's ptxas report, kept beside the library when
    cached)."""
    return _build.build(SOURCE, NAME)


def build_mamba2() -> tuple[Path, str]:
    """The same for the Mamba2 entry's library (`csrc/chunk_scan_mamba2.cu`)."""
    return _build.build(MAMBA2_SOURCE, MAMBA2_NAME)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the general entry's C interface on a loaded library (this
    source's build, or a build of a variant of it)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.chunk_scan.argtypes = [p] * 9 + [i] * 8 + [p]
    lib.chunk_scan.restype = ctypes.c_int
    lib.chunk_scan_smem_bytes.argtypes = [i, i, i]
    lib.chunk_scan_smem_bytes.restype = ctypes.c_int
    lib.chunk_scan_scratch_floats.argtypes = [i] * 5
    lib.chunk_scan_scratch_floats.restype = ctypes.c_longlong
    lib.chunk_scan_dv_block.argtypes = []
    lib.chunk_scan_dv_block.restype = ctypes.c_int
    lib.chunk_scan_scan_blocks.argtypes = [i] * 3
    lib.chunk_scan_scan_blocks.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load(SOURCE, NAME))


def smem_bytes(chunk: int, dk: int, itemsize: int) -> int:
    """Shared memory the general entry's larger kernel needs (its own layout)."""
    return _lib().chunk_scan_smem_bytes(chunk, dk, itemsize)


def record_floats(dk: int, chunk: int) -> int:
    """Floats of one chunk's record, which the prep kernel writes and the
    scan copies whole (`Record` in the source): k * exp(Lc - L) (cp rows of
    dk4), q * exp(Lq) transposed (dk4 rows of cp), A transposed (cp rows of
    cp) and exp(Lc) (dk4), with dk4 and cp = chunk rounded up to 4."""
    dk4, cp = -(-dk // 4) * 4, -(-chunk // 4) * 4
    return 2 * cp * dk4 + cp * cp + dk4


def scratch_floats(b: int, s: int, h: int, dk: int, chunk: int) -> int:
    """Float32 scratch of one call: a record for each of the B * H * S / chunk
    chunks (`chunk_scan_scratch_floats` in the source)."""
    return b * h * (s // chunk) * record_floats(dk, chunk)


def dv_block() -> int:
    """State columns a general-entry scan block owns, as the built library
    reports them (`kDvb` in the source)."""
    return _lib().chunk_scan_dv_block()


def scan_blocks(b: int, h: int, dv: int) -> int:
    """Blocks the general entry's scan launches at (b, h, dv): one a (b, h)
    and slice of `dv_block()` state columns, the last slice maybe ragged
    (the library's own grid)."""
    return _lib().chunk_scan_scan_blocks(b, h, dv)


def launch(w, k, v, q, u, s0, y, s_out, *, include_current: bool, chunk: int,
           lib: ctypes.CDLL | None = None) -> None:
    """Launch the general entry's two kernels (prep, then the scan over
    slices of `dv_block()` state columns) on PyTorch's current stream.
    Arguments are validated by the caller (`ops.chunk_scan`); `u` and `s0`
    may be None (zeros). The scratch (`scratch_floats`) is allocated here.
    `lib` is a `bind`-declared build of a variant of the source (default:
    the source's own). Raises if a launch is refused."""
    b, s, h, dk = k.shape
    dev = v.device
    rec = torch.empty(scratch_floats(b, s, h, dk, chunk), dtype=torch.float32, device=dev)
    err = (lib or _lib()).chunk_scan(
        w.data_ptr(), k.data_ptr(), v.data_ptr(), q.data_ptr(),
        None if u is None else u.data_ptr(), None if s0 is None else s0.data_ptr(),
        y.data_ptr(), s_out.data_ptr(), rec.data_ptr(), b, s, h, dk, v.shape[-1], chunk,
        int(include_current), int(v.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
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
