"""The alias-table build's wrapper: `build_tables` makes a sweep's two Vose
tables, of q_w ∝ n_wt + β and q_d ∝ n_dt + α, as
`core.alias.build_alias_tables` would.

On CUDA tensors it launches the hand-written Hopper kernel (`kernel.launch`,
from `csrc/alias_tables.cu`) once for both tables, adding one to
``build_tables.launches``; there is no fall back. The kernel gives the same
bits as the PyTorch build on the card wherever PyTorch scans rows in its
row-wise order: every table of two rows or more. A one-row table (PyTorch
scans it with cub's device-wide scan, whose order the kernel does not copy)
gets the same distribution, which is what the card tests hold it to. The
kernel sums a row itself where PyTorch's sum gives a row one warp
(`sums_in_kernel`; the production shapes); elsewhere a table's row sums stay
two PyTorch operations before the launch (the source's header says why). On
CPU and `meta` tensors it runs `build_alias_tables`, the plain version and
the yardstick the kernel is held to.

`vedalia_alias_table_rows_total{impl="kernel"|"plain"}` counts the rows each
implementation built (a no-op while obs is off).
"""

from __future__ import annotations

import torch

from repro_torch.core.alias import build_alias_tables
from repro_torch.kernels import PLAIN_DEVICES
from repro_torch.obs import metrics

_ROWS = metrics.counter(
    "vedalia_alias_table_rows_total",
    "Alias-table rows built, by implementation (kernel on the card, plain).",
    labels=("impl",))


def _check(counts) -> None:
    """What the build takes: contiguous float32 (..., K) counts, K >= 1."""
    if not isinstance(counts, torch.Tensor) or counts.dtype != torch.float32:
        raise ValueError("counts must be a float32 tensor")
    if counts.dim() < 1 or counts.shape[-1] < 1:
        raise ValueError(f"counts must be (..., K) with K >= 1, not {tuple(counts.shape)}")
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")


def sums_in_kernel(counts: torch.Tensor) -> bool:
    """Whether the kernel sums the rows of `counts` (+ prior) itself: where
    PyTorch's `probs.sum(-1)` gives each row one warp with 4-wide loads
    (`Reduce.cuh`'s `setReduceConfig`: K a multiple of 4 from 128 on, below
    256 values a lane, at least 16 rows) and the kernel's team is a warp or
    more (K > 128), on 16-byte aligned rows. Elsewhere PyTorch sums them."""
    k = counts.shape[-1]
    return (k % 4 == 0 and 132 <= k and -(-k // 32) < 256 and counts.numel() >= 16 * k
            and counts.data_ptr() % 16 == 0)


def build_tables(n_wt: torch.Tensor, beta: float, n_dt: torch.Tensor,
                 alpha: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(thresh_w, alias_w, thresh_d, alias_d)``: float32 and int32 tables
    of the counts' shapes, from q_w ∝ n_wt + β and q_d ∝ n_dt + α (a row of
    mass 0 is uniform). Both tables share K and a device: CUDA tensors take
    one kernel launch, CPU and `meta` tensors `build_alias_tables`."""
    for counts in (n_wt, n_dt):
        _check(counts)
    k, dev = n_wt.shape[-1], n_wt.device
    if n_dt.shape[-1] != k or n_dt.device != dev:
        raise ValueError(f"both tables need one K and one device, not K {k} on {dev} "
                         f"and K {n_dt.shape[-1]} on {n_dt.device}")
    rows = (n_wt.numel() + n_dt.numel()) // k
    if dev.type in PLAIN_DEVICES:
        _ROWS.inc(rows, impl="plain")
        return (*build_alias_tables(n_wt + beta), *build_alias_tables(n_dt + alpha))
    if dev.type != "cuda":
        raise ValueError(f"no alias_tables kernel for device {dev}")
    from repro_torch.kernels.alias_tables import kernel

    out = []
    for counts, prior in ((n_wt, beta), (n_dt, alpha)):
        row_sum = None if sums_in_kernel(counts) else (counts + prior).sum(-1)
        out.append((counts, float(prior), row_sum, torch.empty_like(counts),
                    torch.empty(counts.shape, dtype=torch.int32, device=dev)))
    kernel.launch(*out, k)
    build_tables.launches += 1
    _ROWS.inc(rows, impl="kernel")
    return out[0][3], out[0][4], out[1][3], out[1][4]


#: Kernel launches so far (CUDA tensors only; the plain version never counts).
build_tables.launches = 0
