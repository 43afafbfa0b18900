"""Approximate fractional counts via fixed-point integers (paper §4.3).

    "Approximate weighting is performed by allocating the bottom w_bits bits
     of review-topic and word-topic counts for fractional counts. What
     previously would correspond to a count increment of 1 is mapped to an
     increment of 2^(w_bits+1)."

The fixed-point scale is ``2**(w_bits + 1)``; round-to-nearest gives
|err| <= 1/2^(w_bits+2) per conversion, and any real weight below
1/2^(w_bits+2) rounds to a stored 0 (the sparsity flush). `torch.round`
rounds half to even, as `jnp.round` does, so ties land on the same
integer in both packages.
"""

from __future__ import annotations

import torch


def scale(w_bits: int) -> int:
    """Fixed-point scale: a real count of 1.0 is stored as 2^(w_bits+1)."""
    return 1 << (w_bits + 1)


def precision(w_bits: int) -> float:
    """Representable precision 1/2^(w_bits+1) (paper §4.3)."""
    return 1.0 / scale(w_bits)


def flush_threshold(w_bits: int) -> float:
    """Real weights below this are stored as exactly 0 (sparsity flush)."""
    return 1.0 / (1 << (w_bits + 2))


def to_fixed(x, w_bits: int) -> torch.Tensor:
    """Real-valued counts/weights -> int32 fixed point (round half to even)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return torch.round(x * scale(w_bits)).to(torch.int32)


def from_fixed(n, w_bits: int) -> torch.Tensor:
    """int32 fixed point -> real-valued float32 counts."""
    return torch.as_tensor(n).to(torch.float32) / scale(w_bits)

