"""The Gibbs kernel's noise, frozen: Philox4x32-10 (Salmon et al., SC'11)
in plain int64 PyTorch, and the Gumbel transform of its words.

Token i's noise at topic t is word t & 3 of Philox4x32-10 with counter
(t >> 2, i, offset_lo, offset_hi) and key (seed_lo, seed_hi ^ GIBBS_TAG),
its top 24 bits as u = (x >> 8) * 2^-24, then -log(-log(max(u, tiny))).
A uint32 word is held in an int64; products split the multiplier into
16-bit halves so that none passes 2^48.
"""

from __future__ import annotations

import torch

ROUND_MUL = (0xD2511F53, 0xCD9E8D57)
KEY_STEP = (0x9E3779B9, 0xBB67AE85)
GIBBS_TAG = 0x4C444147
U32 = 0xFFFFFFFF
TINY = torch.finfo(torch.float32).tiny


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    p_lo, p_hi = a * (m & 0xFFFF), a * (m >> 16)
    return (p_hi + (p_lo >> 16)) >> 16, (((p_hi & 0xFFFF) << 16) + p_lo) & U32


def philox(c0, c1, c2, c3, k0, k1) -> tuple[torch.Tensor, ...]:
    """Ten rounds on int64 tensors (broadcast against each other) holding
    uint32 words: the four output words."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + KEY_STEP[0]) & U32, (k1 + KEY_STEP[1]) & U32
        hi0, lo0 = _mulhilo(c0, ROUND_MUL[0])
        hi1, lo1 = _mulhilo(c2, ROUND_MUL[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def gumbel(words: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Philox words -> Gumbel noise in `dtype`."""
    u = (words >> 8).to(torch.float32) * 2.0 ** -24
    u = u.clamp_min_(TINY).to(dtype)
    return u.log_().neg_().log_().neg_()


def gibbs_noise(seed: torch.Tensor, offset: torch.Tensor, start: int, stop: int, k: int,
                dtype=torch.float32) -> torch.Tensor:
    """Noise of tokens [start, stop) at topics [0, k) under (M,) int64 keys
    `seed`, `offset` (the uint64 bits) -> (M, stop - start, k)."""
    dev = seed.device
    lead = (-1, 1, 1)
    s, o = seed.reshape(lead), offset.reshape(lead)
    k0, k1 = s & U32, ((s >> 32) & U32) ^ GIBBS_TAG
    c0 = torch.arange((k + 3) // 4, device=dev, dtype=torch.int64).reshape(1, 1, -1)
    c1 = torch.arange(start, stop, device=dev, dtype=torch.int64).reshape(1, -1, 1)
    words = torch.stack(torch.broadcast_tensors(*philox(c0, c1, o & U32, (o >> 32) & U32, k0, k1)),
                        dim=-1)
    g = gumbel(words, dtype)
    return g.reshape(*g.shape[:2], -1)[..., :k]
