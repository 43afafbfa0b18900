"""Attention: blocked (flash-style) full-sequence + single-token decode.

The reference's `repro.models.attention` in PyTorch. `flash_attention`
takes, for each q tile, kv tiles in turn with online softmax, masked
entries at -1e30, memory bounded by one (q_block, kv_block) score tile. It
visits only the kv tiles that can hold an unmasked entry for some query of
the tile (`_block_pairs`: causal and window, enumerated on the host as the
reference's "triangular" strategy enumerates them at trace time). A tile it
skips would add exp(-1e30 - m) = 0 under the reference's "masked" strategy,
which visits every tile, so one enumeration computes both of the
reference's strategies to the float32 rounding of the same sums; without a
causal mask or a window it visits every tile, as "masked" does. The
reference computes both outside any Pallas kernel, so this is plain
PyTorch too (tile products by `torch.matmul` in float32; bf16 products are
exact there).

`decode_attention` is the reference's jnp decode (attention.py:177), the
plain version of the flash-decode kernel; the model's decode step calls
the kernel's wrapper (`kernels/decode_attn/ops.decode_attention`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attn import ops as da_ops
from repro_torch.models.layers import softcap

NEG_INF = da_ops.NEG_INF


def _block_pairs(nq: int, nkv: int, *, causal: bool, window: int, q_block: int,
                 kv_block: int, q_offset: int) -> list[tuple[int, int]]:
    """The (q tile, kv tile) pairs that can hold an unmasked entry: the
    reference's triangular enumeration, with q tile qb starting at position
    `q_offset + qb * q_block` (the reference rounds `q_offset` down to whole
    tiles, which equals this where it is a multiple of q_block)."""
    pairs = []
    for qb in range(nq):
        q_lo = q_offset + qb * q_block
        q_hi = q_lo + q_block - 1
        for kb in range(nkv):
            k_lo = kb * kv_block
            k_hi = k_lo + kv_block - 1
            if causal and k_lo > q_hi:
                continue  # entirely in the future
            if window > 0 and k_hi < q_lo - (window - 1) - (q_block - 1):
                continue  # outside the window for every query of the tile
            pairs.append((qb, kb))
    return pairs


def _tile_mask(q_pos, k_pos, *, causal, window):
    m = torch.ones(q_pos.shape[0], k_pos.shape[0], dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, cap: float = 0.0,
                    q_offset: int = 0, q_block: int = 512, kv_block: int = 1024):
    """Blocked attention with online softmax over the kv tiles that can hold
    an unmasked entry (the masked entries at -1e30). q: (B, Sq, Hq, hd); k,
    v: (B, Skv, Hkv, hd). Returns (B, Sq, Hq, hd) in q's type."""
    b, sq, hq, hd = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = hd ** -0.5

    q_block = min(q_block, sq)
    kv_block = min(kv_block, skv)
    pq, pk = (-sq) % q_block, (-skv) % kv_block
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    nq, nkv = (sq + pq) // q_block, (skv + pk) // kv_block
    kv_tiles = [[] for _ in range(nq)]
    for qb, kb in _block_pairs(nq, nkv, causal=causal, window=window, q_block=q_block,
                               kv_block=kv_block, q_offset=q_offset):
        kv_tiles[qb].append(kb)

    # (B, Hkv, G, S, hd) float32 views of the whole sequence.
    qg = q.float().reshape(b, sq + pq, hkv, g, hd).permute(0, 2, 3, 1, 4)
    kh = k.float().permute(0, 2, 1, 3)[:, :, None]  # (B, Hkv, 1, Skv, hd)
    vh = v.float().permute(0, 2, 1, 3)[:, :, None]
    dev = q.device

    outs = []
    for qb in range(nq):
        q_tile = qg[..., qb * q_block:(qb + 1) * q_block, :]
        q_pos = q_offset + qb * q_block + torch.arange(q_block, device=dev)
        m_run = torch.full((b, hkv, g, q_block), NEG_INF, device=dev)
        l_run = torch.zeros(b, hkv, g, q_block, device=dev)
        acc = torch.zeros(b, hkv, g, q_block, hd, device=dev)
        for kb in kv_tiles[qb]:
            k_tile = kh[..., kb * kv_block:(kb + 1) * kv_block, :]
            v_tile = vh[..., kb * kv_block:(kb + 1) * kv_block, :]
            k_pos = kb * kv_block + torch.arange(kv_block, device=dev)
            s = softcap((q_tile @ k_tile.transpose(-1, -2)) * scale, cap)
            mask = _tile_mask(q_pos, k_pos, causal=causal, window=window)
            mask &= (k_pos < skv)[None, :]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ v_tile
            m_run = m_new
        outs.append(acc / torch.clamp_min(l_run, 1e-30)[..., None])
    out = torch.cat(outs, dim=3)  # (B, Hkv, G, Sq', hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, nq * q_block, hq, hd)[:, :sq]
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, length, pos, window: int = 0,
                     ring: bool = False, cap: float = 0.0):
    """Single-token attention over a (possibly ring) KV cache (plain)."""
    return da_ops.decode_attention_plain(q, k_cache, v_cache, length=length, pos=pos,
                                         window=window, ring=ring, cap=cap)
