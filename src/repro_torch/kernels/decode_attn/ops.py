"""The flash-decode kernel's wrapper and its plain version.

`decode_attention` is the entry point the model's one-token attention
(`models.model._attn_decode`) calls, with the signature of the reference's
`kernels/decode_attn/ops.py` (itself that of
`models/attention.py::decode_attention`). On a CUDA tensor it validates its
arguments and launches the hand-written Hopper kernel (`kernel.launch`,
from `csrc/decode_attn.cu`), adding one to ``decode_attention.launches``;
there is no fall back. On a CPU tensor it runs `decode_attention_plain`,
the reference's jnp function in eager PyTorch, which is also the yardstick
the kernel is held against on the card.

Both compute single-token GQA attention of q (B, Hq, hd) over a cache
(B, S, Hkv, hd): scores in float32 scaled by hd^-0.5, an optional tanh soft
cap, validity from `pos`/`length` (a ring buffer when `ring`: slot i holds
the position whose age is (pos mod S - i) mod S) and an optional sliding
window, masked scores at -1e30, softmax, and the value average in float32,
returned in q's type. `kv_block` (the TPU's tile) is accepted and unused.

The kernel splits the cache into P partitions (`plan`, from the shape
alone): each writes its partial softmax (m, l, acc), and a second kernel
merges them; `partials_plain` and `merge_partials` are the plain versions
of the two steps.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import PLAIN_DEVICES

NEG_INF = -1e30
MAX_G = 8  # query heads per kv head the kernel holds
MAX_HD = 256
SMS = 132  # streaming multiprocessors of an H100 SXM: the split aims at two blocks each
MAX_PARTS = 512  # the merge kernel's limit
STAGE_BUDGET = 76 * 1024  # shared-memory bytes of a block's stage ring: three blocks an SM


class Plan(NamedTuple):
    """How the kernel cuts a (B, S, Hkv, hd) cache: `tile` positions a
    tile, `stages` tiles in flight, `parts` partitions of `tiles_per_part`
    tiles each (the last may hold fewer)."""
    tile: int
    stages: int
    parts: int
    tiles_per_part: int

    @property
    def launches(self) -> int:
        """CUDA launches a call: the split kernel, and the merge when P > 1."""
        return 1 if self.parts == 1 else 2


def row_bytes(hd: int, itemsize: int) -> int:
    """Shared-memory bytes of one cache row on the kernel's scalar-copy path
    (an odd number of 16-byte units; the tensor-copy path stores rows dense,
    in no more): the bound the tile and stage choice is made on."""
    units = -(-hd * itemsize // 16)
    return 16 * (units + 1 - units % 2)


@functools.lru_cache(maxsize=None)
def plan(b: int, s: int, hkv: int, hd: int, itemsize: int) -> Plan:
    """The split for a cache shape: tiles of 64 positions (32 past 480-byte
    rows), three stages if they fit the budget (else two), and P so that
    B * Hkv * P >= 2 * SMS with at least one tile a partition."""
    rs = row_bytes(hd, itemsize)
    tile = 64 if rs <= 480 else 32
    stages = 3 if 3 * 2 * tile * rs <= STAGE_BUDGET else 2
    ntiles = -(-s // tile)
    want = -(-2 * SMS // (b * hkv))
    tpp = max(1, ntiles // want, -(-ntiles // MAX_PARTS))
    return Plan(tile, stages, -(-ntiles // tpp), tpp)


def valid_positions(s: int, *, length: int, pos: int, window: int = 0, ring: bool = False,
                    device) -> torch.Tensor:
    """(S,) bool: which cache slots the query at `pos` may attend to."""
    idx = torch.arange(s, device=device)
    if ring:
        written = min(length, s)
        age = (pos % s - idx) % s  # age 0 == the current token's own slot
        abs_pos = pos - age
        valid = (age < written) & (abs_pos >= 0)
        if window > 0:
            valid &= abs_pos > pos - window
    else:
        valid = idx < length
        if window > 0:
            valid &= idx > pos - window
    return valid


def decode_attention_plain(q, k_cache, v_cache, *, length: int, pos: int, window: int = 0,
                           ring: bool = False, cap: float = 0.0) -> torch.Tensor:
    """Eager-PyTorch single-token attention over a (possibly ring) cache."""
    b, s, hkv, hd = k_cache.shape
    hq = q.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, hd).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float())
    scores = scores * hd ** -0.5
    if cap > 0.0:
        scores = cap * torch.tanh(scores / cap)
    valid = valid_positions(s, length=int(length), pos=int(pos), window=window, ring=ring,
                            device=q.device)
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(b, hq, hd).to(q.dtype)


def partials_plain(q, k_cache, v_cache, *, length: int, pos: int, window: int = 0,
                   ring: bool = False, cap: float = 0.0, parts: int, slots_per_part: int):
    """The split kernel's first step in eager PyTorch: over each partition of
    `slots_per_part` consecutive slots, the partial softmax of every query
    head, float32 (m (B, Hq, P), l (B, Hq, P), acc (B, Hq, P, hd)). A
    partition with no valid slot has m = -1e30, l = 0, acc = 0."""
    b, s, hkv, hd = k_cache.shape
    hq = q.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, hd).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * hd ** -0.5
    if cap > 0.0:
        scores = cap * torch.tanh(scores / cap)
    valid = valid_positions(s, length=int(length), pos=int(pos), window=window, ring=ring,
                            device=q.device)
    ms, ls, accs = [], [], []
    for i in range(parts):
        lo, hi = i * slots_per_part, min(s, (i + 1) * slots_per_part)
        ok = valid[lo:hi]
        sc = torch.where(ok, scores[..., lo:hi], NEG_INF)
        m = sc.max(-1).values if hi > lo else torch.full(scores.shape[:-1], NEG_INF,
                                                            device=q.device)
        e = torch.where(ok, torch.exp(sc - m[..., None]), 0.0)
        ms.append(m)
        ls.append(e.sum(-1))
        accs.append(torch.einsum("bhgs,bshd->bhgd", e, v_cache[:, lo:hi].float()))
    return (torch.stack(ms, -1).reshape(b, hq, parts),
            torch.stack(ls, -1).reshape(b, hq, parts),
            torch.stack(accs, -2).reshape(b, hq, parts, hd))


def merge_partials(m, l, acc):
    """The merge kernel's plain version: P partial softmaxes (m, l (B, Hq,
    P), acc (B, Hq, P, hd)) into the attention output (B, Hq, hd) float32.
    A partition with l = 0 and m = -1e30 weighs nothing."""
    w = torch.exp(m - m.max(-1, keepdim=True).values)
    return (acc * w[..., None]).sum(-2) / (l * w).sum(-1).clamp_min(1e-30)[..., None]


def any_valid(s: int, *, length: int, pos: int, window: int = 0, ring: bool = False) -> bool:
    """Whether `valid_positions` holds any slot, from host integers: a ring
    with one token written holds the current one (age 0) unless pos < 0; a
    flat cache holds slots 0..min(length, S)-1, of which the window keeps
    those past pos - window."""
    n = min(length, s)
    if n < 1:
        return False
    if ring:
        return pos >= 0
    return window <= 0 or n - 1 > pos - window


def _check(q, k_cache, v_cache, length, pos, window, ring) -> None:
    """What the kernel takes."""
    for name, t in dict(q=q, k_cache=k_cache, v_cache=v_cache).items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise ValueError("q and the caches must share one type, torch.float32 or "
                             "torch.bfloat16")
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError("k_cache and v_cache must both be (B, S, Hkv, hd)")
    b, _, hkv, hd = k_cache.shape
    if q.dim() != 3 or q.shape[0] != b or q.shape[2] != hd or q.shape[1] % hkv:
        raise ValueError(f"q must be (B, G*Hkv, hd) = ({b}, G*{hkv}, {hd})")
    if not 1 <= q.shape[1] // hkv <= MAX_G or not 1 <= hd <= MAX_HD:
        raise ValueError(f"the kernel takes G <= {MAX_G} query heads per kv head and "
                         f"hd <= {MAX_HD}, got G={q.shape[1] // hkv}, hd={hd}")
    if int(pos) < 0 or int(length) < 0:
        raise ValueError(f"pos and length must be >= 0, got {pos}, {length}")
    if not any_valid(k_cache.shape[1], length=int(length), pos=int(pos), window=int(window),
                     ring=bool(ring)):
        # The plain version would average the whole cache; the kernel writes zeros.
        raise ValueError(f"no cache slot is valid at pos={pos}, length={length}, "
                         f"window={window}, ring={ring}")


def decode_attention(q, k_cache, v_cache, *, length, pos, window: int = 0,
                     ring: bool = False, cap: float = 0.0, kv_block: int = 512):
    """(B, Hq, hd) in q's type. `length` and `pos` are host integers. CPU
    tensors take the plain version, and so do `meta` tensors (the dry run's
    shape propagation); CUDA tensors launch the kernel."""
    del kv_block  # the TPU's cache tile; the kernel picks its own
    if q.device.type in PLAIN_DEVICES:
        return decode_attention_plain(q, k_cache, v_cache, length=length, pos=pos,
                                      window=window, ring=ring, cap=cap)
    if q.device.type != "cuda":
        raise ValueError(f"no decode_attn kernel for device {q.device}")
    _check(q, k_cache, v_cache, length, pos, window, ring)
    from repro_torch.kernels.decode_attn import kernel

    b, s, hkv, hd = k_cache.shape
    pl = plan(b, s, hkv, hd, q.element_size())
    out = torch.empty_like(q)
    ws = None if pl.parts == 1 else torch.empty((b, q.shape[1], pl.parts, hd + 2),
                                                dtype=torch.float32, device=q.device)
    kernel.launch(q, k_cache, v_cache, out, ws, length=int(length), pos=int(pos),
                  window=int(window), ring=bool(ring), cap=float(cap), plan=pl)
    _counted.launches += 1
    return out


#: Calls that launched the kernel so far (CUDA tensors only; the plain
#: version never counts): one a call, whether it took one launch or two
#: (`plan(...).launches`).
decode_attention.launches = 0
# The wrapper counts on itself through this name, so a caller that rebinds
# the module's `decode_attention` (to file its calls, say) moves no count.
_counted = decode_attention
