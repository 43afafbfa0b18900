"""Model assembly for the hybrid (Zamba2) family: schema, prefill, decode.

The reference's `repro.models.model` in PyTorch, for ``arch_type ==
"hybrid"``: groups of Mamba2 layers with one weight-shared attention block
applied before each group. Parameter and cache trees keep the reference's
keys and stacked leading dims, so the two packages compare like with like:

  params  embed (V, D), ln_f (D,), shared {ln_attn, attn {wq, wk, wv, wo},
          ln_mlp, mlp {gate, up, down}}, blk {...} stacked (groups, per, ...)
  cache   S (groups, per, B, H, ns, hd) f32, conv (groups, per, B, W-1, C)
          bf16, ak / av (groups, B, window, Hkv, hd) bf16 ring caches

  build_schema(cfg)                          parameter declarations
  init_model(cfg, seed=, device=)            real params on a device
  prefill(params, cfg, batch, cache_len)     -> (cache, last-token logits)
  decode_step(params, cfg, cache, tokens, pos) -> (cache, logits)
  init_cache(cfg, b, cache_len, device=)     zero decode state

`lax.scan` over layers becomes a Python loop. Prefill runs every Mamba2
layer's scan through the chunk_scan kernel's wrapper and every decode step
the shared block's attention through the decode_attn kernel's wrapper
(Hopper kernels on CUDA tensors, their plain versions on the CPU). The
mesh's `constrain` has no counterpart on one card. Other arch families,
and training (`forward_loss`, `unembed_chunked`), wait (ROADMAP.md queue 1,
item 13).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.decode_attn import ops as da_ops
from repro_torch.models import params as plib
from repro_torch.models import ssm
from repro_torch.models.attention import flash_attention
from repro_torch.models.layers import embed, logits_last, mlp, rms_norm, rope
from repro_torch.models.params import PDef

ACT_DTYPE = torch.bfloat16
_NOT_PORTED = "is not ported to repro_torch yet (ROADMAP.md queue 1, item 13)"


def _require_hybrid(cfg: ArchConfig) -> None:
    if cfg.arch_type != "hybrid":
        raise NotImplementedError(f"arch_type {cfg.arch_type!r} ({cfg.name}) {_NOT_PORTED}")


# ===========================================================================
# Schema
# ===========================================================================


def _stack(schema, n: int):
    """Prepend a (n,)-'layers' stack dim to every PDef in a subtree."""
    if isinstance(schema, PDef):
        return PDef((n,) + schema.shape, ("layers",) + schema.axes, schema.init,
                    schema.dtype)
    return {k: _stack(v, n) for k, v in schema.items()}


def _attn_schema(cfg: ArchConfig) -> dict:
    d, q, kv = cfg.d_model, cfg.qkv_dim, cfg.kv_dim
    s = {
        "wq": PDef((d, q), ("embed", "qkv")),
        "wk": PDef((d, kv), ("embed", "kv")),
        "wv": PDef((d, kv), ("embed", "kv")),
        "wo": PDef((q, d), ("qkv", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = PDef((q,), ("qkv",), init="zeros")
        s["bk"] = PDef((kv,), ("kv",), init="zeros")
        s["bv"] = PDef((kv,), ("kv",), init="zeros")
    return s


def _mlp_schema(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    s = {
        "up": PDef((d, f), ("embed", "ff")),
        "down": PDef((f, d), ("ff", "embed")),
    }
    if cfg.mlp_variant in ("swiglu", "geglu"):
        s["gate"] = PDef((d, f), ("embed", "ff"))
    return s


def _block_schema(cfg: ArchConfig) -> dict:
    """One decoder block: (pre-)norms + attention + MLP (+ post-norms)."""
    if cfg.num_experts:
        raise NotImplementedError(f"MoE blocks {_NOT_PORTED}")
    d = cfg.d_model
    s = {
        "ln_attn": PDef((d,), ("embed",), init="zeros"),
        "attn": _attn_schema(cfg),
        "ln_mlp": PDef((d,), ("embed",), init="zeros"),
        "mlp": _mlp_schema(cfg),
    }
    if cfg.post_norms:
        s["ln_post_attn"] = PDef((d,), ("embed",), init="zeros")
        s["ln_post_mlp"] = PDef((d,), ("embed",), init="zeros")
    return s


def _mamba_block_schema(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    h, hd, ns = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    inner = h * hd
    width = 2 * inner + 2 * ns + h
    return {
        "ln": PDef((d,), ("embed",), init="zeros"),
        "in_proj": PDef((d, width), ("embed", None)),
        "conv_w": PDef((cfg.conv_width, inner + 2 * ns), (None, None), init="small_normal"),
        "dt_bias": PDef((h,), (None,), init="zeros", dtype="float32"),
        "a_log": PDef((h,), (None,), init="decay", dtype="float32"),
        "d_skip": PDef((h,), (None,), init="ones", dtype="float32"),
        "ln_y": PDef((inner,), ("qkv",), init="zeros"),
        "out_proj": PDef((inner, d), ("qkv", "embed")),
    }


def _hybrid_groups(cfg: ArchConfig) -> tuple[int, int]:
    per = cfg.hybrid_attn_every
    if per < 1 or cfg.num_layers % per:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers in groups of {per}")
    return cfg.num_layers // per, per


def build_schema(cfg: ArchConfig) -> dict:
    _require_hybrid(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    s: dict = {
        "embed": PDef((v, d), ("vocab", "embed")),
        "ln_f": PDef((d,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        s["head"] = PDef((v, d), ("vocab", "embed"))
    groups, per = _hybrid_groups(cfg)
    s["blk"] = _stack(_stack(_mamba_block_schema(cfg), per), groups)
    s["shared"] = _block_schema(cfg)  # ONE weight-shared attention block
    return s


def init_model(cfg: ArchConfig, *, seed: int = 0, device: DeviceLike = None) -> dict:
    """Real parameters on `device` (default CUDA), drawn from `seed`."""
    return plib.init_params(build_schema(cfg), seed=seed, device=device)


def _layer(tree, *idx):
    """The parameters of one stacked layer: every leaf indexed by `idx`."""
    if isinstance(tree, dict):
        return {k: _layer(v, *idx) for k, v in tree.items()}
    return tree[idx]


# ===========================================================================
# Attention pieces
# ===========================================================================


def _project_qkv(p, h, cfg: ArchConfig, positions):
    b, s, _ = h.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(b, s, hq, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, hkv, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, hkv, hd)


def _attn_full(p, h, cfg: ArchConfig, *, positions, window=0):
    """Full-sequence causal self-attention. Returns (out, (k, v)) for KV
    caching."""
    b, s, _ = h.shape
    q, k, v = _project_qkv(p, h, cfg, positions)
    out = flash_attention(q, k, v, window=window, cap=cfg.attn_softcap)
    return out.reshape(b, s, cfg.qkv_dim) @ p["wo"], (k, v)


def _attn_decode(p, h1, cfg: ArchConfig, ck, cv, pos: int, *, window=0, ring=False):
    """One-token attention against a cache. h1: (B, 1, D). Writes the new
    key and value into the cache tensors in place (the reference returns
    updated copies) and returns (out, ck, cv)."""
    b = h1.shape[0]
    hq, hd = cfg.num_heads, cfg.head_dim
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=h1.device)
    q, k, v = _project_qkv(p, h1, cfg, positions)
    slot = (pos % ck.shape[1]) if ring else pos
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    out = da_ops.decode_attention(
        q.reshape(b, hq, hd), ck, cv, length=pos + 1, pos=pos,
        window=window, ring=ring, cap=cfg.attn_softcap)
    return out.reshape(b, 1, hq * hd) @ p["wo"], ck, cv


# ===========================================================================
# Blocks (full-sequence and decode variants)
# ===========================================================================


def _block_full(p, x, cfg: ArchConfig, *, positions, window=0):
    """(residual) -> attn -> (residual) -> mlp. Returns (x, kv)."""
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    attn_out, kv = _attn_full(p["attn"], h, cfg, positions=positions, window=window)
    if cfg.post_norms:
        attn_out = rms_norm(attn_out, p["ln_post_attn"], cfg.norm_eps)
    x = x + attn_out
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    m = mlp(h, p["mlp"], cfg.mlp_variant)
    if cfg.post_norms:
        m = rms_norm(m, p["ln_post_mlp"], cfg.norm_eps)
    return x + m, kv


def _block_decode(p, x, cfg: ArchConfig, ck, cv, pos: int, *, window=0, ring=False):
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    attn_out, ck, cv = _attn_decode(p["attn"], h, cfg, ck, cv, pos, window=window,
                                    ring=ring)
    if cfg.post_norms:
        attn_out = rms_norm(attn_out, p["ln_post_attn"], cfg.norm_eps)
    x = x + attn_out
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    m = mlp(h, p["mlp"], cfg.mlp_variant)
    if cfg.post_norms:
        m = rms_norm(m, p["ln_post_mlp"], cfg.norm_eps)
    return x + m, ck, cv


# ===========================================================================
# Full-sequence forward (prefill)
# ===========================================================================


def _embed_in(params, cfg: ArchConfig, tokens):
    return embed(tokens, params["embed"], cfg.embed_scale).to(ACT_DTYPE)


def _forward_hybrid(params, cfg, tokens, *, collect_state=False):
    """zamba2: groups of mamba2 layers with a weight-shared attention block.
    Returns (hidden, per-group [((k, v), [(S, conv) per layer])] or None)."""
    b, s = tokens.shape
    x = _embed_in(params, cfg, tokens)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    shared = params["shared"]
    groups, per = _hybrid_groups(cfg)
    states = []
    for gi in range(groups):
        # Weight-shared attention block (sliding window for long context).
        x, kv = _block_full(shared, x, cfg, positions=positions, window=cfg.sliding_window)
        sts = []
        for li in range(per):
            p = _layer(params["blk"], gi, li)
            h = rms_norm(x, p["ln"], cfg.norm_eps)
            y, st = ssm.mamba2_mix(p, h, None, None, cfg)
            x = x + y
            sts.append(st)
        states.append((kv, sts))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x, (states if collect_state else None)


def forward_hidden(params, cfg: ArchConfig, batch, *, collect=False):
    """The family forward (hybrid only). Returns (hidden, caches-raw)."""
    _require_hybrid(cfg)
    return _forward_hybrid(params, cfg, batch["tokens"], collect_state=collect)


def unembed_table(params, cfg: ArchConfig):
    return params["embed"] if cfg.tie_embeddings else params["head"]


# ===========================================================================
# Decode caches
# ===========================================================================


def _window(cfg: ArchConfig, cache_len: int) -> int:
    return min(cfg.sliding_window, cache_len) if cfg.sliding_window else cache_len


def _cache_desc(cfg: ArchConfig, b: int, cache_len: int) -> dict:
    """name -> (shape, dtype) for the decode state."""
    _require_hybrid(cfg)
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    w = _window(cfg, cache_len)
    g, per = _hybrid_groups(cfg)
    h, hd_s, ns = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    cdim = h * hd_s + 2 * ns
    return {
        "S": ((g, per, b, h, ns, hd_s), torch.float32),
        "conv": ((g, per, b, cfg.conv_width - 1, cdim), ACT_DTYPE),
        "ak": ((g, b, w, hkv, hd), ACT_DTYPE),
        "av": ((g, b, w, hkv, hd), ACT_DTYPE),
    }


def init_cache(cfg: ArchConfig, b: int, cache_len: int, *, device: DeviceLike = None):
    dev = resolve_device(device)
    return {k: torch.zeros(sh, dtype=dt, device=dev)
            for k, (sh, dt) in _cache_desc(cfg, b, cache_len).items()}


# ===========================================================================
# Prefill (full forward + cache extraction)
# ===========================================================================


def _ring_tail(k_full, w):
    """Last `w` positions of (..., S, H, hd), ring-aligned: position p lands
    in slot p mod w, as `decode_step` and the decode kernel read the ring.
    The reference takes the tail unrolled (slots 0..w-1), which is aligned
    only when S % w == 0; here it is rolled by S mod w."""
    s = k_full.shape[-3]
    if s <= w:
        return F.pad(k_full, (0, 0, 0, 0, 0, w - s))
    return torch.roll(k_full[..., s - w:, :, :], s % w, dims=-3)


def prefill(params, cfg: ArchConfig, batch, cache_len: int):
    """Full forward over the prompt; returns (cache, last-token logits)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if s > cache_len:
        raise ValueError(f"prompt of {s} tokens past the cache of {cache_len}")
    h, raw = forward_hidden(params, cfg, batch, collect=True)
    logits = logits_last(h[:, -1], unembed_table(params, cfg), cfg.final_softcap)
    w = _window(cfg, cache_len)
    desc = _cache_desc(cfg, b, cache_len)
    cache = {
        "S": torch.stack([torch.stack([st[0] for st in sts]) for _, sts in raw]),
        "conv": torch.stack([torch.stack([st[1] for st in sts]) for _, sts in raw]),
        "ak": torch.stack([_ring_tail(kv[0], w) for kv, _ in raw]),
        "av": torch.stack([_ring_tail(kv[1], w) for kv, _ in raw]),
    }
    cache = {k: v.to(desc[k][1]).contiguous() for k, v in cache.items()}
    return cache, logits


# ===========================================================================
# Decode step (one new token)
# ===========================================================================


def decode_step(params, cfg: ArchConfig, cache, tokens, pos: int):
    """One serving step: tokens (B,) at host position `pos` -> (cache,
    logits). The cache's tensors are updated in place and returned."""
    _require_hybrid(cfg)
    x = embed(tokens[:, None], params["embed"], cfg.embed_scale).to(ACT_DTYPE)
    shared = params["shared"]
    groups, per = _hybrid_groups(cfg)
    for gi in range(groups):
        x, _, _ = _block_decode(shared, x, cfg, cache["ak"][gi], cache["av"][gi], pos,
                                window=cfg.sliding_window, ring=True)
        for li in range(per):
            p = _layer(params["blk"], gi, li)
            h = rms_norm(x, p["ln"], cfg.norm_eps)
            y, (S1, c1) = ssm.mamba2_mix_step(p, h, cache["S"][gi, li],
                                              cache["conv"][gi, li].to(h.dtype), cfg)
            cache["S"][gi, li] = S1
            cache["conv"][gi, li] = c1.to(ACT_DTYPE)
            x = x + y
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_last(x[:, 0], unembed_table(params, cfg), cfg.final_softcap)
    return cache, logits

