"""Model assembly for the dense, moe, ssm, hybrid, vlm and audio families.

The reference's `repro.models.model` in PyTorch for its six arch families:

  dense   decoder blocks (`qwen2-7b`, `gemma-7b`, `phi3-medium-14b`), every
          layer windowed (`gemma2-9b-sw`, attn_pattern "local") or local and
          global layers in pairs (`gemma2-9b`, "local_global")
  moe     the dense decoder with a MoE layer (`models/moe.py`) in each
          block's MLP place: every layer (`arctic-480b`, with its dense
          residual), or dense and MoE layers in pairs (`moe_every` 2,
          `llama4-maverick-400b-a17b`, with its shared expert; the dense
          layers' d_ff is `moe_dense_layer_ff`)
  ssm     RWKV6 blocks (`rwkv6-1.6b`): time mix + channel mix
  hybrid  groups of Mamba2 layers with one weight-shared attention block
          applied before each group (`zamba2-2.7b`)
  vlm     groups of self-attention decoder blocks closed by one gated
          cross-attention block over image patches (`llama-3.2-vision-90b`)
  audio   a non-causal encoder over audio frames, then decoder blocks with
          self-attention and cross-attention to the encoder (`whisper-base`)

Parameter and cache trees keep the reference's keys and stacked leading
dims, so the two packages compare like with like:

  params  embed (V, D), ln_f (D,), head (V, D) when untied, and
          dense   blk {...} (L, ...), or local / global {...} (L/2, ...)
          moe     blk {..., moe {router (D, E) f32, w_gate, w_up (E_held,
                  D, F), w_down (E_held, F, D), dense {...}}} (L, ...), or
                  dense_blk / moe_blk {...} (L/2, ...)
          ssm     ln0 (D,), blk {ln1, ln2, att {...}, ffn {...}} (L, ...)
          hybrid  shared {ln_attn, attn, ln_mlp, mlp}, blk {...} (groups, per, ...)
          vlm     blk {...} (groups, every - 1, ...), xblk {..., gate_attn,
                  gate_mlp (1,) f32} (groups, ...)
          audio   enc {...} (encoder layers, ...), enc_ln_f (D,), dec {...,
                  ln_cross, xattn} (L, ...)
  cache   dense   k / v (L, B, S, Hkv, hd) bf16 (S the window's ring when
                  "local"), or k_local / v_local (L/2, B, window, ...) rings
                  and k_global / v_global (L/2, B, cache_len, ...)
          moe     k / v (L, B, S, Hkv, hd), or k_dense / v_dense / k_moe /
                  v_moe (L/2, B, S, Hkv, hd) for pairs
          ssm     S (L, B, H, dk, dk) f32, ax / fx (L, B, 1, D) bf16
          hybrid  S (groups, per, B, H, ns, hd) f32, conv (groups, per, B,
                  W-1, C) bf16, ak / av (groups, B, window, Hkv, hd) bf16 rings
          vlm     k / v (groups, every - 1, B, S, Hkv, hd), xk / xv (groups,
                  B, patches, Hkv, hd): the cross layers' static keys
          audio   k / v (L, B, S, Hkv, hd), xk / xv (L, B, frames, Hkv, hd)

  build_schema(cfg)                          parameter declarations
  init_model(cfg, seed=, device=)            real params on a device
  forward_hidden(params, cfg, batch)         -> (final hidden, aux, raw caches)
  forward_loss(params, cfg, batch)           -> (mean NLL + MoE aux, aux)
  real_batch(cfg, kind, b, s, generator=)    a random batch
  prefill(params, cfg, batch, cache_len)     -> (cache, last-token logits)
  decode_step(params, cfg, cache, tokens, pos) -> (cache, logits)
  init_cache(cfg, b, cache_len, device=)     zero decode state

Activations and caches take the weights' type: bf16 as the reference's
(`init_model`); a float32 copy of the weights runs the same path in float32
(the kernels take both), with float32 recurrent states either way.
`lax.scan` over layers becomes a Python loop. Prefill runs every RWKV6
and Mamba2 layer's scan through the chunk_scan kernel's wrappers, and
every decode step every attention layer (dense, moe, vlm, audio: self and
cross) or the shared block (hybrid) through the decode_attn kernel's
wrapper (Hopper kernels on CUDA tensors, their plain versions on the CPU).
A cross-attention step reads every slot of its static cache (`length =
pos = S`) and writes none. The vlm and audio families take their frontend
stub's output in the batch: `patches` (B, 1024, D) or `frames` (B, 1500,
D). A MoE layer's capacity follows the reference's serving policy: a
one-token input (every decode step, and a one-token prompt) never drops,
cf = E; a longer one runs at `capacity_factor`, the reference's 2.0 unless
`forward_hidden` / `prefill` are given another. The flash attention visits
only the tiles that can hold an unmasked entry (the reference's
"triangular" strategy, `models/attention.py`). The mesh's `constrain` has
no counterpart on one card; the dry run's `abstract_model`,
`abstract_cache` and `abstract_batch` (`meta` tensors) and the specs of a
pod's layout (`model_pspecs`, `cache_pspecs`, `batch_pspecs`: plain tuples,
`sharding.specs`) are the reference's.

Training is `forward_loss`: the full forward with `train=True` (a MoE
layer at the config's training capacity, its aux losses summed into the
loss; with `cfg.remat` each layer, pair or group under
`torch.utils.checkpoint`, the reference's `jax.checkpoint` of each scan
body) and `use_kernel=False` by default, as the reference's, so the RWKV6
and Mamba2 scans take their plain versions, which autograd differentiates
(the chunk_scan kernels have no backward and refuse grad mode); then the
NLL chunked over the sequence both ways (`layers.unembed_chunked`). The
serving entries keep `use_kernel=True`, the port's default.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.decode_attn import ops as da_ops
from repro_torch.models import moe
from repro_torch.models import params as plib
from repro_torch.models import ssm
from repro_torch.models.attention import flash_attention
from repro_torch.models.layers import (embed, logits_last, mlp, rms_norm, rope,
                                       unembed_chunked)
from repro_torch.models.params import PDef

ACT_DTYPE = torch.bfloat16  # the weights' type, and so the activations' and caches'
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
PREFILL_CAPACITY = 2.0  # the reference's MoE capacity factor for inputs of 2+ tokens


def _require_family(cfg: ArchConfig) -> None:
    """Every entry's guard: an unknown arch_type raises here, before any
    family dispatch could take it for another."""
    if cfg.arch_type not in FAMILIES:
        raise ValueError(f"unknown arch_type {cfg.arch_type!r} ({cfg.name})")


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


def _moe_schema(cfg: ArchConfig) -> dict:
    """The router over all E experts; the expert weights of the experts
    this card holds (`cfg.expert_slice`: all E unless an `ExpertShare`)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    lo, hi = cfg.expert_slice
    s = {
        "router": PDef((d, e), ("embed", "experts"), dtype="float32"),
        "w_gate": PDef((hi - lo, d, f), ("experts", "embed", "expert_ff")),
        "w_up": PDef((hi - lo, d, f), ("experts", "embed", "expert_ff")),
        "w_down": PDef((hi - lo, f, d), ("experts", "expert_ff", "embed")),
    }
    if cfg.moe_dense_ff:
        s["dense"] = {
            "gate": PDef((d, cfg.moe_dense_ff), ("embed", "ff")),
            "up": PDef((d, cfg.moe_dense_ff), ("embed", "ff")),
            "down": PDef((cfg.moe_dense_ff, d), ("ff", "embed")),
        }
    return s


def _block_schema(cfg: ArchConfig, *, cross: bool = False) -> dict:
    """One decoder block: (pre-)norms + attention + MLP or MoE (+ post-norms)."""
    d = cfg.d_model
    s = {
        "ln_attn": PDef((d,), ("embed",), init="zeros"),
        "attn": _attn_schema(cfg),
        "ln_mlp": PDef((d,), ("embed",), init="zeros"),
    }
    if cfg.num_experts:
        s["moe"] = _moe_schema(cfg)
    else:
        s["mlp"] = _mlp_schema(cfg)
    if cfg.post_norms:
        s["ln_post_attn"] = PDef((d,), ("embed",), init="zeros")
        s["ln_post_mlp"] = PDef((d,), ("embed",), init="zeros")
    if cross:
        # llama-3.2-vision's gated cross-attention layer: zero-init gates make
        # the layer a no-op at init (the model-card recipe).
        s["gate_attn"] = PDef((1,), (None,), init="zeros", dtype="float32")
        s["gate_mlp"] = PDef((1,), (None,), init="zeros", dtype="float32")
    return s


def _rwkv_block_schema(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    h, dk = cfg.ssm_heads, cfg.ssm_head_dim
    lora = max(32, d // 32)
    att = {
        "w_r": PDef((d, h * dk), ("embed", "qkv")),
        "w_k": PDef((d, h * dk), ("embed", "qkv")),
        "w_v": PDef((d, h * dk), ("embed", "qkv")),
        "w_g": PDef((d, h * dk), ("embed", "qkv")),
        "w_o": PDef((h * dk, d), ("qkv", "embed")),
        "w0": PDef((h * dk,), ("qkv",), init="decay", dtype="float32"),
        "w_lora_a": PDef((d, lora), ("embed", None)),
        "w_lora_b": PDef((lora, h * dk), (None, "qkv"), init="small_normal"),
        "u": PDef((h, dk), (None, None), init="small_normal", dtype="float32"),
        "ln_x": PDef((h * dk,), ("qkv",), init="zeros"),
    }
    for m in ("r", "k", "v", "g", "w"):
        att[f"mu_{m}"] = PDef((d,), ("embed",), init="small_normal")
    ffn = {
        "mu_ck": PDef((d,), ("embed",), init="small_normal"),
        "up": PDef((d, f), ("embed", "ff")),
        "down": PDef((f, d), ("ff", "embed")),
    }
    return {
        "ln1": PDef((d,), ("embed",), init="zeros"),
        "ln2": PDef((d,), ("embed",), init="zeros"),
        "att": att,
        "ffn": ffn,
    }


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


def _moe_pairs(cfg: ArchConfig) -> bool:
    """Dense and MoE layers in pairs (llama4: `moe_every` 2)."""
    return bool(cfg.num_experts) and cfg.moe_every == 2


def _pair_dense_cfg(cfg: ArchConfig) -> ArchConfig:
    """The config of the dense layers of a paired (llama4) MoE stack."""
    return dataclasses.replace(cfg, num_experts=0, experts_per_token=0, moe_dense_ff=0,
                               d_ff=cfg.moe_dense_layer_ff or cfg.d_ff)


def _hybrid_groups(cfg: ArchConfig) -> tuple[int, int]:
    per = cfg.hybrid_attn_every
    if per < 1 or cfg.num_layers % per:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers in groups of {per}")
    return cfg.num_layers // per, per


def n_cross(cfg: ArchConfig) -> int:
    """Number of (self + ... + cross) groups of a VLM config."""
    if cfg.cross_attn_every < 2 or cfg.num_layers % cfg.cross_attn_every:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers in groups of "
                         f"{cfg.cross_attn_every}")
    return cfg.num_layers // cfg.cross_attn_every


def build_schema(cfg: ArchConfig) -> dict:
    _require_family(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    s: dict = {
        "embed": PDef((v, d), ("vocab", "embed")),
        "ln_f": PDef((d,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        s["head"] = PDef((v, d), ("vocab", "embed"))
    if cfg.arch_type in ("dense", "moe"):
        if cfg.attn_pattern == "local_global":
            half = cfg.num_layers // 2
            s["local"] = _stack(_block_schema(cfg), half)
            s["global"] = _stack(_block_schema(cfg), half)
        elif _moe_pairs(cfg):
            half = cfg.num_layers // 2
            s["dense_blk"] = _stack(_block_schema(_pair_dense_cfg(cfg)), half)
            s["moe_blk"] = _stack(_block_schema(cfg), half)
        else:
            s["blk"] = _stack(_block_schema(cfg), cfg.num_layers)
    elif cfg.arch_type == "ssm":
        s["ln0"] = PDef((d,), ("embed",), init="zeros")
        s["blk"] = _stack(_rwkv_block_schema(cfg), cfg.num_layers)
    elif cfg.arch_type == "vlm":
        groups = n_cross(cfg)
        s["blk"] = _stack(_stack(_block_schema(cfg), cfg.cross_attn_every - 1), groups)
        s["xblk"] = _stack(_block_schema(cfg, cross=True), groups)
    elif cfg.arch_type == "audio":
        s["enc"] = _stack(_block_schema(cfg), cfg.encoder_layers)
        s["enc_ln_f"] = PDef((d,), ("embed",), init="zeros")
        dec = _block_schema(cfg)
        dec["ln_cross"] = PDef((d,), ("embed",), init="zeros")
        dec["xattn"] = _attn_schema(cfg)
        s["dec"] = _stack(dec, cfg.num_layers)
    else:  # hybrid
        groups, per = _hybrid_groups(cfg)
        s["blk"] = _stack(_stack(_mamba_block_schema(cfg), per), groups)
        s["shared"] = _block_schema(cfg)  # ONE weight-shared attention block
    return s


def init_model(cfg: ArchConfig, *, seed: int = 0, device: DeviceLike = None) -> dict:
    """Real parameters on `device` (default CUDA), drawn from `seed`."""
    return plib.init_params(build_schema(cfg), seed=seed, device=device)


def abstract_model(cfg: ArchConfig) -> dict:
    """The parameter tree as `meta` tensors (the dry run's)."""
    return plib.abstract_params(build_schema(cfg))


def model_pspecs(cfg: ArchConfig, mesh) -> dict:
    """Each parameter's spec on `mesh` (`sharding.specs`: plain tuples)."""
    from repro_torch.sharding.specs import build_rules

    return plib.partition_specs(build_schema(cfg), build_rules(cfg, mesh))


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


def _attn_full(p, h, cfg: ArchConfig, *, positions, window=0, causal=True, cross_src=None):
    """Full-sequence attention: self-attention (causal unless asked), or
    with `cross_src` (B, T, D) cross-attention to it (queries without rope,
    keys and values projected from `cross_src`, no mask). Returns (out,
    (k, v)) for KV caching."""
    b, s, _ = h.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cross_src is not None:
        q = h @ p["wq"]
        if "bq" in p:
            q = q + p["bq"]
        q = q.reshape(b, s, hq, hd)  # no rope on cross-attention queries
        k = (cross_src @ p["wk"]).reshape(b, -1, hkv, hd)
        v = (cross_src @ p["wv"]).reshape(b, -1, hkv, hd)
        causal = False
    else:
        q, k, v = _project_qkv(p, h, cfg, positions)
    out = flash_attention(q, k, v, causal=causal, window=window, cap=cfg.attn_softcap)
    return out.reshape(b, s, cfg.qkv_dim) @ p["wo"], (k, v)


def _attn_decode(p, h1, cfg: ArchConfig, ck, cv, pos: int, *, window=0, ring=False,
                 cross=False):
    """One-token attention against a cache. h1: (B, 1, D). Writes the new
    key and value into the cache tensors in place (the reference returns
    updated copies) and returns (out, ck, cv). With `cross` the cache is a
    static encoder or image cache: every slot is read (`length = pos = S`)
    and none is written."""
    b = h1.shape[0]
    hq, hd = cfg.num_heads, cfg.head_dim
    if cross:
        q = (h1 @ p["wq"]).reshape(b, hq, hd)
        out = da_ops.decode_attention(q, ck, cv, length=ck.shape[1], pos=ck.shape[1],
                                      cap=cfg.attn_softcap)
        return out.reshape(b, 1, hq * hd) @ p["wo"], ck, cv
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


def _gated(p, name, y, x):
    """`y` times tanh of the block's float32 gate `name` in x's type (the
    VLM's cross blocks), or `y` as it is (no such gate)."""
    return torch.tanh(p[name]).to(x.dtype) * y if name in p else y


def _zero_aux(device) -> dict:
    """The MoE aux losses' running sums: float32 zeros on `device`."""
    return {"load_balance": torch.zeros((), device=device),
            "router_z": torch.zeros((), device=device)}


def _mlp_or_moe(p, h, cfg: ArchConfig, capacity_factor, aux, *, train=False):
    """The block's MLP, or its MoE layer with its `load_balance` and
    `router_z` added to `aux` (a dict of running sums; None: not kept).
    Capacity: in training `capacity_factor` as given (None: the config's
    training factor); in serving the reference's policy, no drop for a
    one-token input (cf = E; every decode step), `capacity_factor` for
    longer ones. Returns (out, aux)."""
    if not cfg.num_experts:
        return mlp(h, p["mlp"], cfg.mlp_variant), aux
    cf = capacity_factor if train or h.shape[1] > 1 else float(cfg.num_experts)
    out, a = moe.moe_layer(p["moe"], h, cfg, capacity_factor=cf)
    if aux is not None:
        aux = {k: aux[k] + a[k] for k in aux}
    return out, aux


def _block_full(p, x, cfg: ArchConfig, aux, *, positions, window=0, causal=True,
                cross_src=None, capacity_factor=PREFILL_CAPACITY, train=False):
    """(residual) -> attn -> (residual) -> mlp or moe, each branch
    tanh-gated in a VLM cross block. Returns (x, kv, aux)."""
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    attn_out, kv = _attn_full(p["attn"], h, cfg, positions=positions, window=window,
                              causal=causal, cross_src=cross_src)
    if cfg.post_norms:
        attn_out = rms_norm(attn_out, p["ln_post_attn"], cfg.norm_eps)
    x = x + _gated(p, "gate_attn", attn_out, x)
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    m, aux = _mlp_or_moe(p, h, cfg, capacity_factor, aux, train=train)
    if cfg.post_norms:
        m = rms_norm(m, p["ln_post_mlp"], cfg.norm_eps)
    return x + _gated(p, "gate_mlp", m, x), kv, aux


def _block_decode(p, x, cfg: ArchConfig, ck, cv, pos: int, *, window=0, ring=False,
                  cross=False):
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    attn_out, ck, cv = _attn_decode(p["attn"], h, cfg, ck, cv, pos, window=window,
                                    ring=ring, cross=cross)
    if cfg.post_norms:
        attn_out = rms_norm(attn_out, p["ln_post_attn"], cfg.norm_eps)
    x = x + _gated(p, "gate_attn", attn_out, x)
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    m, _ = _mlp_or_moe(p, h, cfg, PREFILL_CAPACITY, None)
    if cfg.post_norms:
        m = rms_norm(m, p["ln_post_mlp"], cfg.norm_eps)
    return x + _gated(p, "gate_mlp", m, x), ck, cv


def _sinusoid(s: int, d: int, dtype, device, offset: int = 0) -> torch.Tensor:
    """Whisper-style sinusoidal positions (s, d) for positions offset ..
    offset + s - 1: computed in float32, returned in `dtype`."""
    pos = offset + torch.arange(s, device=device, dtype=torch.float32)[:, None]
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(half, device=device,
                                                        dtype=torch.float32)
                     / max(half - 1, 1))
    ang = pos * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _maybe_ckpt(fn, cfg: ArchConfig, train: bool):
    """`fn`, or `fn` under non-reentrant `torch.utils.checkpoint` when
    training with `cfg.remat`: the reference's `_maybe_ckpt` around each
    scan body, so that a layer's (a pair's, a group's) activations are
    recomputed in the backward and only its inputs are kept."""
    if not (train and cfg.remat):
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn, use_reentrant=False)


def _unstack(tree) -> list:
    """A stacked parameter tree as the list of its layers' trees: every leaf
    unbound along its first dim (views; one autograd node a leaf, whose
    backward stacks the layers' gradients once)."""
    if not isinstance(tree, dict):
        return list(tree.unbind(0))
    subs = {k: _unstack(v) for k, v in tree.items()}
    n = len(next(iter(subs.values())))
    return [{k: v[i] for k, v in subs.items()} for i in range(n)]


# ===========================================================================
# Full-sequence forward (training and prefill)
# ===========================================================================


def _embed_in(params, cfg: ArchConfig, tokens):
    return embed(tokens, params["embed"], cfg.embed_scale).to(params["embed"].dtype)


def _local_window(cfg: ArchConfig) -> int:
    """The window of a dense stack's layers ("local": every layer) or of
    the local half of each pair ("local_global"); 0 is full attention."""
    return cfg.sliding_window if cfg.attn_pattern in ("local", "local_global") else 0


def _forward_dense(params, cfg, tokens, *, train, collect_kv, capacity_factor):
    """dense and moe families (gemma2's local/global pairs and llama4's
    dense/MoE pairs included). Returns (hidden, aux, [(k, v) a layer] or,
    for pairs, ([(k, v) first], [(k, v) second]), or None)."""
    b, s = tokens.shape
    x = _embed_in(params, cfg, tokens)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    run = dict(positions=positions, capacity_factor=capacity_factor, train=train)
    if cfg.attn_pattern == "local_global" or _moe_pairs(cfg):
        if _moe_pairs(cfg):
            pair = ((params["dense_blk"], _pair_dense_cfg(cfg), 0), (params["moe_blk"], cfg, 0))
        else:
            pair = ((params["local"], cfg, _local_window(cfg)), (params["global"], cfg, 0))

        def body(x, aux, pp):
            kv_pair = []
            for p, (_, c, w) in zip(pp, pair):
                x, kv, aux = _block_full(p, x, c, aux, window=w, **run)
                kv_pair.append(kv)
            return x, aux, kv_pair

        units = list(zip(*(_unstack(stack) for stack, _, _ in pair)))
    else:
        window = _local_window(cfg)

        def body(x, aux, p):
            x, kv, aux = _block_full(p, x, cfg, aux, window=window, **run)
            return x, aux, kv

        units = _unstack(params["blk"])
    body = _maybe_ckpt(body, cfg, train)
    aux, kvs = _zero_aux(x.device), []
    for unit in units:
        x, aux, kv = body(x, aux, unit)
        kvs.append(kv)
    if cfg.attn_pattern == "local_global" or _moe_pairs(cfg):
        kvs = tuple(list(side) for side in zip(*kvs))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x, aux, (kvs if collect_kv else None)


def _forward_rwkv(params, cfg, tokens, *, train, collect_state, use_kernel):
    """ssm family (RWKV6). Returns (hidden, aux (zeros), [(S, ax_last,
    fx_last) a layer] or None)."""
    b, s = tokens.shape
    x = rms_norm(_embed_in(params, cfg, tokens), params["ln0"], cfg.norm_eps)
    zero_prev = torch.zeros(b, 1, cfg.d_model, dtype=x.dtype, device=x.device)

    def body(x, p):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, (ax_last, S) = ssm.rwkv6_time_mix(p["att"], h, zero_prev, None, cfg,
                                             use_kernel=use_kernel)
        x = x + y
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        y, fx_last = ssm.rwkv6_channel_mix(p["ffn"], h, zero_prev)
        return x + y, (S, ax_last, fx_last)

    body = _maybe_ckpt(body, cfg, train)
    states = []
    for p in _unstack(params["blk"]):
        x, st = body(x, p)
        states.append(st)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x, _zero_aux(x.device), (states if collect_state else None)


def _forward_hybrid(params, cfg, tokens, *, train, collect_state, use_kernel,
                    capacity_factor):
    """zamba2: groups of mamba2 layers with a weight-shared attention block.
    Returns (hidden, aux, per-group [((k, v), [(S, conv) per layer])] or
    None)."""
    b, s = tokens.shape
    x = _embed_in(params, cfg, tokens)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    shared = params["shared"]

    def group(x, aux, pp):
        # Weight-shared attention block (sliding window for long context).
        x, kv, aux = _block_full(shared, x, cfg, aux, positions=positions,
                                 window=cfg.sliding_window, capacity_factor=capacity_factor,
                                 train=train)
        sts = []
        for p in _unstack(pp):
            h = rms_norm(x, p["ln"], cfg.norm_eps)
            y, st = ssm.mamba2_mix(p, h, None, None, cfg, use_kernel=use_kernel)
            x = x + y
            sts.append(st)
        return x, aux, (kv, sts)

    group = _maybe_ckpt(group, cfg, train)
    aux, states = _zero_aux(x.device), []
    for pp in _unstack(params["blk"]):
        x, aux, st = group(x, aux, pp)
        states.append(st)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x, aux, (states if collect_state else None)


def _forward_vlm(params, cfg, tokens, patches, *, train, collect_kv, capacity_factor):
    """vlm: each group's self-attention blocks, then its gated cross block
    over the patches. Returns (hidden, aux, per-group ([(k, v) a self
    layer], (xk, xv)) or None)."""
    b, s = tokens.shape
    x = _embed_in(params, cfg, tokens)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    patches = patches.to(x.dtype)
    run = dict(positions=positions, capacity_factor=capacity_factor, train=train)

    def group(x, aux, pp, px):
        kv_self = []
        for p in _unstack(pp):
            x, kv, aux = _block_full(p, x, cfg, aux, **run)
            kv_self.append(kv)
        x, kv_cross, aux = _block_full(px, x, cfg, aux, cross_src=patches, **run)
        return x, aux, (kv_self, kv_cross)

    group = _maybe_ckpt(group, cfg, train)
    aux, kvs = _zero_aux(x.device), []
    for pp, px in zip(_unstack(params["blk"]), _unstack(params["xblk"])):
        x, aux, kv = group(x, aux, pp, px)
        kvs.append(kv)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x, aux, (kvs if collect_kv else None)


def _encode_audio(params, cfg, frames, dtype, train):
    """Whisper's encoder over the stub's frame embeddings (B, T, D):
    sinusoids added, non-causal blocks, its final norm."""
    t = frames.shape[1]
    x = frames.to(dtype) + _sinusoid(t, cfg.d_model, dtype, frames.device)[None]
    positions = torch.arange(t, device=x.device)[None].expand(frames.shape[0], t)

    def body(x, p):
        return _block_full(p, x, cfg, None, positions=positions, causal=False)[0]

    body = _maybe_ckpt(body, cfg, train)
    for p in _unstack(params["enc"]):
        x = body(x, p)
    return rms_norm(x, params["enc_ln_f"], cfg.norm_eps)


def _forward_audio(params, cfg, tokens, frames, *, train, collect_kv):
    """audio: the encoder, then each decoder layer's causal block and its
    pre-normed cross-attention to the encoder output. Returns (hidden, aux
    (zeros), [((k, v), (xk, xv)) a layer] or None)."""
    b, s = tokens.shape
    x = _embed_in(params, cfg, tokens)
    enc = _encode_audio(params, cfg, frames, x.dtype, train)
    x = x + _sinusoid(s, cfg.d_model, x.dtype, x.device)[None]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)

    def body(x, p):
        x, kv_self, _ = _block_full(p, x, cfg, None, positions=positions)
        h = rms_norm(x, p["ln_cross"], cfg.norm_eps)
        co, kv_cross = _attn_full(p["xattn"], h, cfg, positions=positions, cross_src=enc)
        return x + co, (kv_self, kv_cross)

    body = _maybe_ckpt(body, cfg, train)
    kvs = []
    for p in _unstack(params["dec"]):
        x, kv = body(x, p)
        kvs.append(kv)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x, _zero_aux(x.device), (kvs if collect_kv else None)


def forward_hidden(params, cfg: ArchConfig, batch, *, train=False, use_kernel=True,
                   collect=False, capacity_factor=None):
    """Dispatch to the family forward. Returns (hidden, aux, caches-raw):
    aux the MoE layers' `load_balance` and `router_z` summed over layers
    (float32 0-d; zeros without MoE), as the reference's.

    `train`: a MoE layer takes the training capacity (`capacity_factor`
    None: the config's, 1.25), and with `cfg.remat` each layer (a pair, a
    group) runs under `torch.utils.checkpoint`. Otherwise a MoE layer runs
    at the serving capacity (`capacity_factor` None: `PREFILL_CAPACITY`; a
    one-token input never drops). `use_kernel`: the RWKV6 and Mamba2 scans
    through the chunk_scan kernel's wrappers (True, the port's serving
    default; the kernels have no backward) or its plain versions (False,
    the reference's default and the training path)."""
    _require_family(cfg)
    if capacity_factor is None and not train:
        capacity_factor = PREFILL_CAPACITY
    tokens = batch["tokens"]
    if cfg.arch_type in ("dense", "moe"):
        return _forward_dense(params, cfg, tokens, train=train, collect_kv=collect,
                              capacity_factor=capacity_factor)
    if cfg.arch_type == "ssm":
        return _forward_rwkv(params, cfg, tokens, train=train, collect_state=collect,
                             use_kernel=use_kernel)
    if cfg.arch_type == "vlm":
        return _forward_vlm(params, cfg, tokens, batch["patches"], train=train,
                            collect_kv=collect, capacity_factor=capacity_factor)
    if cfg.arch_type == "audio":
        return _forward_audio(params, cfg, tokens, batch["frames"], train=train,
                              collect_kv=collect)
    return _forward_hybrid(params, cfg, tokens, train=train, collect_state=collect,
                           use_kernel=use_kernel, capacity_factor=capacity_factor)


def unembed_table(params, cfg: ArchConfig):
    return params["embed"] if cfg.tie_embeddings else params["head"]


# ===========================================================================
# Loss
# ===========================================================================


def loss_chunk(s: int) -> int:
    """The loss's sequence chunk: `s` up to 512 tokens, else 512 halved
    until it divides `s` (the reference's rule)."""
    chunk = s if s <= 512 else 512
    while s % chunk:
        chunk //= 2
    return chunk


def forward_loss(params, cfg: ArchConfig, batch, *, use_kernel=False):
    """Mean next-token NLL + MoE aux losses: (loss, aux) with aux["nll"],
    and the summed `load_balance` and `router_z`. batch: tokens, labels
    (B, S) (+ the frontend stub's patches or frames). The forward runs with
    `train=True`; `use_kernel` defaults to False as the reference's does,
    so the RWKV6 and Mamba2 scans take their differentiable plain versions."""
    h, aux, _ = forward_hidden(params, cfg, batch, train=True, use_kernel=use_kernel)
    labels = batch["labels"]
    b, s = labels.shape
    nll = unembed_chunked(h, unembed_table(params, cfg), labels, chunk=loss_chunk(s),
                          final_cap=cfg.final_softcap)
    loss = nll / (b * s)
    aux = dict(aux, nll=loss)
    if cfg.num_experts:
        loss = (loss + cfg.load_balance_loss * aux["load_balance"] / cfg.num_layers
                + cfg.router_zloss * aux["router_z"] / cfg.num_layers)
    return loss, aux


def real_batch(cfg: ArchConfig, kind: str, b: int, s: int, *,
               generator: torch.Generator) -> dict:
    """A random batch on the generator's device, drawn from `generator`:
    tokens (B, S) int32 (kind "train" adds labels, "decode" is tokens (B,)
    alone), and the frontend stub's output, normal x 0.02 in bf16 (`patches`
    for vlm, `frames` for audio). The reference's `jax.random` draws cannot
    be matched; parity tests take `data.lm`'s numpy batches instead."""
    kw = dict(generator=generator, device=generator.device)
    if kind == "decode":
        return {"tokens": torch.randint(0, cfg.vocab_size, (b,), dtype=torch.int32, **kw)}
    if kind not in ("train", "prefill"):
        raise ValueError(f"unknown batch kind {kind!r}")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32, **kw)}
    if kind == "train":
        batch["labels"] = torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32, **kw)
    stub = {"vlm": ("patches", cfg.num_frontend_tokens),
            "audio": ("frames", cfg.encoder_tokens)}.get(cfg.arch_type)
    if stub:
        batch[stub[0]] = torch.randn((b, stub[1], cfg.d_model), dtype=ACT_DTYPE, **kw) * 0.02
    return batch


def abstract_batch(cfg: ArchConfig, kind: str, b: int, s: int) -> dict:
    """A batch as `meta` tensors (the dry run's): the shapes and types of
    `real_batch`'s."""
    def meta(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kind == "decode":
        return {"tokens": meta((b,))}
    if kind not in ("train", "prefill"):
        raise ValueError(f"unknown batch kind {kind!r}")
    batch = {"tokens": meta((b, s))}
    if kind == "train":
        batch["labels"] = meta((b, s))
    if cfg.arch_type == "vlm":
        batch["patches"] = meta((b, cfg.num_frontend_tokens, cfg.d_model), ACT_DTYPE)
    if cfg.arch_type == "audio":
        batch["frames"] = meta((b, cfg.encoder_tokens, cfg.d_model), ACT_DTYPE)
    return batch


def batch_pspecs(cfg: ArchConfig, mesh, kind: str, b: int) -> dict:
    """Each batch entry's spec on `mesh`: the batch dim over the batch axes
    when it divides, the rest replicated."""
    from repro_torch.sharding.specs import batch_spec

    bspec = batch_spec(mesh, b)
    if kind == "decode":
        return {"tokens": (bspec,)}
    out = {"tokens": (bspec, None)}
    if kind == "train":
        out["labels"] = (bspec, None)
    if cfg.arch_type == "vlm":
        out["patches"] = (bspec, None, None)
    if cfg.arch_type == "audio":
        out["frames"] = (bspec, None, None)
    return out


# ===========================================================================
# Decode caches
# ===========================================================================


def _window(cfg: ArchConfig, cache_len: int) -> int:
    return min(cfg.sliding_window, cache_len) if cfg.sliding_window else cache_len


def _cache_desc(cfg: ArchConfig, b: int, cache_len: int, dtype=ACT_DTYPE) -> dict:
    """name -> (shape, dtype) for the decode state: `dtype` is the
    activations' (the weights') type; recurrent states are float32."""
    _require_family(cfg)
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    w = _window(cfg, cache_len)

    def kv(nl, s):
        return ((nl, b, s, hkv, hd), dtype)

    if cfg.arch_type in ("dense", "moe"):
        if cfg.attn_pattern == "local_global":
            half = cfg.num_layers // 2
            return {"k_local": kv(half, w), "v_local": kv(half, w),
                    "k_global": kv(half, cache_len), "v_global": kv(half, cache_len)}
        if _moe_pairs(cfg):
            half = cfg.num_layers // 2
            return {"k_dense": kv(half, cache_len), "v_dense": kv(half, cache_len),
                    "k_moe": kv(half, cache_len), "v_moe": kv(half, cache_len)}
        s = w if cfg.attn_pattern == "local" else cache_len
        return {"k": kv(cfg.num_layers, s), "v": kv(cfg.num_layers, s)}
    if cfg.arch_type == "ssm":
        h, dk = cfg.ssm_heads, cfg.ssm_head_dim
        nl, d = cfg.num_layers, cfg.d_model
        return {"S": ((nl, b, h, dk, dk), torch.float32),
                "ax": ((nl, b, 1, d), dtype), "fx": ((nl, b, 1, d), dtype)}
    if cfg.arch_type == "vlm":
        g, sp = n_cross(cfg), cfg.cross_attn_every - 1
        return {"k": ((g, sp, b, cache_len, hkv, hd), dtype),
                "v": ((g, sp, b, cache_len, hkv, hd), dtype),
                "xk": kv(g, cfg.num_frontend_tokens), "xv": kv(g, cfg.num_frontend_tokens)}
    if cfg.arch_type == "audio":
        nl = cfg.num_layers
        return {"k": kv(nl, cache_len), "v": kv(nl, cache_len),
                "xk": kv(nl, cfg.encoder_tokens), "xv": kv(nl, cfg.encoder_tokens)}
    g, per = _hybrid_groups(cfg)  # hybrid
    h, hd_s, ns = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    cdim = h * hd_s + 2 * ns
    return {
        "S": ((g, per, b, h, ns, hd_s), torch.float32),
        "conv": ((g, per, b, cfg.conv_width - 1, cdim), dtype),
        "ak": kv(g, w),
        "av": kv(g, w),
    }


def init_cache(cfg: ArchConfig, b: int, cache_len: int, *, device: DeviceLike = None):
    dev = resolve_device(device)
    return {k: torch.zeros(sh, dtype=dt, device=dev)
            for k, (sh, dt) in _cache_desc(cfg, b, cache_len).items()}


_KV_AXES = ("layers", "batch", "kv_seq", "kv_heads", None)


def _cache_axes(cfg: ArchConfig, name: str) -> tuple:
    """The logical axes of cache entry `name` (the reference's third field
    of `_cache_desc`): stacked layer dims, then batch, then a KV cache's
    sequence and heads; static cross keys and recurrent states shard the
    batch only."""
    at = cfg.arch_type
    if at == "ssm":
        return ("layers", "batch", None, None, None) if name == "S" else (
            "layers", "batch", None, None)
    if at == "hybrid" and name in ("S", "conv"):
        return ("layers", "layers", "batch") + (None,) * (3 if name == "S" else 2)
    if name in ("xk", "xv"):
        return ("layers", "batch", None, None, None)
    if at == "vlm":
        return ("layers",) + _KV_AXES
    return _KV_AXES


def abstract_cache(cfg: ArchConfig, b: int, cache_len: int) -> dict:
    """The decode state as `meta` tensors (the dry run's)."""
    return {k: torch.empty(sh, dtype=dt, device="meta")
            for k, (sh, dt) in _cache_desc(cfg, b, cache_len).items()}


def cache_pspecs(cfg: ArchConfig, mesh, b: int, cache_len: int, *,
                 kind: str = "decode") -> dict:
    """Each cache entry's spec on `mesh`: batch over the batch axes when it
    divides; then, over 'model', the KV heads at prefill or the sequence."""
    from repro_torch.sharding.specs import batch_spec

    bspec = batch_spec(mesh, b)
    msize = dict(zip(mesh.axis_names, mesh.devices.shape)).get("model", 0)
    out = {}
    for k, (sh, _) in _cache_desc(cfg, b, cache_len).items():
        axes = _cache_axes(cfg, k)
        dims = dict(zip(axes, sh))
        # Prefill caches shard KV heads over 'model': the layout of k/v as
        # tensor parallelism computes them, so the prefill's output needs no
        # full-cache all-gather. Decode keeps the cache sequence-sharded
        # (flash-decode partial softmax), the engine resharding once.
        kv_heads = dims.get("kv_heads", 0)
        head_ok = kind != "decode" and msize and kv_heads > 0 and kv_heads % msize == 0
        # Heads that do not divide the model axis shard the sequence
        # instead: at prefill per-layer all-to-alls replace the head
        # all-gather, at decode it is the flash-decode layout. Ring
        # (windowed) caches stay whole at prefill: resharding the ring-tail
        # slice costs more than it saves.
        seq_len = dims.get("kv_seq", 0)
        seq_ok = msize and seq_len % msize == 0 and (kind == "decode" or seq_len >= cache_len)
        spec = []
        for ax in axes:
            if ax == "batch":
                spec.append(bspec)
            elif (ax == "kv_heads" and head_ok) or (ax == "kv_seq" and not head_ok and seq_ok):
                spec.append("model")
            else:
                spec.append(None)
        out[k] = tuple(spec)
    return out


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
        return _pad_to(k_full, w)
    return torch.roll(k_full[..., s - w:, :, :], s % w, dims=-3)


def _pad_to(x, n):
    """(..., S, H, hd) zero-padded to n positions (a full cache)."""
    return F.pad(x, (0, 0, 0, 0, 0, n - x.shape[-3]))


def _stack_tails(kvs, n, ring):
    """k and v of each layer, ring tails (`ring`) or padded to n, stacked
    over layers: (k (L, B, n, Hkv, hd), v)."""
    fit = (lambda t: _ring_tail(t, n)) if ring else (lambda t: _pad_to(t, n))
    return tuple(torch.stack([fit(kv[j]) for kv in kvs]) for j in (0, 1))


def prefill(params, cfg: ArchConfig, batch, cache_len: int, *,
            capacity_factor=PREFILL_CAPACITY):
    """Full forward over the prompt; returns (cache, last-token logits).
    `capacity_factor` as `forward_hidden`'s."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if s > cache_len:
        raise ValueError(f"prompt of {s} tokens past the cache of {cache_len}")
    h, _, raw = forward_hidden(params, cfg, batch, collect=True,
                               capacity_factor=capacity_factor)
    logits = logits_last(h[:, -1], unembed_table(params, cfg), cfg.final_softcap)
    w = _window(cfg, cache_len)
    desc = _cache_desc(cfg, b, cache_len, params["embed"].dtype)
    if cfg.arch_type in ("dense", "moe"):
        if cfg.attn_pattern == "local_global":
            kl, vl = _stack_tails(raw[0], w, ring=True)
            kg, vg = _stack_tails(raw[1], cache_len, ring=False)
            cache = {"k_local": kl, "v_local": vl, "k_global": kg, "v_global": vg}
        elif _moe_pairs(cfg):
            kd, vd = _stack_tails(raw[0], cache_len, ring=False)
            km, vm = _stack_tails(raw[1], cache_len, ring=False)
            cache = {"k_dense": kd, "v_dense": vd, "k_moe": km, "v_moe": vm}
        elif cfg.attn_pattern == "local":
            cache = dict(zip(("k", "v"), _stack_tails(raw, w, ring=True)))
        else:
            cache = dict(zip(("k", "v"), _stack_tails(raw, cache_len, ring=False)))
    elif cfg.arch_type == "ssm":
        cache = {name: torch.stack([st[j] for st in raw])
                 for j, name in enumerate(("S", "ax", "fx"))}
    elif cfg.arch_type == "vlm":
        per_group = [_stack_tails(kv_self, cache_len, ring=False) for kv_self, _ in raw]
        cache = {"k": torch.stack([k for k, _ in per_group]),
                 "v": torch.stack([v for _, v in per_group]),
                 "xk": torch.stack([kx for _, (kx, _) in raw]),
                 "xv": torch.stack([vx for _, (_, vx) in raw])}
    elif cfg.arch_type == "audio":
        k, v = _stack_tails([kv_self for kv_self, _ in raw], cache_len, ring=False)
        cache = {"k": k, "v": v, "xk": torch.stack([kx for _, (kx, _) in raw]),
                 "xv": torch.stack([vx for _, (_, vx) in raw])}
    else:  # hybrid
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
    _require_family(cfg)
    x = embed(tokens[:, None], params["embed"], cfg.embed_scale).to(params["embed"].dtype)
    if cfg.arch_type in ("dense", "moe"):
        x = _decode_dense(params, cfg, cache, x, pos)
    elif cfg.arch_type == "ssm":
        x = _decode_rwkv(params, cfg, cache, x)
    elif cfg.arch_type == "vlm":
        x = _decode_vlm(params, cfg, cache, x, pos)
    elif cfg.arch_type == "audio":
        x = _decode_audio(params, cfg, cache, x, pos)
    else:  # hybrid
        x = _decode_hybrid(params, cfg, cache, x, pos)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_last(x[:, 0], unembed_table(params, cfg), cfg.final_softcap)
    return cache, logits


def _decode_dense(params, cfg, cache, x, pos: int):
    """Every layer's one-token attention against its cache (a ring on the
    windowed layers), then its MLP or MoE layer (no drop)."""
    window = _local_window(cfg)
    if cfg.attn_pattern == "local_global":
        for i in range(cfg.num_layers // 2):
            x, _, _ = _block_decode(_layer(params["local"], i), x, cfg, cache["k_local"][i],
                                    cache["v_local"][i], pos, window=window, ring=True)
            x, _, _ = _block_decode(_layer(params["global"], i), x, cfg,
                                    cache["k_global"][i], cache["v_global"][i], pos)
        return x
    if _moe_pairs(cfg):
        dense_cfg = _pair_dense_cfg(cfg)
        for i in range(cfg.num_layers // 2):
            x, _, _ = _block_decode(_layer(params["dense_blk"], i), x, dense_cfg,
                                    cache["k_dense"][i], cache["v_dense"][i], pos)
            x, _, _ = _block_decode(_layer(params["moe_blk"], i), x, cfg, cache["k_moe"][i],
                                    cache["v_moe"][i], pos)
        return x
    for i in range(cfg.num_layers):
        x, _, _ = _block_decode(_layer(params["blk"], i), x, cfg, cache["k"][i],
                                cache["v"][i], pos, window=window, ring=window > 0)
    return x


def _decode_rwkv(params, cfg, cache, x):
    """Every RWKV6 layer's one-token time mix (`recurrence_step`) and
    channel mix; the state and the shifted activations in place."""
    x = rms_norm(x, params["ln0"], cfg.norm_eps)
    for i in range(cfg.num_layers):
        p = _layer(params["blk"], i)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, (ax, S) = ssm.rwkv6_time_mix_step(p["att"], h, cache["ax"][i].to(h.dtype),
                                             cache["S"][i], cfg)
        cache["S"][i] = S
        cache["ax"][i] = ax
        x = x + y
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        y, fx = ssm.rwkv6_channel_mix(p["ffn"], h, cache["fx"][i].to(h.dtype))
        cache["fx"][i] = fx
        x = x + y
    return x


def _decode_hybrid(params, cfg, cache, x, pos: int):
    """Each group: the shared block's attention over its ring, then the
    group's Mamba2 layers one token each."""
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
            cache["conv"][gi, li] = c1
            x = x + y
    return x


def _decode_vlm(params, cfg, cache, x, pos: int):
    """Each group: its self-attention layers over their caches, then its
    gated cross block over the group's static image cache."""
    for gi in range(n_cross(cfg)):
        for li in range(cfg.cross_attn_every - 1):
            x, _, _ = _block_decode(_layer(params["blk"], gi, li), x, cfg, cache["k"][gi, li],
                                    cache["v"][gi, li], pos)
        x, _, _ = _block_decode(_layer(params["xblk"], gi), x, cfg, cache["xk"][gi],
                                cache["xv"][gi], pos, cross=True)
    return x


def _decode_audio(params, cfg, cache, x, pos: int):
    """The token's sinusoid at `pos`, then each decoder layer's block over
    its self cache and its cross-attention over the layer's static encoder
    cache."""
    x = x + _sinusoid(1, cfg.d_model, x.dtype, x.device, offset=pos)[None]
    for i in range(cfg.num_layers):
        p = _layer(params["dec"], i)
        x, _, _ = _block_decode(p, x, cfg, cache["k"][i], cache["v"][i], pos)
        h = rms_norm(x, p["ln_cross"], cfg.norm_eps)
        co, _, _ = _attn_decode(p["xattn"], h, cfg, cache["xk"][i], cache["xv"][i], pos,
                                cross=True)
        x = x + co
    return x
