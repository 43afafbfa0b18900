"""The hybrid (Zamba2-style) language model's forward in plain PyTorch.

The equations the port's hybrid family runs (`models/model.py`,
`models/ssm.py`, `models/layers.py`), written out again from the
configuration file's widths and applied to the benchmark's weights, with
no kernel, cache or batching of the program. Tokens x (B, T):

    x = E[tokens]
    each of the L / per groups:
      shared block (one set of weights for every group):
        h = norm(x, ln_attn); q, k, v = h Wq, h Wk, h Wv; rope on q and k
        x = x + softmax(q k^T / sqrt(hd), causal, window) v Wo   (GQA)
        h = norm(x, ln_mlp); x = x + (silu(h Wgate) * (h Wup)) Wdown
      `per` Mamba2 layers:
        h = norm(x, ln); [z, xc, B, C, dt] = h Win
        [xc, B, C] = silu(causal depthwise conv([xc, B, C], conv_w))
        dt = softplus(dt + dt_bias); a = exp(-exp(a_log) dt)      (a head)
        S_t = a_t S_{t-1} + B_t (dt_t xc_t)^T;  y_t = C_t^T S_t   (a head)
        x = x + norm((y + d_skip xc) * silu(z), ln_y) Wout
    logits = norm(x, ln_f) E^T

norm(x, s) = x / rms(x) * (1 + s), eps from the file; rope rotates halves
at theta^(-i / half). Every operation is in float32 with TF32 off; the
scan's recurrence is evaluated chunk by chunk (`scan`), or token by token
with the state held in `state_dtype` (`scan_stepwise`). `mixer` is one
Mamba2 layer's mixer from its normed input, with its last state: the
check also runs it alone, on the program's input to that layer. A
control lowers one precision: the Mamba2 states (`state_dtype`), or the
inputs of every weight's product (`matmul_dtype`, a float8 type: each
operand scaled by its largest magnitude to the type's largest finite
value and rounded, as an fp8 GEMM takes them). It imports nothing of the
program.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

#: Tokens a chunk of the float32 scan; queries a block of the attention.
CHUNK = 64
QUERY_BLOCK = 512


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _f(t):
    return t.to(torch.float32)


def _round(x, dtype):
    """x rounded to `dtype` under one scale, its largest magnitude to the
    type's largest finite value; float32 back."""
    scale = x.abs().amax().clamp_min(1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(torch.float32) * scale


def _mm(x, w, low=None):
    """x @ w in float32; with `low`, both operands rounded to it first."""
    x, w = _f(x), _f(w)
    if low is not None:
        x, w = _round(x, low), _round(w, low)
    return x @ w


def norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + _f(scale))


def rope(x, theta: float):
    """x (B, T, H, hd), positions 0..T-1."""
    t, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: int):
    """Causal softmax attention within `window` positions (0: no window).
    q (B, T, Hq, hd), k and v (B, T, Hkv, hd); query head h reads kv head
    h // (Hq / Hkv). A row and a block of queries at a time."""
    b, t, hq, hd = q.shape
    g = hq // k.shape[2]
    out = torch.empty_like(q)
    pos = torch.arange(t, device=q.device)
    for r in range(b):
        kr = k[r].repeat_interleave(g, dim=1).transpose(0, 1)  # (Hq, T, hd)
        vr = v[r].repeat_interleave(g, dim=1).transpose(0, 1)
        for lo in range(0, t, QUERY_BLOCK):
            hi = min(t, lo + QUERY_BLOCK)
            s = q[r, lo:hi].transpose(0, 1) @ kr.transpose(1, 2) / math.sqrt(hd)
            qp = pos[lo:hi, None]
            ok = pos[None, :] <= qp
            if window > 0:
                ok &= pos[None, :] > qp - window
            s = s.masked_fill(~ok, float("-inf"))
            out[r, lo:hi] = (torch.softmax(s, dim=-1) @ vr).transpose(0, 1)
    return out


def shared_block(p, x, cfg: dict, low=None):
    b, t, _ = x.shape
    hq, hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    a = p["attn"]
    h = norm(x, p["ln_attn"], cfg["norm_eps"])
    q = rope(_mm(h, a["wq"], low).reshape(b, t, hq, hd), cfg["rope_theta"])
    k = rope(_mm(h, a["wk"], low).reshape(b, t, hkv, hd), cfg["rope_theta"])
    v = _mm(h, a["wv"], low).reshape(b, t, hkv, hd)
    o = attention(q, k, v, cfg["sliding_window"]).reshape(b, t, hq * hd)
    x = x + _mm(o, a["wo"], low)
    m = p["mlp"]
    h = norm(x, p["ln_mlp"], cfg["norm_eps"])
    return x + _mm(F.silu(_mm(h, m["gate"], low)) * _mm(h, m["up"], low), m["down"], low)


def _segsum(la):
    """(..., C) log decays -> (..., C, C): entry (t, i) the sum over
    i < j <= t, -inf above the diagonal."""
    c = la.shape[-1]
    cum = torch.cumsum(la, -1)
    seg = cum[..., :, None] - cum[..., None, :]
    keep = torch.ones(c, c, dtype=torch.bool, device=la.device).tril()
    return seg.masked_fill(~keep, float("-inf"))


def scan(a, k, q, v, chunk: int = CHUNK):
    """S_t = a_t S_{t-1} + k_t v_t^T, y_t = q_t^T S_t from S_0 = 0, in
    float32, by chunks: within a chunk y_t = sum_i (q_t . k_i) prod_{i<j<=t}
    a_j v_i plus q_t^T (prod_{j<=t} a_j) S_in; a (B, T, H), k and q (B, T,
    N) shared by every head, v (B, T, H, P). Returns y (B, T, H, P) and
    the last state S_T (B, H, N, P)."""
    b, t, h, p = v.shape
    n = k.shape[-1]
    pad = (-t) % chunk
    if pad:  # decay 1 and zero inputs past the end change nothing before it
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        k, q = F.pad(k, (0, 0, 0, pad)), F.pad(q, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nc = (t + pad) // chunk
    la = torch.log(a.clamp_min(1e-30)).reshape(b, nc, chunk, h).permute(0, 3, 1, 2)
    kc, qc = k.reshape(b, nc, chunk, n), q.reshape(b, nc, chunk, n)
    vc = v.reshape(b, nc, chunk, h, p)
    cum = torch.cumsum(la, -1)  # (B, H, nc, C)
    qk = qc @ kc.transpose(-1, -2)  # (B, nc, C, C)
    weights = torch.exp(_segsum(la)) * qk[:, None]  # (B, H, nc, C, C)
    y = torch.einsum("bhcti,bcihp->bcthp", weights, vc)
    into = torch.exp(cum[..., -1:] - cum).permute(0, 2, 3, 1)  # (B, nc, C, H): to the end
    states = torch.einsum("bcin,bcihp->bchnp", kc, vc * into[..., None])
    s = torch.zeros(b, h, n, p, dtype=torch.float32, device=v.device)
    enter = torch.empty(b, nc, h, n, p, dtype=torch.float32, device=v.device)
    total = torch.exp(cum[..., -1])  # (B, H, nc)
    for c in range(nc):
        enter[:, c] = s
        s = total[:, :, c, None, None] * s + states[:, c]
    y = y + (torch.einsum("bctn,bchnp->bcthp", qc, enter)
             * torch.exp(cum).permute(0, 2, 3, 1)[..., None])
    return y.reshape(b, nc * chunk, h, p)[:, :t], s  # padded steps leave s as at t


def scan_stepwise(a, k, q, v, state_dtype=torch.float32, s0=None):
    """The same recurrence token by token, the state rounded to
    `state_dtype` after every update (the control's bfloat16 state).
    Returns (y (B, T, H, P) float32, the last state float32)."""
    b, t, h, p = v.shape
    n = k.shape[-1]
    s = (torch.zeros(b, h, n, p, device=v.device) if s0 is None else _f(s0)).to(state_dtype)
    ys = []
    for i in range(t):
        upd = a[:, i, :, None, None] * _f(s) + k[:, i, None, :, None] * v[:, i, :, None, :]
        s = upd.to(state_dtype)
        ys.append(torch.einsum("bn,bhnp->bhp", q[:, i], _f(s)))
    return torch.stack(ys, 1), _f(s)


def mixer(p, h_in, cfg: dict, state_dtype=torch.float32, matmul_dtype=None):
    """One Mamba2 layer's mixer from its normed input h_in (B, T, D):
    (its output (B, T, D), the last state (B, H, N, P)), float32."""
    b, t, _ = h_in.shape
    h, hd, ns = cfg["ssm_heads"], cfg["ssm_head_dim"], cfg["ssm_state"]
    inner = h * hd
    low = matmul_dtype
    u = _mm(h_in, p["in_proj"], low)
    z, xc, bc, cc, dt = torch.split(u, [inner, inner, ns, ns, h], dim=-1)
    conv_in = torch.cat([xc, bc, cc], dim=-1)
    w = _f(p["conv_w"])  # (W, channels)
    width = w.shape[0]
    padded = F.pad(conv_in, (0, 0, width - 1, 0))
    conv = F.silu(sum(padded[:, i:i + t] * w[i] for i in range(width)))
    xc, bc, cc = torch.split(conv, [inner, ns, ns], dim=-1)
    dt = F.softplus(dt + _f(p["dt_bias"]))
    a = torch.exp(-torch.exp(_f(p["a_log"])) * dt)
    v = xc.reshape(b, t, h, hd) * dt[..., None]
    if state_dtype == torch.float32:
        y, last = scan(a, bc, cc, v)
    else:
        y, last = scan_stepwise(a, bc, cc, v, state_dtype)
    y = y.reshape(b, t, inner) + xc * _f(p["d_skip"]).repeat_interleave(hd)
    y = norm(y * F.silu(z), p["ln_y"], cfg["norm_eps"])
    return _mm(y, p["out_proj"], low), last


def mamba2(p, x, cfg: dict, state_dtype=torch.float32, low=None):
    return mixer(p, norm(x, p["ln"], cfg["norm_eps"]), cfg, state_dtype, low)[0]


def layer(tree, *idx):
    """The weights of one layer of a stacked tree."""
    if isinstance(tree, dict):
        return {k: layer(v, *idx) for k, v in tree.items()}
    return tree[idx]


def logits(params, cfg: dict, tokens, last: int, *, state_dtype=torch.float32,
           matmul_dtype=None):
    """Float32 logits (B, last, V) of the last `last` positions of tokens
    (B, T), each from the tokens up to it (teacher-forced, one causal
    forward); `state_dtype` holds the Mamba2 states (float32 as the
    configuration states), `matmul_dtype` (None: float32) rounds the
    weights' products' inputs."""
    if cfg["mlp_variant"] != "swiglu" or not cfg["tie_embeddings"]:
        raise ValueError("the reference takes a SwiGLU block and tied embeddings")
    per = cfg["hybrid_attn_every"]
    table = params["embed"]
    with exact_float32(), torch.no_grad():
        x = _f(table[tokens.long()])
        for g in range(cfg["num_layers"] // per):
            x = shared_block(params["shared"], x, cfg, matmul_dtype)
            for li in range(per):
                x = x + mamba2(layer(params["blk"], g, li), x, cfg, state_dtype, matmul_dtype)
        h = norm(x[:, -last:], params["ln_f"], cfg["norm_eps"])
        return _mm(h, table.T, matmul_dtype)
