"""Linear-recurrence layers: the chunked scan, RWKV6 and Mamba2 (SSD).

The reference's `repro.models.ssm` in PyTorch. Both RWKV6 and Mamba2 are
instances of the diagonal-decay recurrence

    S_t = diag(w_t) · S_{t-1} + k_t v_tᵀ            (S: (dk, dv) per head)
    y_t = q_t · (diag(d_t) · S_{t-1}) + (q_t · (u_t ⊙ k_t)) v_t

  RWKV6 ("Finch"): d_t = 1, u_t = u (learned bonus), w_t = per-channel
    data-dependent decay (arXiv:2404.05892).
  Mamba2 (SSD): d_t = w_t = exp(-Δt·exp(A_log)) (scalar per head,
    broadcast over dk), u_t = 1, k = B, q = C, v = Δt·x.

With `use_kernel=True` (the port's default, which its serving path runs)
prefill takes the chunked scan through the kernel's wrappers (the Hopper
kernels on CUDA tensors, their plain versions on the CPU):
`rwkv6_time_mix` through the general entry
(`kernels/chunk_scan/ops.chunk_scan`, rwkv6 mode, chunk 32), `mamba2_mix`
through the Mamba2 entry (`ops.chunk_scan_mamba2`). The reference defaults
to `use_kernel=False` and trains so: then both take the plain versions
(`chunk_scan_plain`, `chunk_scan_mamba2_plain`) on any device, which
autograd differentiates; the kernels have no backward and raise under grad
mode. The decode steps
(`rwkv6_time_mix_step`, `mamba2_mix_step`) take the one token through
`recurrence_step`, the reference's chunk-1 plain scan in a single update
(not a kernel there either).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.chunk_scan import ops as cs_ops
from repro_torch.models.layers import rms_norm


def chunk_scan_reference(w, k, v, q, u, *, include_current: bool, s0=None):
    """Sequential oracle. Shapes: w,k,q: (B,S,H,dk); v: (B,S,H,dv);
    u: (H, dk) bonus (ignored when include_current). Returns (y, S_final)."""
    b, s, h, dk = k.shape
    dv = v.shape[-1]
    wf, kf, vf, qf = (x.float() for x in (w, k, v, q))
    S = torch.zeros(b, h, dk, dv, device=v.device) if s0 is None else s0.float()
    ys = []
    for t in range(s):
        wt, kt, vt, qt = wf[:, t], kf[:, t], vf[:, t], qf[:, t]  # (B, H, d)
        if include_current:  # mamba2: read after update
            S = wt[..., None] * S + kt[..., None] * vt[..., None, :]
            y = torch.einsum("bhd,bhde->bhe", qt, S)
        else:  # rwkv6: read S_{t-1} plus u-bonus on the current token
            y = torch.einsum("bhd,bhde->bhe", qt, S) + torch.einsum(
                "bhd,hd,bhd,bhe->bhe", qt, u.float(), kt, vt)
            S = wt[..., None] * S + kt[..., None] * vt[..., None, :]
        ys.append(y)
    return torch.stack(ys, 1).to(v.dtype), S


def chunk_scan(w, k, v, q, u, *, include_current: bool, chunk: int = 32, s0=None):
    """Chunked evaluation of the same recurrence in eager PyTorch (the
    reference's system path): the kernel's plain version, on any device."""
    return cs_ops.chunk_scan_plain(w, k, v, q, u, include_current=include_current,
                                   chunk=chunk, s0=s0)


def recurrence_step(S, w, k, v, q, u, *, include_current: bool):
    """Single-token decode step. S: (B,H,dk,dv); w,k,q: (B,H,dk); v: (B,H,dv)."""
    Sf = S.float()
    wf, kf, vf, qf = (x.float() for x in (w, k, v, q))
    kv = kf[..., None] * vf[..., None, :]
    if include_current:
        S_new = wf[..., None] * Sf + kv
        y = torch.einsum("bhd,bhde->bhe", qf, S_new)
    else:
        y = torch.einsum("bhd,bhde->bhe", qf, Sf) + torch.einsum(
            "bhd,hd,bhd,bhe->bhe", qf, u.float(), kf, vf)
        S_new = wf[..., None] * Sf + kv
    return S_new, y.to(v.dtype)


# ---------------------------------------------------------------------------
# RWKV6 time mix / channel mix
# ---------------------------------------------------------------------------


def _token_shift(x, x_prev):
    """RWKV token shift: previous token's activation (x_prev: (B,1,D) state)."""
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def _rwkv6_in(p, x, xs, cfg):
    """The time mix's projections of x (B,S,D) against its shifted xs:
    r, k, v (B,S,H,dk), the gate g (B,S,D) and the decay w (B,S,H,dk)
    float32 in (0, 1), data-dependent through the low-rank w(x)."""
    b, s, _ = x.shape
    h, dk = cfg.ssm_heads, cfg.ssm_head_dim

    def mix(name):
        return x + p[f"mu_{name}"].to(x.dtype) * (xs - x)

    r = (mix("r") @ p["w_r"]).reshape(b, s, h, dk)
    k = (mix("k") @ p["w_k"]).reshape(b, s, h, dk)
    v = (mix("v") @ p["w_v"]).reshape(b, s, h, dk)
    g = mix("g") @ p["w_g"]
    w_log = p["w0"].float() + (torch.tanh(mix("w") @ p["w_lora_a"]) @ p["w_lora_b"]).float()
    w = torch.exp(-torch.exp(w_log)).reshape(b, s, h, dk)
    return r, k, v, g, w


def _rwkv6_out(p, y, g, cfg):
    """Per-head group norm of the scan's y (B,S,H,dk), gate, out projection."""
    b, s = y.shape[:2]
    h, dk = cfg.ssm_heads, cfg.ssm_head_dim
    y = rms_norm(y, p["ln_x"].reshape(h, dk), cfg.norm_eps)
    y = y.reshape(b, s, h * dk) * F.silu(g)
    return y @ p["w_o"]


def rwkv6_time_mix(p, x, x_prev, state, cfg, *, chunk=32, use_kernel=True):
    """RWKV6 attention replacement. x: (B,S,D). Returns (y, (x_last, S)).
    The scan goes through the kernel's general entry in rwkv6 mode
    (`use_kernel`), else through its plain version."""
    r, k, v, g, w = _rwkv6_in(p, x, _token_shift(x, x_prev), cfg)
    scan = cs_ops.chunk_scan if use_kernel else cs_ops.chunk_scan_plain
    y, S = scan(w, k, v, r, p["u"], include_current=False, chunk=chunk, s0=state)
    return _rwkv6_out(p, y, g, cfg), (x[:, -1:], S)


def rwkv6_time_mix_step(p, x, x_prev, state, cfg):
    """Single-token decode. x: (B,1,D); state (B,H,dk,dk) float32."""
    r, k, v, g, w = _rwkv6_in(p, x, x_prev, cfg)
    S, y = recurrence_step(state, w[:, 0], k[:, 0], v[:, 0], r[:, 0], p["u"],
                           include_current=False)
    return _rwkv6_out(p, y[:, None], g, cfg), (x, S)


def rwkv6_channel_mix(p, x, x_prev):
    """RWKV channel mix with token shift: relu(x_k W_up)² W_down.

    x_prev: (B,1,D) last token of the previous segment (zeros at start).
    Returns (out, new x_prev). Works for full sequences and decode (S=1).
    """
    xs = _token_shift(x, x_prev)
    xk = x + p["mu_ck"].to(x.dtype) * (xs - x)
    h = torch.square(F.relu(xk @ p["up"]))
    return h @ p["down"], x[:, -1:]


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def _causal_conv(x, conv_w, conv_state=None):
    """Depthwise causal conv1d, width W. x: (B,S,C); conv_w: (W,C).

    conv_state: (B, W-1, C) trailing context (decode); returns new state.
    """
    width = conv_w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros(x.shape[0], width - 1, x.shape[2], dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([conv_state, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i : i + s] * conv_w[i][None, None, :] for i in range(width))
    new_state = xp[:, -(width - 1):] if width > 1 else conv_state
    return F.silu(out), new_state


def _mamba2_in(p, x, conv_state, cfg):
    """Projections and causal conv of x (B,S,D): the gate z, the conv'd x,
    the scan's (a, k, q, v) — the decay a (B,S,H) float32 a head, k and q
    (B,S,ns) shared by every head, v (B,S,H,hd) — and the new conv state."""
    b, s, d = x.shape
    h, hd, ns = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    inner = h * hd

    proj = x @ p["in_proj"]  # (B,S, inner*2 + 2*ns + h)
    z, xz, Bc, Cc, dt = torch.split(proj, [inner, inner, ns, ns, h], dim=-1)
    conv_in = torch.cat([xz, Bc, Cc], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, p["conv_w"], conv_state)
    xz, Bc, Cc = torch.split(conv_out, [inner, ns, ns], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = torch.exp(-torch.exp(p["a_log"].float()) * dt)  # (B,S,H) decay

    v = xz.reshape(b, s, h, hd) * dt[..., None].to(xz.dtype)
    return z, xz, (a, Bc, Cc, v), conv_state


def _mamba2_out(p, y, xz, z, cfg):
    """Skip, gate, norm and out projection of the scan's y (B,S,H,hd)."""
    b, s = xz.shape[:2]
    d_skip = p["d_skip"].to(xz.dtype).repeat_interleave(cfg.ssm_head_dim)[None, None]
    y = y.reshape(b, s, -1) + xz * d_skip
    y = y * F.silu(z)
    y = rms_norm(y, p["ln_y"], cfg.norm_eps)
    return y @ p["out_proj"]


def mamba2_mix(p, x, state, conv_state, cfg, *, chunk=32, use_kernel=True):
    """Mamba2 block core. x: (B,S,D). Returns (y, (S, conv_state)).

    The scan goes through the kernel's Mamba2 entry (`use_kernel`), else its
    plain version; both take the decay as (B, S, H) and k, q as (B, S, ns)."""
    z, xz, (a, k, q, v), conv_state = _mamba2_in(p, x, conv_state, cfg)
    scan = cs_ops.chunk_scan_mamba2 if use_kernel else cs_ops.chunk_scan_mamba2_plain
    y, S = scan(a, k.contiguous(), q.contiguous(), v, chunk=chunk, s0=state)
    return _mamba2_out(p, y, xz, z, cfg), (S, conv_state)


def mamba2_mix_step(p, x, state, conv_state, cfg):
    """Single-token Mamba2 decode. x: (B,1,D); state: (B,H,dk,dv) float32.
    One `recurrence_step`: the reference's chunk-1 plain scan."""
    z, xz, (a, k, q, v), conv_state = _mamba2_in(p, x, conv_state, cfg)
    b, h, ns = v.shape[0], v.shape[2], k.shape[-1]
    S, y = recurrence_step(state, a[:, 0, :, None].expand(b, h, ns),
                           k[:, 0, None, :].expand(b, h, ns), v[:, 0],
                           q[:, 0, None, :].expand(b, h, ns), None, include_current=True)
    return _mamba2_out(p, y[:, None], xz, z, cfg), (S, conv_state)
