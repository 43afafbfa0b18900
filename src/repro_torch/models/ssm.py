"""Linear-recurrence layers: the chunked scan and Mamba2 (SSD).

The reference's `repro.models.ssm` in PyTorch. Both RWKV6 and Mamba2 are
instances of the diagonal-decay recurrence

    S_t = diag(w_t) · S_{t-1} + k_t v_tᵀ            (S: (dk, dv) per head)
    y_t = q_t · (diag(d_t) · S_{t-1}) + (q_t · (u_t ⊙ k_t)) v_t

  Mamba2 (SSD): d_t = w_t = exp(-Δt·exp(A_log)) (scalar per head,
    broadcast over dk), u_t = 1, k = B, q = C, v = Δt·x.

`mamba2_mix` (prefill) runs the chunked scan through the kernel's Mamba2
entry (`kernels/chunk_scan/ops.chunk_scan_mamba2`: the Hopper kernel on
CUDA tensors, its plain version on the CPU); `mamba2_mix_step` (decode) takes the one
token through `recurrence_step`, the reference's chunk-1 plain scan in a
single update (not a kernel there either). The RWKV6 time and channel
mixes wait for the rwkv6 family (ROADMAP.md queue 1, item 13).
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


def mamba2_mix(p, x, state, conv_state, cfg, *, chunk=32):
    """Mamba2 block core. x: (B,S,D). Returns (y, (S, conv_state)).

    The scan goes through the kernel's Mamba2 entry, which takes the decay
    as (B, S, H) and k, q as (B, S, ns): nothing is broadcast over heads."""
    z, xz, (a, k, q, v), conv_state = _mamba2_in(p, x, conv_state, cfg)
    y, S = cs_ops.chunk_scan_mamba2(a, k.contiguous(), q.contiguous(), v, chunk=chunk,
                                    s0=state)
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
