"""The chunked-scan kernel's wrapper and its plain version.

`chunk_scan` is the entry point `models.ssm.mamba2_mix` calls (the
reference's `kernels/chunk_scan/ops.py` signature). On a CUDA tensor it
validates its arguments and launches the hand-written Hopper kernel
(`kernel.launch`, from `csrc/chunk_scan.cu`), adding one to
``chunk_scan.launches``; there is no fall back. On a CPU tensor it runs
`chunk_scan_plain`, the same chunked evaluation in eager PyTorch (the
reference's `models/ssm.py::chunk_scan`), which is also the yardstick the
kernel is held against on the card.

Both evaluate the diagonal-decay recurrence (w, k, q: (B, S, H, dk);
v: (B, S, H, dv); state (B, H, dk, dv))

    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    y_t = q_t · S_t                                   (mamba2, include_current)
    y_t = q_t · S_{t-1} + (q_t · (u ⊙ k_t)) v_t       (rwkv6)

chunk by chunk, with every decay as a ratio exp(L_a - L_b) <= 1 of the
cumulative log decay clamped to [-20, 0]. y comes back in v's type, the
final state in float32. A sequence that the chunk does not divide runs at
its largest divisor below the chunk, as the reference's wrappers do.
"""

from __future__ import annotations

from typing import Optional

import torch

LOG_W_MIN = -20.0  # decays below e^-20 are numerically zero already
MAX_CHUNK = 64  # the kernel's largest chunk


def chunk_len(s: int, chunk: int) -> int:
    """`chunk`, or the largest divisor of `s` below it (ragged lengths)."""
    if s % chunk:
        chunk = max(c for c in range(1, min(chunk, s) + 1) if s % c == 0)
    return chunk


def chunk_scan_plain(w, k, v, q, u, *, include_current: bool, chunk: int = 64,
                     s0: Optional[torch.Tensor] = None):
    """Eager-PyTorch chunked scan; returns (y in v's type, final state f32).
    `u` (H, dk) is read only in rwkv6 mode (None there means zeros)."""
    b, s, h, dk = k.shape
    dv = v.shape[-1]
    chunk = chunk_len(s, chunk)
    n = s // chunk
    dev = v.device

    lw = torch.clamp(torch.log(torch.clamp_min(w.float(), 1e-30)), LOG_W_MIN, 0.0)

    def chunked(x, d):  # (n, B, H, C, d)
        return x.float().reshape(b, n, chunk, h, d).permute(1, 0, 3, 2, 4)

    wc, kc, vc, qc = chunked(lw, dk), chunked(k, dk), chunked(v, dv), chunked(q, dk)
    tri_lower = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=dev), -1)
    eye = torch.eye(chunk, dtype=torch.float32, device=dev)
    if include_current:
        mask = (tri_lower | (eye > 0))[:, :, None]
    else:
        mask = tri_lower[:, :, None]
        uf = (torch.zeros(h, dk, device=dev) if u is None else u.float())[None, :, None, :]

    S = (torch.zeros(b, h, dk, dv, device=dev) if s0 is None else s0.float())
    ys = []
    for i in range(n):
        lwt, kt, vt, qt = wc[i], kc[i], vc[i], qc[i]  # (B, H, C, d)
        L = torch.cumsum(lwt, dim=-2)  # inclusive cumulative log decay
        Lprev = L - lwt
        Lq = L if include_current else Lprev  # mamba2 reads S_t, rwkv6 S_{t-1}
        qs = qt * torch.exp(Lq)
        ratio = Lq[..., :, None, :] - L[..., None, :, :]  # (B, H, C, C, dk)
        A = torch.sum(torch.where(mask, torch.exp(ratio), 0.0)
                      * qt[..., :, None, :] * kt[..., None, :, :], dim=-1)
        if not include_current:
            diag = torch.sum(qt * uf * kt, dim=-1)  # (B, H, C)
            A = A + diag[..., :, None] * eye
        ys.append(qs @ S + A @ vt)
        Lc = L[..., -1:, :]  # (B, H, 1, dk) total chunk decay
        k_dec = kt * torch.exp(Lc - L)
        S = torch.exp(Lc[..., 0, :])[..., None] * S + k_dec.transpose(-1, -2) @ vt
    y = torch.stack(ys, 0).permute(1, 0, 3, 2, 4).reshape(b, s, h, dv)
    return y.to(v.dtype), S


def _check(w, k, v, q, u, s0, chunk) -> None:
    """What the kernel takes (after `w` is brought to float32)."""
    named = dict(w=w, k=k, v=v, q=q, u=u, s0=s0)
    for name, t in named.items():
        if t is None:
            continue
        if t.device != v.device:
            raise ValueError(f"{name} is on {t.device}, v on {v.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k.dim() != 4 or v.dim() != 4:
        raise ValueError("k must be (B, S, H, dk) and v (B, S, H, dv)")
    if v.dtype not in (torch.float32, torch.bfloat16) or k.dtype != v.dtype \
            or q.dtype != v.dtype:
        raise ValueError("k, q and v must share one type, torch.float32 or torch.bfloat16")
    if w.dtype != torch.float32:
        raise ValueError("w must be torch.float32 or torch.bfloat16")
    b, s, h, dk = k.shape
    if w.shape != k.shape or q.shape != k.shape or v.shape[:3] != (b, s, h):
        raise ValueError(f"w, q must be {tuple(k.shape)} and v (B, S, H, dv)")
    dv = v.shape[-1]
    if u is not None and (u.dtype != torch.float32 or u.shape != (h, dk)):
        raise ValueError(f"u must be float32 of shape {(h, dk)}")
    if s0 is not None and (s0.dtype != torch.float32 or s0.shape != (b, h, dk, dv)):
        raise ValueError(f"s0 must be float32 of shape {(b, h, dk, dv)}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")


def chunk_scan(w, k, v, q, u, *, include_current: bool, chunk: int = 64,
               s0: Optional[torch.Tensor] = None):
    """(y, final_state); y matches v's type, the state is float32. CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    reads w in float32 (a bf16 `w` is widened here, exactly) and `u` in
    float32 (widened here too: it is (H, dk))."""
    if v.device.type == "cpu":
        return chunk_scan_plain(w, k, v, q, u, include_current=include_current,
                                chunk=chunk, s0=s0)
    if v.device.type != "cuda":
        raise ValueError(f"no chunk_scan kernel for device {v.device}")
    if w.dtype == torch.bfloat16:
        w = w.float()
    if include_current:
        u = None  # mamba2 has no bonus
    elif u is not None and u.dtype == torch.bfloat16:
        u = u.float()
    _check(w, k, v, q, u, s0, chunk)
    from repro_torch.kernels.chunk_scan import kernel

    b, s, h, dk = k.shape
    dv = v.shape[-1]
    chunk = chunk_len(s, chunk)
    need = kernel.smem_bytes(chunk, dk, dv)
    if need > kernel.MAX_SMEM_BYTES:
        raise ValueError(f"chunk {chunk} at dk={dk}, dv={dv} needs {need} bytes of "
                         f"shared memory, past the card's {kernel.MAX_SMEM_BYTES}")
    y = torch.empty_like(v)
    s_out = torch.empty((b, h, dk, dv), dtype=torch.float32, device=v.device)
    kernel.launch(w, k, v, q, u, s0, y, s_out, include_current=include_current,
                  chunk=chunk)
    chunk_scan.launches += 1
    return y, s_out


#: Kernel launches so far (CUDA tensors only; the plain version never counts).
chunk_scan.launches = 0
