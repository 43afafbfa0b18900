"""The chunked-scan kernel's wrapper and its plain version.

`chunk_scan` is the entry point `models.ssm.mamba2_mix` calls (the
reference's `kernels/chunk_scan/ops.py` signature). On a CUDA tensor it
validates its arguments and launches the hand-written Hopper kernels
(`kernel.launch`, from `csrc/chunk_scan.cu`: prep, then scan), adding one to
``chunk_scan.launches``; there is no fall back. The kernels have no
backward, so under grad mode an input that requires grad makes both
entries raise on a CUDA tensor (never a detached result). On a CPU tensor it runs
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

`chunk_scan_mamba2` is the Mamba2 entry (`models.ssm.mamba2_mix`): one
decay scalar a head, w (B, S, H), and k, q (B, S, dk) shared by every
head, so nothing is broadcast to (B, S, H, dk); on a CUDA tensor it
launches its own kernel (`csrc/chunk_scan_mamba2.cu`), on the CPU its
plain version expands the inputs and runs `chunk_scan_plain`. Both
entries count their launches in ``chunk_scan.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import PLAIN_DEVICES

LOG_W_MIN = -20.0  # decays below e^-20 are numerically zero already
MAX_CHUNK = 64  # the kernel's largest chunk
MAX_DK = 256  # the Mamba2 entry's widest k
SMS = 132  # streaming multiprocessors of an H100 SXM: the Mamba2 split aims at two blocks each


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


def _refuse_grad(*tensors) -> None:
    """The kernels have no backward: their outputs are written into fresh
    buffers and carry no autograd graph. Under grad mode, with an input that
    requires grad, raise rather than return a result whose gradient would
    be silently left out. A caller that trains takes the plain versions
    (`models.ssm`'s `use_kernel=False`, the reference's training default)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError("the chunk_scan kernels have no backward: an input requires grad "
                           "under grad mode; use the plain version (use_kernel=False) to "
                           "differentiate the scan")


def _check_common(w, k, q, v, **optional) -> None:
    """Device, layout and types that both entries' kernels take (after `w`
    is brought to float32)."""
    for name, t in dict(w=w, k=k, q=q, v=v, **optional).items():
        if t is None:
            continue
        if t.device != v.device:
            raise ValueError(f"{name} is on {t.device}, v on {v.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if v.dtype not in (torch.float32, torch.bfloat16) or k.dtype != v.dtype \
            or q.dtype != v.dtype:
        raise ValueError("k, q and v must share one type, torch.float32 or torch.bfloat16")
    if w.dtype != torch.float32:
        raise ValueError("w must be torch.float32 or torch.bfloat16")


def _check(w, k, v, q, u, s0, chunk) -> None:
    """What the general entry's kernel takes."""
    _check_common(w, k, q, v, u=u, s0=s0)
    if k.dim() != 4 or v.dim() != 4:
        raise ValueError("k must be (B, S, H, dk) and v (B, S, H, dv)")
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
    tensors take the plain version; CUDA tensors launch the kernel (two
    launches: a prep kernel a chunk, then the scan over 16 state columns a
    block), which reads w in float32 (a bf16 `w` is widened here, exactly)
    and `u` in float32 (widened here too: it is (H, dk)). `meta` tensors take
    the plain version too (the dry run's shape propagation)."""
    if v.device.type in PLAIN_DEVICES:
        return chunk_scan_plain(w, k, v, q, u, include_current=include_current,
                                chunk=chunk, s0=s0)
    if v.device.type != "cuda":
        raise ValueError(f"no chunk_scan kernel for device {v.device}")
    _refuse_grad(w, k, v, q, u, s0)
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
    need = kernel.smem_bytes(chunk, dk, v.element_size())
    if need > kernel.MAX_SMEM_BYTES:
        raise ValueError(f"chunk {chunk} at dk={dk}, dv={dv} needs {need} bytes of "
                         f"shared memory, past the card's {kernel.MAX_SMEM_BYTES}")
    y = torch.empty_like(v)
    s_out = torch.empty((b, h, dk, dv), dtype=torch.float32, device=v.device)
    kernel.launch(w, k, v, q, u, s0, y, s_out, include_current=include_current,
                  chunk=chunk)
    _counted.launches += 1
    return y, s_out


#: Kernel launches so far (CUDA tensors only; the plain version never counts).
chunk_scan.launches = 0
# Both entries count on `chunk_scan` through this name, so a caller that
# rebinds the module's `chunk_scan` (to file its calls, say) moves no count.
_counted = chunk_scan


def chunk_scan_mamba2_plain(w, k, q, v, *, chunk: int = 32, s0: Optional[torch.Tensor] = None):
    """The Mamba2 entry's plain version: w (B, S, H), k and q (B, S, dk) are
    broadcast over heads and dk as the reference's `mamba2_mix` does, and
    `chunk_scan_plain(include_current=True)` runs on them."""
    b, s, h, _ = v.shape
    dk = k.shape[-1]
    return chunk_scan_plain(w[..., None].expand(b, s, h, dk),
                            k[:, :, None, :].expand(b, s, h, dk), v,
                            q[:, :, None, :].expand(b, s, h, dk), None, include_current=True,
                            chunk=chunk, s0=s0)


def dv_block(b: int, h: int, dv: int) -> int:
    """State columns a Mamba2-entry block owns: 32 if they divide dv and
    still give B * H * dv / 32 >= 2 * SMS blocks, else 16."""
    return 32 if dv % 32 == 0 and b * h * (dv // 32) >= 2 * SMS else 16


def _check_mamba2(w, k, q, v, s0, chunk) -> None:
    """What the Mamba2 entry's kernel takes. It copies k, v and its scratch
    into shared memory in 16-byte units only, so it takes dk % 4 == 0,
    dv % 16 == 0 and a 16-byte aligned v (Zamba2's ns = hd = 64)."""
    _check_common(w, k, q, v, s0=s0)
    if v.dim() != 4 or k.dim() != 3:
        raise ValueError("v must be (B, S, H, dv) and k, q (B, S, dk)")
    b, s, h, dv = v.shape
    dk = k.shape[-1]
    if w.shape != (b, s, h) or k.shape[:2] != (b, s) or q.shape != k.shape:
        raise ValueError(f"w must be {(b, s, h)} and k, q (B, S, dk) = ({b}, {s}, dk)")
    if not 1 <= dk <= MAX_DK or dk % 4:
        raise ValueError(f"the Mamba2 entry takes dk <= {MAX_DK} and a multiple of 4, "
                         f"got {dk}")
    if dv % 16:
        raise ValueError(f"the Mamba2 entry takes dv a multiple of 16, got {dv}")
    if v.data_ptr() % 16:
        raise ValueError("v must start on a 16-byte boundary")
    if s0 is not None and (s0.dtype != torch.float32 or s0.shape != (b, h, dk, dv)):
        raise ValueError(f"s0 must be float32 of shape {(b, h, dk, dv)}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")


def chunk_scan_mamba2(w, k, q, v, *, chunk: int = 32, s0: Optional[torch.Tensor] = None):
    """Mamba2's scan with per-head scalar decays: w (B, S, H), k and q
    (B, S, dk) shared by every head, v (B, S, H, dv), s0 (B, H, dk, dv).
    Returns (y in v's type, final state float32), exactly
    `chunk_scan(..., include_current=True)` on the broadcast inputs. CPU
    tensors take the plain version; CUDA tensors launch the kernel (two
    launches: a prep kernel, then the scan), which reads w in float32 (a
    bf16 `w` is widened here, exactly). `meta` tensors take the plain
    version too."""
    if v.device.type in PLAIN_DEVICES:
        return chunk_scan_mamba2_plain(w, k, q, v, chunk=chunk, s0=s0)
    if v.device.type != "cuda":
        raise ValueError(f"no chunk_scan kernel for device {v.device}")
    _refuse_grad(w, k, q, v, s0)
    if w.dtype == torch.bfloat16:
        w = w.float()
    _check_mamba2(w, k, q, v, s0, chunk)
    from repro_torch.kernels.chunk_scan import kernel

    b, s, h, dv = v.shape
    dk = k.shape[-1]
    chunk = chunk_len(s, chunk)
    blk = dv_block(b, h, dv)
    need = kernel.mamba2_smem_bytes(chunk, dk, blk, v.element_size())
    if need > kernel.MAX_SMEM_BYTES:
        raise ValueError(f"chunk {chunk} at dk={dk} needs {need} bytes of shared memory, "
                         f"past the card's {kernel.MAX_SMEM_BYTES}")
    y = torch.empty_like(v)
    s_out = torch.empty((b, h, dk, dv), dtype=torch.float32, device=v.device)
    kernel.launch_mamba2(w, k, q, v, s0, y, s_out, chunk=chunk, dv_block=blk)
    _counted.launches += 1
    return y, s_out
