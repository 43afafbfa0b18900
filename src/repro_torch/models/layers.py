"""Shared neural layers: norms, rope, MLP variants, embeddings.

The reference's `repro.models.layers` in PyTorch, at the same dtypes:
norms and rope in float32 cast back to the input's type, logits accumulated
in float32. `embed` is the gather (the reference's one-hot variant exists
for a vocab-sharded mesh, which one card does not have); the training
loss's `unembed_chunked` waits for the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, (1 + scale) convention (gemma-style zero-init safe)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings. x: (..., S, H, hd); positions: (..., S)."""
    if theta <= 0.0:
        return x
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freq  # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def mlp(x: torch.Tensor, p: dict, variant: str) -> torch.Tensor:
    """Gated/plain MLP. p holds 'up' (and 'gate'), 'down'."""
    if variant == "swiglu":
        h = F.silu(x @ p["gate"]) * (x @ p["up"])
    elif variant == "geglu":
        h = F.gelu(x @ p["gate"], approximate="tanh") * (x @ p["up"])
    elif variant == "gelu":
        h = F.gelu(x @ p["up"], approximate="tanh")
    else:
        raise ValueError(f"unknown mlp variant {variant}")
    return h @ p["down"]


def embed(tokens: torch.Tensor, table: torch.Tensor, scale: bool) -> torch.Tensor:
    x = table[tokens.long()]
    if scale:
        x = x * torch.tensor(table.shape[1] ** 0.5, dtype=x.dtype, device=x.device)
    return x


#: Vocabulary rows `logits_last` widens to float32 at a time off the card.
LOGITS_CHUNK = 8192


def logits_last(h_last: torch.Tensor, table: torch.Tensor,
                final_cap: float = 0.0) -> torch.Tensor:
    """Full logits for the last position only (decode). h_last: (B, d);
    table (V, d). The reference's bf16 x bf16 -> f32 contraction: on a CUDA
    tensor one GEMM that reads the table in its own type and writes float32
    (`torch.mm(..., out_dtype=torch.float32)`, float32 accumulation);
    elsewhere the table is widened to float32 `LOGITS_CHUNK` rows at a time
    (bf16 products are exact in float32), never whole: at a 256,000 x 3,584
    vocabulary the whole table in float32 is 3.7 GB."""
    if table.device.type == "cuda" and table.dtype != torch.float32:
        logits = torch.mm(h_last.to(table.dtype), table.T, out_dtype=torch.float32)
    else:
        hf = h_last.float()
        logits = torch.cat([hf @ table[i:i + LOGITS_CHUNK].float().T
                            for i in range(0, table.shape[0], LOGITS_CHUNK)], dim=-1)
    return softcap(logits, final_cap)
