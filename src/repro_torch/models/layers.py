"""Shared neural layers: norms, rope, MLP variants, embeddings.

The reference's `repro.models.layers` in PyTorch, at the same dtypes:
norms and rope in float32 cast back to the input's type, logits accumulated
in float32. `embed` is the gather (the reference's one-hot variant exists
for a vocab-sharded mesh, which one card does not have). `unembed_chunked`
is the training loss's summed NLL, chunked over the sequence in the forward
and the backward alike.
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
#: Devices whose bf16 products take one float32-output GEMM
#: (`torch.mm(..., out_dtype=torch.float32)`): the card, and `meta`, which
#: stands for the card in the dry run's estimate (`launch.dryrun`). The CPU
#: has no such GEMM and widens its operands instead.
OUT_DTYPE_GEMM_DEVICES = ("cuda", "meta")


def logits_last(h_last: torch.Tensor, table: torch.Tensor,
                final_cap: float = 0.0) -> torch.Tensor:
    """Full logits for the last position only (decode). h_last: (B, d);
    table (V, d). The reference's bf16 x bf16 -> f32 contraction: on a CUDA
    tensor one GEMM that reads the table in its own type and writes float32
    (`torch.mm(..., out_dtype=torch.float32)`, float32 accumulation);
    elsewhere the table is widened to float32 `LOGITS_CHUNK` rows at a time
    (bf16 products are exact in float32), never whole: at a 256,000 x 3,584
    vocabulary the whole table in float32 is 3.7 GB."""
    if table.device.type in OUT_DTYPE_GEMM_DEVICES and table.dtype != torch.float32:
        logits = torch.mm(h_last.to(table.dtype), table.T, out_dtype=torch.float32)
    else:
        hf = h_last.float()
        logits = torch.cat([hf @ table[i:i + LOGITS_CHUNK].float().T
                            for i in range(0, table.shape[0], LOGITS_CHUNK)], dim=-1)
    return softcap(logits, final_cap)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated in and returned as float32: on a CUDA tensor one
    GEMM that reads bf16 operands in their own type
    (`torch.mm(..., out_dtype=torch.float32)`), elsewhere on operands
    widened to float32 (bf16 products are exact in float32)."""
    if a.device.type in OUT_DTYPE_GEMM_DEVICES and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk_logits(hq: torch.Tensor, table: torch.Tensor, final_cap: float) -> torch.Tensor:
    """Soft-capped float32 logits (B, c, V) of one chunk hq (B, c, d)."""
    b, c, d = hq.shape
    return softcap(_mm_f32(hq.reshape(b * c, d), table.T).reshape(b, c, -1), final_cap)


class _UnembedNLL(torch.autograd.Function):
    """The summed NLL of `unembed_chunked`, chunk by chunk both ways: the
    backward recomputes each chunk's logits, so one chunk's (B, c, V)
    float32 logits (and their softmax) are live at a time in either pass.
    Its products run in the table's type with float32 accumulation (the
    logits' cotangent rounded to that type, as the reference's transposed
    bf16 contraction rounds it); the table's gradient is summed over the
    chunks in float32 and rounded to the table's type once."""

    @staticmethod
    def forward(ctx, h, table, labels, chunk, final_cap):
        ctx.save_for_backward(h, table, labels)
        ctx.chunk, ctx.final_cap = chunk, final_cap
        nll = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, h.shape[1], chunk):
            logits = _chunk_logits(h[:, i:i + chunk], table, final_cap)
            gold = logits.gather(-1, labels[:, i:i + chunk, None].long())[..., 0]
            nll = nll + torch.sum(torch.logsumexp(logits, dim=-1) - gold)
        return nll

    @staticmethod
    def backward(ctx, g):
        h, table, labels = ctx.saved_tensors
        chunk, cap = ctx.chunk, ctx.final_cap
        b, s, d = h.shape
        gh = torch.empty_like(h) if ctx.needs_input_grad[0] else None
        gt = (torch.zeros(table.shape, dtype=torch.float32, device=table.device)
              if ctx.needs_input_grad[1] else None)
        for i in range(0, s, chunk):
            hq = h[:, i:i + chunk]
            c = hq.shape[1]
            logits = _chunk_logits(hq, table, cap)
            dl = torch.softmax(logits, dim=-1)  # d nll / d logits = p - onehot(label)
            dl.scatter_add_(-1, labels[:, i:i + chunk, None].long(),
                            torch.full((b, c, 1), -1.0, device=dl.device))
            if cap > 0.0:  # through cap * tanh(x / cap)
                dl.mul_(1.0 - torch.square(logits / cap))
            del logits
            dl = dl.mul_(g).reshape(b * c, -1).to(table.dtype)
            if gh is not None:
                gh[:, i:i + c] = (dl @ table).reshape(b, c, d)
            if gt is not None:
                gt.add_(dl.T @ hq.reshape(b * c, d).to(table.dtype))
        return gh, (gt.to(table.dtype) if gt is not None else None), None, None, None


def unembed_chunked(h: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
                    chunk: int = 512, final_cap: float = 0.0) -> torch.Tensor:
    """Cross-entropy against a huge vocab without materializing full logits:
    over sequence chunks, each chunk's logits (B, chunk, V) in float32
    (soft-capped), the label's log-prob, discarded; the backward recomputes
    them a chunk at a time. h (B, S, d), table (V, d), labels (B, S).
    Returns the summed NLL (float32, 0-d)."""
    if h.shape[1] % chunk:
        raise ValueError(f"chunk {chunk} does not divide the sequence of {h.shape[1]}")
    return _UnembedNLL.apply(h, table, labels, chunk, final_cap)
