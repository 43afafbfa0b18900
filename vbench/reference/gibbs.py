"""One collapsed-Gibbs resample in plain PyTorch (paper Eq. 5, Gumbel-max).

For each live token (weight > 0) of each of M stacked models:

    own_t   = w if t == z else 0                       (self-exclusion)
    score_t = (log(max(n_dt*s - own, 0) + alpha) + log(max(n_wt*s - own, 0) + beta))
              - log(max(n_t*s - own, 1e-9) + beta_bar)
    z_new   = the first t of the largest score_t + g_t

with s the fixed-point scale 2^-(w_bits+1) (1 for float counts) and g the
Gumbel noise; a weight-0 token keeps its topic. Every operation is rounded
to `dtype` (float32 as the configuration states; bfloat16 is the control).
Tokens are taken in blocks so that an (M, block, K) score fits.
"""

from __future__ import annotations

from typing import Callable

import torch

SCORE_ELEMENTS = 1 << 26  # scores a block holds


def resample(docs, words, z, weights, n_dt, n_wt, n_t, noise: Callable, *, alpha: float,
             beta: float, beta_bar: float, scale: float,
             dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """New topics (M, N) int32 from ids, z and weights (M, N), stored
    tables (M, D, K), (M, V, K), (M, K) and `noise(start, stop, dtype)`,
    the (M, stop - start, K) noise of a block of tokens; and each token's
    margin, the gap between its best and second-best perturbed score
    (+inf for a weight-0 token)."""
    m, n = z.shape
    k = n_t.shape[-1]
    block = max(1, SCORE_ELEMENTS // (m * k))
    model = torch.arange(m, device=z.device)[:, None]
    topic = torch.arange(k, device=z.device)
    tot = (n_t.to(torch.float32) * scale).to(dtype)[:, None, :]
    out = torch.empty_like(z)
    margin = torch.full(z.shape, float("inf"), device=z.device)
    for start in range(0, n, block):
        stop = min(n, start + block)
        zb, wb = z[:, start:stop], weights[:, start:stop]
        rows_d = (n_dt[model, docs[:, start:stop]].to(torch.float32) * scale).to(dtype)
        rows_w = (n_wt[model, words[:, start:stop]].to(torch.float32) * scale).to(dtype)
        own = torch.where(topic == zb[..., None], wb[..., None], 0.0).to(dtype)
        rd = torch.clamp_min(rows_d - own, 0.0)
        rw = torch.clamp_min(rows_w - own, 0.0)
        tt = torch.clamp_min(tot - own, 1e-9)
        del rows_d, rows_w
        score = (torch.log(rd + alpha) + torch.log(rw + beta)) - torch.log(tt + beta_bar)
        score = score + noise(start, stop, dtype)
        best = torch.argmax(score, dim=-1, keepdim=True)
        out[:, start:stop] = torch.where(wb > 0.0, best[..., 0].to(z.dtype), zb)
        if k > 1:  # the best score less the next best (the best masked out)
            first = score.gather(-1, best)[..., 0].to(torch.float32)
            second = score.scatter_(-1, best, float("-inf")).amax(-1).to(torch.float32)
            margin[:, start:stop] = torch.where(wb > 0.0, first - second, float("inf"))
    return out, margin
