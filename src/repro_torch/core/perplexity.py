"""Perplexity evaluation — the currency of Chital's marketplace (§2.5).

Point-estimate evaluation: with

    θ̂_dt = (n_dt + α) / (n_d + ᾱ),   φ̂_tw = (n_wt + β) / (n_t + β̄)

perplexity = exp( - Σ_i w_i log Σ_t θ̂_{d_i t} φ̂_{t w_i}  /  Σ_i w_i ),
accumulated in float32 over blocks of 8192 tokens, as the reference does.
"""

from __future__ import annotations

import torch

from repro_torch.core import codec
from repro_torch.core.types import Corpus, LDAConfig, LDAState


def log_likelihood(cfg: LDAConfig, state: LDAState, corpus: Corpus,
                   block: int = 8192) -> torch.Tensor:
    """Total weighted token log-likelihood under point estimates."""
    n_dt, n_wt, n_t = codec.decode_counts(cfg, state)
    alpha_bar = cfg.alpha * cfg.num_topics
    theta = (n_dt + cfg.alpha) / (n_dt.sum(-1, keepdim=True) + alpha_bar)  # (D,K)
    phi_t = (n_wt + cfg.beta) / (n_t[None, :] + cfg.beta_bar)  # (V,K)

    parts = []
    for lo in range(0, corpus.num_tokens, block):
        d_b = corpus.docs[lo:lo + block]
        w_b = corpus.words[lo:lo + block]
        wt_b = corpus.weights[lo:lo + block]
        p = torch.sum(theta[d_b] * phi_t[w_b], dim=-1)  # (block,)
        parts.append(torch.sum(wt_b * torch.log(torch.clamp_min(p, 1e-30))))
    if not parts:
        return torch.zeros((), dtype=torch.float32, device=corpus.device)
    return torch.sum(torch.stack(parts))


def perplexity(cfg: LDAConfig, state: LDAState, corpus: Corpus) -> float:
    ll = log_likelihood(cfg, state, corpus)
    total_w = torch.clamp_min(corpus.weights.sum(), 1e-9)
    return float(torch.exp(-ll / total_w))
