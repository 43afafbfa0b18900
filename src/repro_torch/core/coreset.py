"""Core-set topic reduction (paper §3.3).

Coreset-style importance selection: a topic's sensitivity is its corpus mass
(how much probability it explains) and its *informativeness* is how far its
top-word distribution departs from the corpus background unigram distribution
(KL divergence restricted to the top-n words — "information-void" topics sit
close to the background and are pruned).
"""

from __future__ import annotations

import torch

from repro_torch.core import codec
from repro_torch.core.types import LDAConfig, LDAState


def topic_mass(cfg: LDAConfig, state: LDAState) -> torch.Tensor:
    n_t = codec.decode_array(cfg, state.n_t).to(torch.float32)
    return n_t / torch.clamp_min(n_t.sum(), 1e-9)


def topic_informativeness(cfg: LDAConfig, state: LDAState, top_n: int = 20) -> torch.Tensor:
    """KL(topic || background) restricted to each topic's top-n words."""
    n_wt = codec.decode_array(cfg, state.n_wt).to(torch.float32)
    phi = (n_wt + cfg.beta) / (n_wt.sum(0, keepdim=True) + cfg.beta_bar)  # (V,K)
    bg = n_wt.sum(1) + cfg.beta  # background unigram
    bg = bg / bg.sum()  # (V,)
    phi_t = phi.T  # (K, V)
    top = torch.argsort(-phi_t, dim=1, stable=True)[:, :top_n]  # (K, n)
    p = torch.take_along_dim(phi_t, top, dim=1)
    q = bg[top]
    return torch.sum(p * (torch.log(p + 1e-30) - torch.log(q + 1e-30)), dim=1)  # (K,)


def select_core_set(
    cfg: LDAConfig,
    state: LDAState,
    *,
    mass_coverage: float = 0.9,
    min_informativeness: float | None = None,
    max_topics: int | None = None,
    top_n: int = 20,
):
    """Pick the smallest informative topic set covering `mass_coverage`.

    Returns (core_topic_ids sorted by importance, importance scores).
    Importance = mass × informativeness. The informativeness cutoff is
    adaptive by default: half the median KL (the mean of the two middle
    values for an even topic count, as `jnp.median` takes it).
    """
    mass = topic_mass(cfg, state)
    info = topic_informativeness(cfg, state, top_n=top_n)
    if min_informativeness is None:
        min_informativeness = 0.5 * float(torch.quantile(info, 0.5))
    score = mass * info
    order = torch.argsort(-score, stable=True)

    cum = torch.cumsum(mass[order], dim=0)
    keep_for_mass = cum <= mass_coverage
    # Always keep at least the first topic; drop info-void ones regardless.
    first = torch.arange(len(order), device=order.device) == 0
    keep = (keep_for_mass | first) & (info[order] >= min_informativeness)
    ids = [int(t) for t, k in zip(order.tolist(), keep.tolist()) if k]
    if max_topics is not None:
        ids = ids[:max_topics]
    return ids, score
