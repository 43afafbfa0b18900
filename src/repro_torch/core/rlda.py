"""RLDA — Review-augmented Latent Dirichlet Allocation (paper §3.1, §4.3).

RLDA keeps LDA's Dirichlet-multinomial core and adds, per review d:

  r_d          observed star rating
  b_d, σ_d²    mean/variance of user d's rating biases (excl. review d)
  r̃_d ~ N(r_d + b_d, σ_d² + 1)        bias-corrected rating
  c_{d,1..5}   rating-tier probabilities  (paper §4.3 tier boundaries)
  ν_d, u_d, h_d  writing quality, unhelpful votes, helpful votes
  ψ_d ~ Bernoulli(Logistic(ν_d, u_d, h_d))  review-quality weight

and realizes the conditioning as the paper's implementation does:

  * rating tiers are folded into the *vocabulary*: each token of review d is
    mapped to the augmented word id  ``word * 5 + (tier - 1)``;
  * ψ_d (and, for users with rating history, the tier probability c_{d,t})
    enter as **fractional token weights**, stored in w_bits fixed point.

`prepare` is deterministic; the tier probabilities and ψ are computed in
float32, as the reference computes them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import quality as quality_lib
from repro_torch.core.types import Corpus, LDAConfig, corpus_from_numpy

NUM_TIERS = 5
# Paper §4.3 tier boundaries on the bias-corrected rating r̃.
TIER_EDGES = np.array([1.5, 2.5, 3.5, 4.5])


@dataclasses.dataclass(frozen=True)
class Review:
    """One raw review record (the auxiliary data LDA discards, §2.2)."""

    tokens: np.ndarray  # (n_d,) int32 base-vocab word ids
    rating: float  # r_d ∈ {1..5}
    user: int
    helpful: int  # h_d
    unhelpful: int  # u_d
    writing_quality: float  # ν_d (OOV rate, punctuation, word length, ...)


def _normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.special.erf(x / math.sqrt(2.0)))


def tier_probabilities(r, b, sigma2) -> torch.Tensor:
    """c_{d,t} = P(r̃_d in tier t),  r̃_d ~ N(r_d + b_d, σ_d² + 1), float32.

    c_1 = P(r̃<=1.5), c_5 = P(r̃>4.5), interior tiers are CDF differences.
    """
    r, b, sigma2 = (torch.as_tensor(a).to(torch.float32) for a in (r, b, sigma2))
    mu = r + b
    sd = torch.sqrt(sigma2 + 1.0)
    edges = torch.as_tensor(TIER_EDGES, dtype=torch.float32, device=mu.device)
    cdf = _normal_cdf((edges[None, :] - mu[:, None]) / sd[:, None])  # (D, 4)
    ones = torch.ones_like(mu)[:, None]
    zeros = torch.zeros_like(mu)[:, None]
    upper = torch.cat([cdf, ones], dim=1)
    lower = torch.cat([zeros, cdf], dim=1)
    return upper - lower  # (D, 5), rows sum to 1


def user_bias_stats(ratings: np.ndarray, users: np.ndarray):
    """Leave-one-out mean/variance of each user's rating bias.

    Bias of a review = its rating minus the global mean rating. For users
    with a single review the leave-one-out set is empty: b_d = 0, σ_d² = 0,
    collapsing c_d onto the observed tier (paper §4.3 approximation).
    """
    ratings = np.asarray(ratings, np.float64)
    users = np.asarray(users, np.int64)
    global_mean = ratings.mean() if len(ratings) else 0.0
    bias = ratings - global_mean

    nu = users.max() + 1 if len(users) else 0
    cnt = np.bincount(users, minlength=nu).astype(np.float64)
    s1 = np.bincount(users, weights=bias, minlength=nu)
    s2 = np.bincount(users, weights=bias**2, minlength=nu)

    b = np.zeros_like(ratings)
    v = np.zeros_like(ratings)
    for i, u in enumerate(users):
        n = cnt[u] - 1.0
        if n >= 1.0:
            m = (s1[u] - bias[i]) / n
            b[i] = m
            if n >= 2.0:
                v[i] = max((s2[u] - bias[i] ** 2) / n - m**2, 0.0) * n / (n - 1.0)
    return b, v, cnt[users] > 1.5  # (has_history mask)


def augment_word(word: np.ndarray, tier: np.ndarray) -> np.ndarray:
    """word id -> rating-augmented id (the "_rating" suffix, §4.3)."""
    return word * NUM_TIERS + tier


def strip_rating(aug_word: np.ndarray):
    """Augmented id -> (base word id, tier) — used at display time."""
    return aug_word // NUM_TIERS, aug_word % NUM_TIERS


@dataclasses.dataclass
class RLDACorpus:
    """Prepared RLDA corpus: augmented tokens + per-token weights + metadata."""

    corpus: Corpus
    cfg: LDAConfig
    base_vocab: int
    psi: np.ndarray  # (D,) review-quality weights
    tiers: np.ndarray  # (D,) hard tier per review (argmax/observed)
    tier_probs: np.ndarray  # (D, 5)
    ratings: np.ndarray  # (D,)
    helpful: np.ndarray
    unhelpful: np.ndarray


def prepare(
    reviews: list[Review],
    base_vocab: int,
    num_topics: int,
    alpha: float = 0.1,
    beta: float = 0.01,
    w_bits: Optional[int] = 8,
    quality_model: Optional[quality_lib.QualityModel] = None,
    *,
    device,
) -> RLDACorpus:
    """Transform raw reviews into the flat weighted LDA-compatible corpus
    (paper §4.3), with the token tensors placed on `device`."""
    d_count = len(reviews)
    ratings = np.array([r.rating for r in reviews], np.float64)
    users = np.array([r.user for r in reviews], np.int64)
    helpful = np.array([r.helpful for r in reviews], np.float64)
    unhelpful = np.array([r.unhelpful for r in reviews], np.float64)
    nu_q = np.array([r.writing_quality for r in reviews], np.float64)

    # ψ_d — review quality via the logistic model (paper §4.3).
    if quality_model is None:
        quality_model = quality_lib.default_model()
    psi = quality_lib.predict(quality_model, nu_q, unhelpful, helpful).numpy().astype(np.float64)

    # c_d — tier distribution from the bias-corrected rating.
    b, v, has_hist = user_bias_stats(ratings, users)
    cprob = tier_probabilities(ratings, b, v).numpy()
    # Single-review users: collapse onto observed tier (paper approximation).
    obs_tier = np.clip(np.round(ratings) - 1, 0, 4).astype(np.int64)
    hard_tier = np.where(has_hist, np.argmax(cprob, axis=1), obs_tier)
    tier_weight = np.where(has_hist, cprob[np.arange(d_count), hard_tier], 1.0)

    docs, words, wts = [], [], []
    for d, r in enumerate(reviews):
        w_aug = augment_word(np.asarray(r.tokens, np.int64), hard_tier[d])
        docs.append(np.full(len(w_aug), d, np.int64))
        words.append(w_aug)
        wts.append(np.full(len(w_aug), psi[d] * tier_weight[d], np.float64))

    corpus = corpus_from_numpy(np.concatenate(docs), np.concatenate(words),
                               np.concatenate(wts), device=device)
    cfg = LDAConfig(
        num_topics=num_topics,
        vocab_size=base_vocab * NUM_TIERS,
        num_docs=d_count,
        alpha=alpha,
        beta=beta,
        w_bits=w_bits,
    )
    return RLDACorpus(
        corpus=corpus,
        cfg=cfg,
        base_vocab=base_vocab,
        psi=psi,
        tiers=hard_tier,
        tier_probs=cprob,
        ratings=ratings,
        helpful=helpful,
        unhelpful=unhelpful,
    )
