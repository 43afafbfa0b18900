"""Synthetic Amazon-like review corpus generator.

The paper's corpus is the SNAP Amazon review dataset (Leskovec & Krevl,
2014; 23M reviews) which is not available offline; we generate a faithful
synthetic replacement with the same *structure*: per-review text tokens
drawn from rating-dependent planted topics, star ratings with per-user
biases, helpfulness/unhelpfulness votes correlated with review quality, and
a fraction of irrelevant (off-product) reviews — exactly the auxiliary
signal RLDA is designed to exploit and LDA discards (§2.2, §3.1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.rlda import Review


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    num_reviews: int = 500
    vocab_size: int = 1000
    num_topics: int = 8
    mean_tokens: int = 60
    num_users: int = 200
    # Fraction of topics that only appear in negative (<=2.5 star) reviews —
    # the "poor product quality / customer service" structure of §3.1.
    negative_topic_frac: float = 0.25
    irrelevant_frac: float = 0.1  # off-product reviews (the sore-neck review)
    seed: int = 0


@dataclasses.dataclass
class SyntheticCorpus:
    reviews: list[Review]
    spec: SyntheticSpec
    true_topics: np.ndarray  # (K, V) planted word distributions
    doc_topic: np.ndarray  # (D, K) planted mixtures
    relevant: np.ndarray  # (D,) bool — ground truth for ψ


def generate(spec: SyntheticSpec) -> SyntheticCorpus:
    rng = np.random.default_rng(spec.seed)
    k, v = spec.num_topics, spec.vocab_size

    # Planted topics: disjoint-ish word blocks + smoothing.
    phi = np.full((k, v), 0.05 / v)
    block = v // k
    for t in range(k):
        phi[t, t * block : (t + 1) * block] += 0.95 / block
    phi /= phi.sum(1, keepdims=True)

    n_neg = max(1, int(k * spec.negative_topic_frac))
    neg_topics = np.arange(k - n_neg, k)  # last topics are negative-only

    user_bias = rng.normal(0.0, 0.4, spec.num_users)
    reviews, doc_topic, relevant = [], [], []
    for _d in range(spec.num_reviews):
        user = int(rng.integers(0, spec.num_users))
        is_relevant = rng.random() > spec.irrelevant_frac

        # True sentiment drives both rating and topic mixture.
        sentiment = rng.uniform(1.0, 5.0)
        rating = float(np.clip(np.round(sentiment + user_bias[user] + rng.normal(0, 0.3)), 1, 5))

        alpha = np.full(k, 0.3)
        if sentiment <= 2.5:
            alpha[neg_topics] += 3.0  # negative reviews hit negative topics
        else:
            alpha[: k - n_neg] += 1.5
        theta = rng.dirichlet(alpha)

        n_tok = max(5, int(rng.poisson(spec.mean_tokens)))
        if is_relevant:
            zs = rng.choice(k, size=n_tok, p=theta)
            toks = np.array([rng.choice(v, p=phi[t]) for t in zs], np.int32)
        else:
            toks = rng.integers(0, v, n_tok).astype(np.int32)  # off-topic noise

        wq = float(np.clip(rng.normal(0.6 if is_relevant else 0.2, 0.15), 0, 1))
        base_votes = rng.poisson(6)
        helpful = int(np.round(base_votes * (wq if is_relevant else wq * 0.4)))
        unhelpful = max(0, base_votes - helpful)

        reviews.append(
            Review(
                tokens=toks,
                rating=rating,
                user=user,
                helpful=helpful,
                unhelpful=unhelpful,
                writing_quality=wq,
            )
        )
        doc_topic.append(theta)
        relevant.append(is_relevant)

    return SyntheticCorpus(
        reviews=reviews,
        spec=spec,
        true_topics=phi,
        doc_topic=np.array(doc_topic),
        relevant=np.array(relevant),
    )


def train_test_split(corpus: SyntheticCorpus, test_frac: float = 0.2, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = len(corpus.reviews)
    perm = rng.permutation(n)
    cut = int(n * (1 - test_frac))
    tr = [corpus.reviews[i] for i in perm[:cut]]
    te = [corpus.reviews[i] for i in perm[cut:]]
    return tr, te
