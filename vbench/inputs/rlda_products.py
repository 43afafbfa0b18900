"""Input generator `rlda_products`: RLDA corpora drawn on the device from
the run's seed.

A configuration that names it (`"inputs": "rlda_products"`) lists its
products (`products`: groups of `count` products of `reviews` reviews and
`tokens` tokens each) and the word law (`zipf_exponent` over `base_vocab`
base words in `tiers` rating tiers). Every piece is drawn in a few large
calls from one `torch.Generator` on the device, in the layout
`core.rlda.prepare` gives a corpus: reviews contiguous, each token's word
put in its review's rating tier (base * tiers + tier), each review's
weight psi * c on all of its tokens. The arithmetic is that of
`launch/dryrun_rlda.synthetic_corpus`:

  review lengths  a product's tokens each fall in a review drawn
                  uniformly, then sorted, so a length is
                  Binomial(tokens, 1/reviews)
  words           base words by inverse CDF from a Zipf law of exponent
                  `zipf_exponent`, in the review's tier, the tier uniform
                  over `tiers` a review
  weights         psi * c, uniform in (0, 1], one a review

The program receives only these tensors, wrapped as `core.rlda.RLDACorpus`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.rlda import RLDACorpus
from repro_torch.core.types import Corpus, LDAConfig

U64 = (1 << 64) - 1


def make(config: dict, seed: int, device) -> list[RLDACorpus]:
    """Every product of `config`, drawn from `seed` on `device`."""
    gen = torch.Generator(device=device).manual_seed(int(seed) & U64)
    dev = gen.device
    tiers, base_vocab = config["tiers"], config["base_vocab"]
    if base_vocab * tiers != config["vocab_size"]:
        raise ValueError("vocab_size must be base_vocab * tiers")
    doc_parts, sizes = [], []  # per product: its local review ids a token, (reviews, tokens)
    for group in config["products"]:
        reviews = group["reviews"]
        for _ in range(group["count"]):
            docs = torch.randint(0, reviews, (group["tokens"],), generator=gen, device=dev,
                                 dtype=torch.int32).sort().values
            doc_parts.append(docs)
            sizes.append((reviews, docs.numel()))
    docs = torch.cat(doc_parts)
    del doc_parts
    n_all = docs.numel()
    ranks = torch.arange(1, base_vocab + 1, device=dev, dtype=torch.float64)
    cdf = torch.cumsum(ranks ** -float(config["zipf_exponent"]), 0)
    u = torch.rand(n_all, generator=gen, device=dev, dtype=torch.float64) * cdf[-1]
    base = torch.searchsorted(cdf, u).clamp_max_(base_vocab - 1)
    del u
    reviews_all = sum(r for r, _ in sizes)
    tier = torch.randint(0, tiers, (reviews_all,), generator=gen, device=dev)
    per_review = 1.0 - torch.rand(reviews_all, generator=gen, device=dev)  # (0, 1]
    review_start = torch.tensor([0] + [r for r, _ in sizes[:-1]], device=dev).cumsum(0)
    token_counts = torch.tensor([n for _, n in sizes], device=dev)
    review = docs.long() + torch.repeat_interleave(review_start, token_counts)
    words = (base * tiers + tier[review]).to(torch.int32)
    weights = per_review[review].contiguous()
    del base, review
    tier_np, psi_np = tier.cpu().numpy(), per_review.double().cpu().numpy()
    out, tok, rev = [], 0, 0
    for reviews, n in sizes:
        corpus = Corpus(docs=docs[tok:tok + n], words=words[tok:tok + n],
                        weights=weights[tok:tok + n])
        t = tier_np[rev:rev + reviews]
        out.append(RLDACorpus(
            corpus=corpus, base_vocab=base_vocab,
            cfg=LDAConfig(num_topics=config["num_topics"], vocab_size=config["vocab_size"],
                          num_docs=reviews, alpha=config["alpha"], beta=config["beta"],
                          w_bits=config["w_bits"]),
            psi=psi_np[rev:rev + reviews], tiers=t,
            tier_probs=np.eye(tiers)[t], ratings=(t + 1).astype(np.float64),
            helpful=np.zeros(reviews), unhelpful=np.zeros(reviews)))
        tok, rev = tok + n, rev + reviews
    return out

