"""RLDA + the blocked Gibbs sampler + the model lifecycle, in PyTorch.

Layout (each module mirrors `repro.core` of the same name):
  types.py       corpus/state/config structures (tensor dataclasses)
  quant.py       `QuantSpec` and the numpy row packing of the wire codec
  fractional.py  w_bits fixed-point fractional counts (paper §4.3)
  codec.py       stored <-> real count conversions (`StateCodec`)
  gibbs.py       blocked parallel collapsed Gibbs (Gumbel-max)
  alias.py       AliasLDA stale alias tables + parallel MH
  batch.py       M compatible models stacked into one batched sweep
  rlda.py        RLDA model: tiers, bias correction, token augmentation
  quality.py     ψ_d logistic review-quality model
  perplexity.py  evaluation
  coreset.py     variable-topic-count core-set reduction (paper §3.3)
  views.py       streamed model views (paper §4.2)
  update.py      incremental updating + periodic full recompute (paper §3.2)
"""

from repro_torch.core.types import Corpus, LDAConfig, LDAState, build_counts, init_state  # noqa: F401
