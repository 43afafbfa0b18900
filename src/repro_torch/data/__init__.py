"""Data substrate: synthetic Amazon-like review generation, and the seeded
bigram LM stream the transformer zoo trains on (`data.lm`)."""

from repro_torch.data.lm import BigramStream, LMSpec, batches_for  # noqa: F401
