"""Synthetic LM data pipeline for the transformer zoo.

Deterministic, seeded, structured enough that a ~100M model's loss visibly
drops within a few hundred steps: token streams come from a random-walk
bigram process (every token's successor distribution is low-entropy), so
the learnable signal is real — unlike uniform noise, which has no signal,
or constant data, which collapses instantly.

Batches match `model.real_batch` layouts: tokens/labels (B, S) int32
(+ stub patches/frames for the vlm/audio carve-outs), as numpy arrays.

The reference's `repro.data.lm`, copied: it is numpy there too, so the same
seed gives the same batches, array for array, in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMSpec:
    vocab_size: int
    seq_len: int
    global_batch: int
    branching: int = 4  # successors per token (entropy ~= log(branching))
    seed: int = 0


class BigramStream:
    """Infinite deterministic bigram-process batch iterator."""

    def __init__(self, spec: LMSpec):
        self.spec = spec
        rng = np.random.default_rng(spec.seed)
        v, b = spec.vocab_size, spec.branching
        self.successors = rng.integers(0, v, size=(v, b)).astype(np.int32)
        self._rng = np.random.default_rng(spec.seed + 1)

    def next_batch(self) -> dict:
        s = self.spec
        n = s.global_batch
        toks = np.empty((n, s.seq_len + 1), np.int32)
        toks[:, 0] = self._rng.integers(0, s.vocab_size, n)
        choice = self._rng.integers(0, s.branching, (n, s.seq_len))
        for t in range(s.seq_len):
            toks[:, t + 1] = self.successors[toks[:, t], choice[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


def batches_for(cfg, seq_len: int, global_batch: int, seed: int = 0,
                frontend_seed: int = 7):
    """Batch iterator matched to an ArchConfig (adds stub modality inputs)."""
    stream = BigramStream(
        LMSpec(vocab_size=cfg.vocab_size, seq_len=seq_len,
               global_batch=global_batch, seed=seed)
    )
    rng = np.random.default_rng(frontend_seed)
    for batch in stream:
        if cfg.arch_type == "vlm":
            batch["patches"] = (
                rng.standard_normal(
                    (global_batch, cfg.num_frontend_tokens, cfg.d_model)
                ).astype(np.float32) * 0.02
            )
        elif cfg.arch_type == "audio":
            batch["frames"] = (
                rng.standard_normal(
                    (global_batch, cfg.encoder_tokens, cfg.d_model)
                ).astype(np.float32) * 0.02
            )
        yield batch
