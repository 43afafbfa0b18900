"""Collapsed Gibbs sampling for (R)LDA — the blocked parallel sweep.

The collapsed-Gibbs estimator (paper Eq. 5)

    p(z_di = t | rest) ∝ (n_td^-di + α_t)(n_tw^-di + β_w) / (n_t^-di + β̄)

is applied to *all tokens of a sweep in parallel* against a sweep-stale
count snapshot with exact self-exclusion, sampling by Gumbel-max over the
(token × topic) scores. Tokens go through in blocks of `block`, so the
noise in flight is O(block · K). Each block is one call of the
`kernels.lda_gibbs` wrapper: the plain version on CPU tensors, the Hopper
kernel on CUDA tensors.

`sweep` and `run` take an explicit `torch.Generator` (on the corpus's
device) and optionally the noise itself, so a test can replay the noise
the reference draws from a key.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import codec
from repro_torch.core.types import Corpus, LDAConfig, LDAState, init_state
from repro_torch.kernels.lda_gibbs import ops


def resample_block(
    cfg: LDAConfig,
    docs_b: torch.Tensor,
    words_b: torch.Tensor,
    z_b: torch.Tensor,
    weights_b: torch.Tensor,
    n_dt: torch.Tensor,
    n_wt: torch.Tensor,
    n_t: torch.Tensor,
    gumbel_b: torch.Tensor,
) -> torch.Tensor:
    """Resample one block of tokens against stale real-unit counts."""
    return ops.resample(docs_b, words_b, z_b, weights_b, n_dt, n_wt, n_t, gumbel_b,
                        alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar)


def sweep(
    cfg: LDAConfig,
    state: LDAState,
    corpus: Corpus,
    gen: torch.Generator,
    block: int = 4096,
    noise: Optional[torch.Tensor] = None,
) -> LDAState:
    """One full parallel Gibbs sweep; returns the new state.

    `noise`, when given, is (nblocks, block, K): block b's tokens use the
    first rows of `noise[b]`, as the reference draws one (block, K) tile
    per block key.
    """
    n = corpus.num_tokens
    k = cfg.num_topics
    n_dt, n_wt, n_t = codec.decode_counts(cfg, state)
    z_new = torch.empty_like(state.z)
    for b, lo in enumerate(range(0, n, block)):
        hi = min(n, lo + block)
        g = (ops.gumbel((hi - lo, k), gen, corpus.device) if noise is None
             else noise[b, : hi - lo])
        z_new[lo:hi] = resample_block(
            cfg, corpus.docs[lo:hi], corpus.words[lo:hi], state.z[lo:hi],
            corpus.weights[lo:hi], n_dt, n_wt, n_t, g)
    # Rebuild in real units, store via the codec (fixed point if w_bits).
    return codec.rebuild_state(cfg, corpus, z_new)


def run(
    cfg: LDAConfig,
    corpus: Corpus,
    gen: torch.Generator,
    num_sweeps: int,
    state: Optional[LDAState] = None,
    block: int = 4096,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> LDAState:
    """Run `num_sweeps` full sweeps from scratch or a warm state;
    `noise[s]`, when given, is sweep s's noise (see `sweep`)."""
    if state is None:
        state = codec.encode_state(cfg, init_state(cfg, corpus, gen))
    for s in range(num_sweeps):
        state = sweep(cfg, state, corpus, gen, block,
                      None if noise is None else noise[s])
    return state
