"""Batched multi-model Gibbs sweeps: M product models in one launch.

The paper's closing claim — "rapidly compute a large number of specialized
latent variable models", one RLDA model per product — needs the fit path
to amortize across models, not only across tokens. As in the reference
(`repro.core.batch`), M *compatible* models (same num_topics, vocab and
hyperparameters) are stacked along a leading model axis, with corpora
padded to a shared token length (weight-0 padding) and doc-count tables
to a shared document capacity, and swept together: each sweep is one
launch of the batched Gibbs kernel for all M models
(`kernels.lda_gibbs.ops.sweep_many`; its plain version on CPU tensors).
Stacks reuse `Corpus` and `LDAState` with a leading (M,) axis on every
tensor; the counts of all M models rebuild in one scatter
(`core.types.build_counts`).

Randomness: model i owns generator i and consumes it exactly as
`_BaseSampler.run` would for it alone — its init draw and each sweep's
(N_i, K) uniforms at its own token count N_i, never at the padded length
(a CUDA Philox draw of N_pad rows does not begin with the draw of N_i
rows) — so on the CPU a batched run equals M sequential `cuda` runs from
the same generators token for token.

Bucketing policy (which models may stack) lives one layer up in
`serving.batch_engine`; this module only checks compatibility.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import codec
from repro_torch.core.types import Corpus, LDAConfig, LDAState
from repro_torch.kernels.lda_gibbs import ops as kops


def compat_key(cfg: LDAConfig) -> tuple:
    """Models with equal keys may share one batched launch: the sampler's
    constants (K, V, priors, fixed-point format)."""
    return (cfg.num_topics, cfg.vocab_size, cfg.alpha, cfg.beta, cfg.w_bits)


def batch_cfg(cfgs: Sequence[LDAConfig], num_docs: int) -> LDAConfig:
    """The shared config of a stack: compat-checked, with `num_docs` set to
    the padded per-model document capacity."""
    keys = {compat_key(c) for c in cfgs}
    if len(keys) != 1:
        raise ValueError(f"cannot stack incompatible models: {sorted(keys)}")
    if num_docs < max(c.num_docs for c in cfgs):
        raise ValueError(f"document capacity {num_docs} below largest model "
                         f"({max(c.num_docs for c in cfgs)})")
    return dataclasses.replace(cfgs[0], num_docs=num_docs)


def _pad(t: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([t, t.new_zeros((n - t.shape[0],) + tuple(t.shape[1:]))])


def pad_corpus(corpus: Corpus, num_tokens: int) -> Corpus:
    """Pad a corpus to `num_tokens` with weight-0 tokens (doc/word id 0 —
    valid ids whose zero weight keeps them out of every count)."""
    pad = num_tokens - corpus.num_tokens
    if pad < 0:
        raise ValueError(f"corpus has {corpus.num_tokens} tokens > pad target {num_tokens}")
    if pad == 0:
        return corpus
    return Corpus(*(_pad(t, num_tokens) for t in (corpus.docs, corpus.words, corpus.weights)))


def stack_corpora(corpora: Sequence[Corpus], num_tokens: int) -> Corpus:
    """Stack corpora into one (M, num_tokens) batch (weight-0 padding)."""
    padded = [pad_corpus(c, num_tokens) for c in corpora]
    return Corpus(
        docs=torch.stack([c.docs for c in padded]),
        words=torch.stack([c.words for c in padded]),
        weights=torch.stack([c.weights for c in padded]),
    )


def stack_states(bcfg: LDAConfig, states: Sequence[LDAState],
                 num_tokens: int) -> LDAState:
    """Stack warm per-model states (stored units) to the batch shape.

    z pads with topic 0 (padding tokens have weight 0 and keep their
    assignment), n_dt pads with zero rows up to the document capacity.
    """
    return LDAState(
        z=torch.stack([_pad(st.z, num_tokens) for st in states]),
        n_dt=torch.stack([_pad(st.n_dt, bcfg.num_docs) for st in states]),
        n_wt=torch.stack([st.n_wt for st in states]),
        n_t=torch.stack([st.n_t for st in states]),
    )


def unstack_states(cfgs: Sequence[LDAConfig], corpora: Sequence[Corpus],
                   states: LDAState) -> list[LDAState]:
    """Trim each model's z back to its true token count and rebuild its
    counts under its own (unpadded) config — stored units, the same
    contract as every single-model backend."""
    return [
        codec.rebuild_state(cfg, corpus, states.z[i, : corpus.num_tokens].clone())
        for i, (cfg, corpus) in enumerate(zip(cfgs, corpora, strict=True))
    ]


def _lengths(corpora: Corpus, lengths: Optional[Sequence[int]]) -> list[int]:
    m, n = corpora.docs.shape
    return [n] * m if lengths is None else list(lengths)


# -- batched sweeps -----------------------------------------------------------


def init_many(cfg: LDAConfig, corpora: Corpus, gens: Sequence[torch.Generator],
              lengths: Optional[Sequence[int]] = None) -> LDAState:
    """Stacked cold start, stored units: model i draws its uniform init over
    its `lengths[i]` real tokens from `gens[i]` (as `init_state` does on its
    unpadded corpus; padding keeps topic 0), then one batched rebuild."""
    m, n = corpora.docs.shape
    z = torch.zeros((m, n), dtype=torch.int32, device=corpora.device)
    for i, (gen, n_i) in enumerate(zip(gens, _lengths(corpora, lengths), strict=True)):
        z[i, :n_i] = torch.randint(0, cfg.num_topics, (n_i,), generator=gen,
                                   device=corpora.device, dtype=torch.int32)
    return codec.rebuild_state(cfg, corpora, z)


def draw_noise(noise: torch.Tensor, gens: Sequence[torch.Generator],
               lengths: Sequence[int]) -> torch.Tensor:
    """One sweep's Gumbel noise for a stack, in place in the (M, N, K)
    buffer `noise`: model i's first `lengths[i]` rows take the (N_i, K)
    uniforms `gens[i]` would give its single-model sweep; then the Gumbel
    transform runs over the whole buffer (padding rows stay finite)."""
    k = noise.shape[-1]
    for i, (gen, n_i) in enumerate(zip(gens, lengths, strict=True)):
        torch.rand((n_i, k), generator=gen, out=noise[i, :n_i])
    return kops.gumbel_(noise)


def sweep_batch(cfg: LDAConfig, states: LDAState, corpora: Corpus,
                gens: Sequence[torch.Generator],
                lengths: Optional[Sequence[int]] = None) -> LDAState:
    """One full sweep over M stacked models; model i consumes `gens[i]`
    exactly as the single-model `cuda` sweep would."""
    m, n = corpora.docs.shape
    noise = torch.zeros((m, n, cfg.num_topics), dtype=torch.float32, device=corpora.device)
    return kops.sweep_many(cfg, states, corpora,
                           draw_noise(noise, gens, _lengths(corpora, lengths)))


def run_many(cfg: LDAConfig, states: LDAState, corpora: Corpus,
             gens: Sequence[torch.Generator], num_sweeps: int,
             lengths: Optional[Sequence[int]] = None) -> LDAState:
    """`num_sweeps` sweeps over all M stacked models (stored units in and
    out), one batched kernel launch each; the (M, N, K) noise buffer is
    allocated once for the run."""
    m, n = corpora.docs.shape
    lengths = _lengths(corpora, lengths)
    noise = torch.zeros((m, n, cfg.num_topics), dtype=torch.float32, device=corpora.device)
    for _ in range(num_sweeps):
        states = kops.sweep_many(cfg, states, corpora, draw_noise(noise, gens, lengths))
    return states


def fit_many(cfg: LDAConfig, corpora: Corpus, gens: Sequence[torch.Generator],
             num_sweeps: int, states: Optional[LDAState] = None,
             lengths: Optional[Sequence[int]] = None) -> LDAState:
    """Cold (or warm, with `states`) batched fit of M stacked models.
    Mirrors `_BaseSampler.run` per model: on a cold start each generator
    first draws its init, then drives the sweeps."""
    if states is None:
        states = init_many(cfg, corpora, gens, lengths)
    return run_many(cfg, states, corpora, gens, num_sweeps, lengths)
