"""Batched multi-model fit engine: one launch a sweep for M product models.

Vedalia's workload is a *zoo* of per-product RLDA models; refitting 50
products as 50 single-model runs pays 50 launches a sweep. This module is
the batching layer (the reference's `repro.serving.batch_engine`): it
decides which prepared models may share a launch, stacks them, drives a
sampler with the stacked `run_many` surface (`api.backends.BatchedSampler`
over `core.batch` and the batched Gibbs kernel, or `AliasSampler` over the
batched MH kernel), and unstacks the results into ordinary per-model
states.

Bucketing rules (a bucket = one stacked run, one launch a sweep):

  * hard compatibility — `core.batch.compat_key`: num_topics, vocab_size,
    alpha, beta, w_bits are constants of the sweep;
  * padded corpus length — token counts round up to a power-of-two
    multiple of `LENGTH_QUANTUM`, so similar-sized corpora share a bucket
    and a bounded set of shapes is ever allocated;
  * padded document capacity — num_docs rounds up the same way
    (`DOC_QUANTUM`), bounding the `(M, D, K)` doc-count tensor shapes;
  * `max_models` bounds a single launch.

Consumers: `VedaliaService.fit_batch_prepared` / `refine_many`, hence the
`fit_batch` / `refine_batch` protocol verbs and
`serving.TopicEngine.fit_many`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import batch as batch_lib
from repro_torch.core.types import Corpus, LDAConfig, LDAState
from repro_torch.obs import metrics

#: Padding waste is the honest cost of the power-of-two shape ladder:
#: every padded token slot is carried by the sweep (the kernels skip its
#: score, the draws and rebuild do not). The pair of counters gives the
#: waste fraction without a separate ratio metric.
_BUCKET_MODELS = metrics.histogram(
    "vedalia_batch_bucket_models",
    "Models stacked into each batched launch.",
    labels=(), buckets=metrics.COUNT_BUCKETS)
_PADDED_TOKENS = metrics.counter(
    "vedalia_batch_padded_tokens_total",
    "Token slots spent on padding across batched launches.")
_REAL_TOKENS = metrics.counter(
    "vedalia_batch_real_tokens_total",
    "Real (unpadded) tokens swept by batched launches.")

#: Token-length padding quantum: corpus lengths round up to a power-of-two
#: multiple of this.
LENGTH_QUANTUM = 256

#: Document-capacity padding quantum.
DOC_QUANTUM = 16

#: Default ceiling on models per launch.
MAX_MODELS_PER_LAUNCH = 64


def _round_bucket(n: int, quantum: int) -> int:
    """Round up to quantum, 2*quantum, 4*quantum, ... (power-of-two ladder:
    a bounded family of shapes)."""
    q = max(1, -(-n // quantum))
    b = 1
    while b < q:
        b *= 2
    return b * quantum


def length_bucket(num_tokens: int) -> int:
    return _round_bucket(num_tokens, LENGTH_QUANTUM)


def doc_bucket(num_docs: int) -> int:
    return _round_bucket(num_docs, DOC_QUANTUM)


def bucket_key(cfg: LDAConfig, corpus: Corpus) -> tuple:
    """Models with equal keys stack into one launch."""
    return batch_lib.compat_key(cfg) + (
        length_bucket(corpus.num_tokens), doc_bucket(cfg.num_docs))


def plan_buckets(items: Sequence[tuple[LDAConfig, Corpus]],
                 max_models: int = MAX_MODELS_PER_LAUNCH) -> list[list[int]]:
    """Group item indices into launch buckets (insertion-ordered, each at
    most `max_models` long)."""
    groups: dict[tuple, list[int]] = {}
    for i, (cfg, corpus) in enumerate(items):
        groups.setdefault(bucket_key(cfg, corpus), []).append(i)
    buckets = []
    for idxs in groups.values():
        for j in range(0, len(idxs), max_models):
            buckets.append(idxs[j:j + max_models])
    return buckets


@dataclasses.dataclass(frozen=True)
class BatchStats:
    """What a batched run actually did — surfaced by benches and logs."""

    num_models: int
    num_launches: int

    @property
    def amortization(self) -> float:
        """Models per launch (1.0 means nothing batched)."""
        return self.num_models / max(self.num_launches, 1)


def _run_bucket(
    sampler,
    idxs: Sequence[int],
    cfgs: Sequence[LDAConfig],
    corpora: Sequence[Corpus],
    gens: Sequence[torch.Generator],
    num_sweeps: int,
    states: Optional[Sequence[LDAState]],
) -> list[LDAState]:
    b_cfgs = [cfgs[i] for i in idxs]
    b_corps = [corpora[i] for i in idxs]
    lengths = [c.num_tokens for c in b_corps]
    n_pad = length_bucket(max(lengths))
    d_pad = doc_bucket(max(c.num_docs for c in b_cfgs))
    real_tokens = sum(lengths)
    _BUCKET_MODELS.observe(len(idxs))
    _REAL_TOKENS.inc(real_tokens)
    _PADDED_TOKENS.inc(len(idxs) * n_pad - real_tokens)
    bcfg = batch_lib.batch_cfg(b_cfgs, d_pad)
    stacked_c = batch_lib.stack_corpora(b_corps, n_pad)
    stacked_s = None
    if states is not None:
        stacked_s = batch_lib.stack_states(bcfg, [states[i] for i in idxs], n_pad)
    out = sampler.run_many(bcfg, stacked_c, [gens[i] for i in idxs], num_sweeps,
                           states=stacked_s, lengths=lengths)
    return batch_lib.unstack_states(b_cfgs, b_corps, out)


def run_batched(
    sampler,
    cfgs: Sequence[LDAConfig],
    corpora: Sequence[Corpus],
    gens: Sequence[torch.Generator],
    num_sweeps: int,
    states: Optional[Sequence[LDAState]] = None,
    max_models: int = MAX_MODELS_PER_LAUNCH,
) -> tuple[list[LDAState], BatchStats]:
    """Fit (cold, `states=None`) or refit (warm) M models in as few
    launches as bucketing allows; returns per-model states in input order.

    `sampler` is any object with the `BatchedSampler.run_many` surface.
    Each model consumes its own generator, so results are comparable to M
    sequential runs from the same generators regardless of bucketing.
    """
    if not (len(cfgs) == len(corpora) == len(gens)):
        raise ValueError("cfgs, corpora and gens must align")
    if states is not None and len(states) != len(cfgs):
        raise ValueError("states must align with cfgs when given")
    buckets = plan_buckets(list(zip(cfgs, corpora)), max_models=max_models)
    out: list[Optional[LDAState]] = [None] * len(cfgs)
    for idxs in buckets:
        for i, st in zip(idxs, _run_bucket(
                sampler, idxs, cfgs, corpora, gens, num_sweeps, states)):
            out[i] = st
    return out, BatchStats(num_models=len(cfgs), num_launches=len(buckets))
