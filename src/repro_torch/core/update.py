"""Incremental model updating (paper §3.2).

New documents' tokens are initialized by sampling from the current
topic-word posterior (a warm start), appended to the corpus, and only
*their* tokens are resampled for a few sweeps (old tokens keep their
assignments — their counts still participate). Every `full_recompute_every`
updates, a full recompute (all tokens resampled from scratch) restores
quality.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import codec, gibbs
from repro_torch.core.types import Corpus, LDAConfig, LDAState
from repro_torch.kernels.lda_gibbs.ops import gumbel


@dataclasses.dataclass
class UpdatableModel:
    cfg: LDAConfig
    corpus: Corpus
    state: LDAState
    updates_since_recompute: int = 0
    full_recompute_every: int = 5


def _phi(cfg: LDAConfig, state: LDAState) -> torch.Tensor:
    n_wt = codec.decode_array(cfg, state.n_wt)
    n_t = codec.decode_array(cfg, state.n_t)
    return (n_wt + cfg.beta) / (n_t[None, :] + cfg.beta_bar)  # (V, K)


def add_documents(
    model: UpdatableModel,
    new_docs,
    new_words,
    new_weights,
    gen: torch.Generator,
    update_sweeps: int = 3,
    sampler=None,
    num_docs: int | None = None,
) -> UpdatableModel:
    """Append new reviews and incrementally resample only their tokens.

    `sampler` is any `repro_torch.api.backends.Sampler` (or a module
    exposing `sweep`/`run` with the same signatures); defaults to the
    blocked `core.gibbs` sweep. `num_docs` is the new total document
    count; when omitted it is inferred from the highest new doc id.
    `gen` draws on the model's device.
    """
    cfg, corpus, state = model.cfg, model.corpus, model.state
    device = corpus.device
    if sampler is None:
        sampler = gibbs

    new_docs = torch.as_tensor(np.asarray(new_docs, np.int32), device=device)
    new_words = torch.as_tensor(np.asarray(new_words, np.int32), device=device)
    new_weights = torch.as_tensor(np.asarray(new_weights, np.float32), device=device)
    num_new_docs = int(new_docs.max()) + 1 if new_docs.numel() else 0
    new_cfg = dataclasses.replace(
        cfg, num_docs=max(cfg.num_docs, num_new_docs, num_docs or 0))

    # Warm-start z for new tokens from the current word posterior φ̂
    # (a categorical draw, by Gumbel-max).
    logits = torch.log(_phi(cfg, state)[new_words] + 1e-30)  # (n_new, K)
    z_new = torch.argmax(logits + gumbel(logits.shape, gen, device), dim=-1).to(state.z.dtype)

    merged = Corpus(
        docs=torch.cat([corpus.docs, new_docs]),
        words=torch.cat([corpus.words, new_words]),
        weights=torch.cat([corpus.weights, new_weights]),
    )
    z_all = torch.cat([state.z, z_new])
    merged_state = codec.rebuild_state(new_cfg, merged, z_all)

    updates = model.updates_since_recompute + 1
    if updates >= model.full_recompute_every:
        # Periodic full recompute (all tokens, from fresh init).
        state_out = sampler.run(new_cfg, merged, gen, num_sweeps=update_sweeps * 3)
        updates = 0
    else:
        # Incremental: resample only the new tokens (old tokens' weights are
        # 0 while resampling, but their counts stay in the state).
        mask = torch.cat([torch.zeros_like(corpus.weights), torch.ones_like(new_weights)])
        frozen = Corpus(docs=merged.docs, words=merged.words, weights=merged.weights * mask)
        st = merged_state
        for _ in range(update_sweeps):
            # Resample new tokens against full counts; rebuild from the
            # merged corpus so old tokens keep contributing their weights.
            z_step = sampler.sweep(new_cfg, st, frozen, gen).z
            z_keep = torch.where(mask > 0, z_step, st.z)
            st = codec.rebuild_state(new_cfg, merged, z_keep)
        state_out = st

    return UpdatableModel(
        cfg=new_cfg,
        corpus=merged,
        state=state_out,
        updates_since_recompute=updates,
        full_recompute_every=model.full_recompute_every,
    )
