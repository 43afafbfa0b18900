"""Core data structures for LDA / RLDA.

The corpus is stored in flat token-parallel form (``docs[i]``, ``words[i]``,
``z[i]``, ``weights[i]``), the layout the sampler kernels index by token.
Counts live in an :class:`LDAState`; they are real-valued float32 or
fixed-point int32 (paper §4.3 approximate weighting, ``w_bits``).

`from_reference` / `to_numpy` carry a model across from (and back to) the
JAX package's numpy leaves with identical dtypes: int32 ids and
assignments, float32 weights, int32 fixed-point or float32 counts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.quant import QuantSpec


@dataclasses.dataclass(frozen=True)
class LDAConfig:
    """Hyperparameters of (R)LDA.

    alpha/beta are the symmetric Dirichlet concentration parameters of the
    doc-topic and topic-word distributions (paper Eq. 1-2).
    """

    num_topics: int
    vocab_size: int
    num_docs: int
    alpha: float = 0.1
    beta: float = 0.01
    # Fixed-point fractional counts (paper §4.3): None => float32 counts.
    w_bits: Optional[int] = None
    # Full representation spec (core.quant). None => derive from w_bits.
    quant: Optional[QuantSpec] = None

    @property
    def quant_spec(self) -> QuantSpec:
        """The resolved `QuantSpec` (explicit `quant`, else `w_bits`)."""
        if self.quant is not None:
            return self.quant
        return QuantSpec.from_w_bits(self.w_bits)

    @property
    def beta_bar(self) -> float:
        """Joint normalizer  β̄ = Σ_w β_w  (symmetric prior)."""
        return self.beta * self.vocab_size


@dataclasses.dataclass
class Corpus:
    """Flat token-parallel corpus.

    Attributes:
      docs:    (N,) int32 document id per token.
      words:   (N,) int32 word id per token (already rating-augmented for RLDA).
      weights: (N,) float32 per-token fractional weight (ψ_d · c_{d,tier});
               0.0 marks padding / frozen tokens.
    """

    docs: torch.Tensor
    words: torch.Tensor
    weights: torch.Tensor

    @property
    def num_tokens(self) -> int:
        return int(self.docs.shape[0])

    @property
    def device(self) -> torch.device:
        return self.docs.device

    def to(self, device) -> "Corpus":
        return Corpus(*(t.to(device) for t in (self.docs, self.words, self.weights)))


@dataclasses.dataclass
class LDAState:
    """Collapsed-Gibbs sufficient statistics + assignments.

    n_dt: (D, K) doc-topic counts, n_wt: (V, K) word-topic counts,
    n_t: (K,) topic totals, z: (N,) int32 current topic per token.
    Counts are float32 (real units) or int32 (fixed point, see fractional.py).
    """

    z: torch.Tensor
    n_dt: torch.Tensor
    n_wt: torch.Tensor
    n_t: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.z.device

    def to(self, device) -> "LDAState":
        return LDAState(*(t.to(device) for t in (self.z, self.n_dt, self.n_wt, self.n_t)))


def _scatter_rows(rows: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  num_rows: int, k: int) -> torch.Tensor:
    """(num_rows, K) table of Σ w over tokens with (row, z) — a scatter-add
    on the flat index row*K + z. A stack of M models, (M, N) ids, gives an
    (M, num_rows, K) table from ONE scatter on ((m*num_rows + row)*K + z),
    taken model-major. On the CPU `index_add_` adds in token order, as the
    reference's scatter does, so each model's sums come out as its own
    rebuild's; on CUDA it adds with atomics, in an order that varies from
    run to run."""
    flat = rows.to(torch.int64) * k + z.to(torch.int64)
    if rows.dim() == 2:
        first = torch.arange(rows.shape[0], device=rows.device) * (num_rows * k)
        flat = flat + first[:, None]
    out = torch.zeros(rows.shape[:-1].numel() * num_rows * k, dtype=w.dtype,
                      device=w.device)
    out.index_add_(0, flat.reshape(-1), w.reshape(-1))
    return out.view(*rows.shape[:-1], num_rows, k)


def build_counts(cfg: LDAConfig, corpus: Corpus, z: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> LDAState:
    """Rebuild all count tensors from assignments by scatter-add. A corpus
    and z with a leading (M,) model axis (a stack, `core.batch`) rebuild
    all M models at once, with `cfg.num_docs` the padded per-model
    document capacity."""
    w = corpus.weights.to(dtype)
    k = cfg.num_topics
    n_dt = _scatter_rows(corpus.docs, z, w, cfg.num_docs, k)
    n_wt = _scatter_rows(corpus.words, z, w, cfg.vocab_size, k)
    n_t = n_wt.sum(dim=-2)
    return LDAState(z=z, n_dt=n_dt, n_wt=n_wt, n_t=n_t)


def init_state(cfg: LDAConfig, corpus: Corpus, gen: torch.Generator) -> LDAState:
    """Uniform-random topic initialization (standard collapsed-Gibbs init).
    `gen` must live on the corpus's device."""
    z0 = torch.randint(0, cfg.num_topics, (corpus.num_tokens,), generator=gen,
                       device=corpus.device, dtype=torch.int32)
    return build_counts(cfg, corpus, z0)


def corpus_from_numpy(docs, words, weights, *, device) -> Corpus:
    """numpy token arrays -> a Corpus on `device` (int32 ids, float32 weights)."""
    return Corpus(
        docs=torch.tensor(np.asarray(docs, np.int32), device=device),
        words=torch.tensor(np.asarray(words, np.int32), device=device),
        weights=torch.tensor(np.asarray(weights, np.float32), device=device),
    )


_CFG_FIELDS = ("num_topics", "vocab_size", "num_docs", "alpha", "beta", "w_bits")
_CORPUS_FIELDS = ("docs", "words", "weights")
_STATE_FIELDS = ("z", "n_dt", "n_wt", "n_t")


def from_reference(cfg_fields: dict, corpus_arrays: dict, state_arrays: dict,
                   device) -> tuple[LDAConfig, Corpus, LDAState]:
    """A model of the JAX package, as numpy leaves, -> this package's
    `(LDAConfig, Corpus, LDAState)` on `device`.

    `cfg_fields` holds the reference config's scalar fields (a packed
    `quant` spec, if any, as its mode string under ``"quant"``);
    `corpus_arrays` / `state_arrays` map leaf names to arrays. Dtypes are
    kept: int32 `docs`/`words`/`z`, float32 weights, and int32 fixed-point
    or float32 counts.
    """
    quant = cfg_fields.get("quant")
    cfg = LDAConfig(
        **{f: cfg_fields[f] for f in _CFG_FIELDS if f in cfg_fields},
        quant=None if quant is None else QuantSpec(mode=quant, w_bits=cfg_fields.get("w_bits")),
    )
    corpus = corpus_from_numpy(*(corpus_arrays[f] for f in _CORPUS_FIELDS), device=device)
    leaves = {}
    for f in _STATE_FIELDS:
        a = np.asarray(state_arrays[f])
        if a.dtype not in (np.int32, np.float32):
            raise ValueError(f"state leaf {f} has dtype {a.dtype}; want int32 or float32")
        leaves[f] = torch.tensor(a, device=device)
    return cfg, corpus, LDAState(**leaves)


def to_numpy(cfg: LDAConfig, corpus: Corpus, state: LDAState) -> tuple[dict, dict, dict]:
    """The inverse of `from_reference`: numpy leaves a JAX-side
    `LDAConfig(**cfg_fields)` / `Corpus` / `LDAState` can be built from."""
    cfg_fields = {f: getattr(cfg, f) for f in _CFG_FIELDS}
    if cfg.quant is not None:
        cfg_fields["quant"] = cfg.quant.mode
    corpus_arrays = {f: getattr(corpus, f).detach().cpu().numpy() for f in _CORPUS_FIELDS}
    state_arrays = {f: getattr(state, f).detach().cpu().numpy() for f in _STATE_FIELDS}
    return cfg_fields, corpus_arrays, state_arrays
