"""Pluggable Gibbs-sampler backends behind one `Sampler` protocol.

Every consumer of topic-model inference (the `VedaliaService` facade,
incremental `update`) talks to a `Sampler`; the sweep implementation is
chosen by name:

  torch   blocked parallel sweep (`core.gibbs`) — the oracle; on the card
          each block launches the Hopper kernel (⌈N/4096⌉ launches a sweep)
  cuda    single-launch kernel sweep (`kernels.lda_gibbs.ops.sweep`): one
          launch over all N tokens a sweep
  alias   AliasLDA (Li et al., 2014a) stale alias-table proposals + parallel
          Metropolis–Hastings (`kernels.alias_mh.ops.mh_sweep`): one launch
          a sweep — the route of large fits; its `run_many` runs M stacked
          models with one batched MH launch a sweep
  batched M compatible product models stacked into one run (`core.batch`):
          one batched Gibbs launch a sweep for all M
          (`kernels.lda_gibbs.ops.sweep_many`) — the route of multi-model
          fits and refits

The reference package's names stay valid as aliases — ``jnp`` is
``torch`` and ``pallas`` is ``cuda`` — so a reference client's requests
keep their meaning. Backends the reference routes to but this package
does not have yet (`sparse`, `pserver`, `distributed`) resolve, as the
reference's own fallback does, to the oracle.

A backend with the stacked surface (`run_many(cfg, corpora, gens,
num_sweeps, states=None, lengths=None)`: a leading (M,) axis on every
`Corpus`/`LDAState` tensor, one generator per model, each model's real
token count) is what `serving.batch_engine` drives.

All backends speak *stored* `LDAState` at the boundary (fixed point when
``cfg.w_bits`` is set) so a model fit by one can be refined by another.
Backends run on the device of the corpus they are given; their
`torch.Generator` must be on that device too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

import torch

from repro_torch.core.codec import encode_state
from repro_torch.core.types import Corpus, LDAConfig, LDAState, init_state


@dataclasses.dataclass(frozen=True)
class SamplerCapabilities:
    """What a backend can do — the routing metadata of the registry.

    warm_start:     accepts a prior `LDAState` and continues the chain.
    weighted:       honors fractional per-token weights (RLDA's ψ·c).
    device_kind:    the device class the schedule is designed for:
                    "gpu" (dense parallel sweeps on the card), "pod"
                    (sharded multi-host), "phone" (sequential).
    proposal_based: draws from a stale proposal corrected by MH rather
                    than the exact conditional.
    quant_modes:    the `QuantSpec` modes this backend honors in its hot
                    path; a packed-spec config still fits on the live
                    f32/fixed representation.
    """

    warm_start: bool = True
    weighted: bool = True
    device_kind: str = "gpu"
    proposal_based: bool = False
    quant_modes: tuple = ("f32", "fixed")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["quant_modes"] = list(self.quant_modes)
        return d


@runtime_checkable
class Sampler(Protocol):
    """One full-corpus collapsed-Gibbs sweep engine."""

    def sweep(self, cfg: LDAConfig, state: LDAState, corpus: Corpus,
              gen: torch.Generator) -> LDAState: ...

    def run(self, cfg: LDAConfig, corpus: Corpus, gen: torch.Generator,
            num_sweeps: int, state: Optional[LDAState] = None) -> LDAState: ...


_REGISTRY: dict[str, type] = {}

#: The reference package's backend names that mean a backend here.
ALIASES = {"jnp": "torch", "pallas": "cuda"}

#: The oracle: where a routed name this package lacks resolves.
ORACLE = "torch"

#: Pseudo-backend name resolved per workload by :func:`select_backend`.
AUTO = "auto"


def register_backend(name: str, capabilities: Optional[SamplerCapabilities] = None):
    """Class decorator: make `get_backend(name)` construct this sampler."""

    def deco(cls):
        cls.name = name
        if capabilities is not None:
            cls.capabilities = capabilities
        elif not hasattr(cls, "capabilities"):
            cls.capabilities = SamplerCapabilities()
        _REGISTRY[name] = cls
        return cls

    return deco


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def canonical(name: str) -> str:
    """A registered name, or an alias of one, -> the registered name."""
    return ALIASES.get(name, name)


def known_backend(name: str) -> bool:
    return canonical(name) in _REGISTRY


def backend_capabilities(name: Optional[str] = None):
    """Capabilities of one backend, or `{name: SamplerCapabilities}` for all."""
    if name is not None:
        try:
            return _REGISTRY[canonical(name)].capabilities
        except KeyError:
            raise KeyError(
                f"unknown sampler backend {name!r}; "
                f"available: {available_backends()}"
            ) from None
    return {n: cls.capabilities for n, cls in sorted(_REGISTRY.items())}


# Workload-size boundary above which the O(k_d)-per-token proposal sampler
# (alias) beats the dense parallel sweep's O(k) score tile.
_LARGE_CORPUS_TOKENS = 100_000


def select_backend(
    *,
    num_tokens: int = 0,
    task: str = "fit",
    device_kind: Optional[str] = None,
    available: Optional[list[str]] = None,
    num_models: int = 1,
) -> str:
    """Resolve the `"auto"` pseudo-backend for a workload.

    The reference's routing order (first match wins):
      1. multi-model work goes to the stacked `batched` sweep when one is
         built for the requested device class;
      2. an explicit `device_kind` picks the backend built for that device
         class ("phone" -> sparse, "pod" -> pserver, "gpu" -> torch);
      3. updates go to the oracle sweep;
      4. large fits go to the proposal sampler (`alias`);
      5. everything else gets the oracle.
    A candidate that is not available falls through to the oracle.
    """
    names = set(available if available is not None else available_backends())

    def pick(*candidates: str) -> str:
        for c in candidates:
            if c in names:
                return c
        return ORACLE

    if device_kind is not None:
        if num_models > 1:
            batched = _REGISTRY.get("batched")
            if ("batched" in names and batched is not None
                    and batched.capabilities.device_kind == device_kind):
                return "batched"
        preferred = {"phone": "sparse", "pod": "pserver", "gpu": ORACLE}
        want = preferred.get(device_kind)
        if want in names:
            return want
        for n in sorted(names):  # any backend built for that device class
            cls = _REGISTRY.get(n)  # `available` may list remote-only names
            if cls is not None and cls.capabilities.device_kind == device_kind:
                return n
        return pick(ORACLE)
    if num_models > 1:
        return pick("batched", ORACLE)
    if task == "update":
        return pick(ORACLE)
    if num_tokens >= _LARGE_CORPUS_TOKENS:
        return pick("alias", ORACLE)
    return pick(ORACLE)


def get_backend(name: str = ORACLE, **opts) -> Sampler:
    """Construct a registered sampler backend by name (or alias)."""
    try:
        cls = _REGISTRY[canonical(name)]
    except KeyError:
        raise KeyError(
            f"unknown sampler backend {name!r}; "
            f"available: {available_backends()}"
        ) from None
    return cls(**opts)


class _BaseSampler:
    """Default multi-sweep loop with `gibbs.run`'s discipline (init from
    the generator, then one sweep at a time on the same generator)."""

    def run(self, cfg, corpus, gen, num_sweeps, state=None):
        if state is None:
            state = encode_state(cfg, init_state(cfg, corpus, gen))
        for _ in range(num_sweeps):
            state = self.sweep(cfg, state, corpus, gen)
        return state

    def __repr__(self):
        return f"{type(self).__name__}(name={getattr(self, 'name', '?')!r})"


@register_backend("torch", SamplerCapabilities(device_kind="gpu"))
class TorchSampler(_BaseSampler):
    """The blocked parallel sweep — system path and parity oracle."""

    def __init__(self, block: int = 4096):
        self.block = block

    def sweep(self, cfg, state, corpus, gen):
        from repro_torch.core import gibbs

        return gibbs.sweep(cfg, state, corpus, gen, self.block)

    def run(self, cfg, corpus, gen, num_sweeps, state=None):
        from repro_torch.core import gibbs

        return gibbs.run(cfg, corpus, gen, num_sweeps, state=state, block=self.block)


@register_backend("cuda", SamplerCapabilities(device_kind="gpu"))
class CudaSampler(_BaseSampler):
    """One kernel launch over all tokens a sweep (the plain version on
    CPU tensors)."""

    def sweep(self, cfg, state, corpus, gen):
        from repro_torch.kernels.lda_gibbs import ops as kops

        return kops.sweep(cfg, state, corpus, gen)


@register_backend(
    "alias",
    SamplerCapabilities(device_kind="gpu", proposal_based=True,
                        quant_modes=("f32", "fixed")),
)
class AliasSampler(_BaseSampler):
    """AliasLDA sweep-parallel MH: stale per-word and per-doc alias
    proposals (Li et al.'s word/doc cycle), corrected by `mh_steps` MH
    rounds a sweep. Per-token cost is O(1) a round, independent of K, so
    this is the large-corpus fit path. Counts cross the boundary in stored
    units. Each sweep is `kernels.alias_mh.ops.mh_sweep`: one Hopper kernel
    launch on a CUDA corpus, its plain version on a CPU one.
    """

    def __init__(self, mh_steps: int = 4):
        self.mh_steps = mh_steps

    def sweep(self, cfg, state, corpus, gen):
        from repro_torch.kernels.alias_mh import ops as kops

        return kops.mh_sweep(cfg, state, corpus, gen, self.mh_steps)

    def run_many(self, cfg, corpora, gens, num_sweeps, states=None, lengths=None):
        """Stacked multi-sweep alias fit/refit (cold when `states` is None)
        over M models, one batched MH launch a sweep
        (`core.alias.run_many`); each model consumes its own generator as
        its single-model run would, so a batched run is comparable to M
        sequential `alias` runs from the same generators."""
        from repro_torch.core import alias, batch

        if states is None:
            states = batch.init_many(cfg, corpora, gens, lengths)
        return alias.run_many(cfg, states, corpora, gens, num_sweeps, self.mh_steps,
                              lengths)


def _stack1(x):
    """A corpus or state as an M = 1 stack."""
    return type(x)(*(getattr(x, f.name)[None] for f in dataclasses.fields(x)))


def _unstack1(x):
    return type(x)(*(getattr(x, f.name)[0] for f in dataclasses.fields(x)))


@register_backend("batched", SamplerCapabilities(device_kind="gpu"))
class BatchedSampler(_BaseSampler):
    """Multi-model batched sweep (`core.batch`): M compatible product
    models stacked into one run, one launch of the batched Gibbs kernel a
    sweep (its plain version on CPU tensors).

    The stacked surface is `run_many`/`sweep_batch` (a leading (M,) axis on
    every `Corpus`/`LDAState` tensor, one generator per model;
    `serving.batch_engine` does the bucketing and padding). The
    single-model `Sampler` protocol works too (an M = 1 stack), so
    `backend="batched"` is valid anywhere a backend name is accepted.
    """

    def sweep_batch(self, cfg, states, corpora, gens, lengths=None):
        """One sweep over stacked models (one generator per model)."""
        from repro_torch.core import batch

        return batch.sweep_batch(cfg, states, corpora, gens, lengths)

    def run_many(self, cfg, corpora, gens, num_sweeps, states=None, lengths=None):
        """Batched multi-sweep fit/refit: cold when `states` is None."""
        from repro_torch.core import batch

        return batch.fit_many(cfg, corpora, gens, num_sweeps, states=states,
                              lengths=lengths)

    def sweep(self, cfg, state, corpus, gen):
        return _unstack1(self.sweep_batch(cfg, _stack1(state), _stack1(corpus), [gen]))

    def run(self, cfg, corpus, gen, num_sweeps, state=None):
        return _unstack1(self.run_many(cfg, _stack1(corpus), [gen], num_sweeps,
                                       states=None if state is None else _stack1(state)))
