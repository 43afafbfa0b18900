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
  sparse  SparseLDA (Yao et al., 2009) sequential s/r/q-bucket sweep
          (`core.sparse`) in numpy on the host — the paper's phone-side
          sampler, the `device_kind="phone"` route; no kernel of
          `repro_torch.kernels` runs in it
  batched M compatible product models stacked into one run (`core.batch`):
          one batched Gibbs launch a sweep for all M
          (`kernels.lda_gibbs.ops.sweep_many`) — the route of multi-model
          fits and refits
  distributed
          client/server sharded sweep (`core.distributed`): the paper's
          "model cache and updating server" on a worker grid, with the
          (V, K) model fully replicated a worker (the small-grid oracle)
  pserver parameter-server fit tier (`repro_torch.pserver`): doc-sharded
          tokens, vocab-sharded word-topic state across the model axis,
          bounded-staleness support caches synced by sparse delta-row
          exchange — the `device_kind="pod"` route; on one card its W
          workers run stacked on a leading axis

The reference package's names stay valid as aliases — ``jnp`` is
``torch`` and ``pallas`` is ``cuda`` — so a reference client's requests
keep their meaning.

A backend with the stacked surface (`run_many(cfg, corpora, gens,
num_sweeps, states=None, lengths=None)`: a leading (M,) axis on every
`Corpus`/`LDAState` tensor, one generator per model, each model's real
token count) is what `serving.batch_engine` drives.

All backends speak *stored* `LDAState` at the boundary (fixed point when
``cfg.w_bits`` is set) so a model fit by one can be refined by another.
Backends run on the device of the corpus they are given; their
`torch.Generator` must be on that device too.

Every sweep runs inside a `sweep` span (`repro_torch.obs.trace`; attrs
`route` and `tokens`) and counts in `vedalia_sweeps_total{route}`. The
span is not device-timed: its events would sit at the sweep boundaries and
at the head and tail of each request, where they cost the device idle
time; the rebuild and the alias tables inside it are. An engine call that
runs n sweeps in one program (`pserver`'s fused run, `sparse`, the stacked
`run_many`) is one span with `sweeps` n, and counts n.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.codec import decode_state, encode_state
from repro_torch.core.types import Corpus, LDAConfig, LDAState, init_state
from repro_torch.obs import metrics, trace

_SWEEPS = metrics.counter(
    "vedalia_sweeps_total", "Sweeps run, by sampler route.", labels=("route",))


def _swept(route: str, corpus: Corpus, n: int = 1):
    """The `sweep` span around `n` sweeps of `route` over `corpus` (a
    stacked corpus counts every slot), counted in `vedalia_sweeps_total`."""
    _SWEEPS.inc(n, route=route)
    attrs = {} if n == 1 else {"sweeps": n}
    return trace.span("sweep", route=route, tokens=corpus.docs.numel(), **attrs)


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

        with _swept(self.name, corpus):
            return gibbs.sweep(cfg, state, corpus, gen, self.block)


#: The `QuantSpec` modes a packed-table sweep honors (`cuda`, `alias`).
PACKED_QUANT_MODES = ("f32", "fixed", "int8", "int4_packed")


@register_backend("cuda", SamplerCapabilities(device_kind="gpu",
                                              quant_modes=PACKED_QUANT_MODES))
class CudaSampler(_BaseSampler):
    """One kernel launch over all tokens a sweep (the plain version on
    CPU tensors). A packed `cfg.quant` (int8/int4_packed) takes the
    packed-table kernel, scoring against the word-topic table quantized
    once a sweep."""

    def sweep(self, cfg, state, corpus, gen):
        from repro_torch.kernels.lda_gibbs import ops as kops

        with _swept(self.name, corpus):
            return kops.sweep(cfg, state, corpus, gen)


@register_backend("distributed", SamplerCapabilities(device_kind="pod"))
class DistributedSampler(_BaseSampler):
    """Client/server sharded sweep (`core.distributed`) on a worker grid.

    Counts cross the boundary in stored units and are decoded/encoded
    here; the sharded sweep itself is real-valued float32. `workers` is a
    worker count or a `pserver.comm` seam (default: one worker). With one
    worker global doc ids are worker-local ids; with several, the caller
    contract of `core.distributed` applies (documents contiguously
    partitioned in blocks of ceil(num_docs / W), worker-local ids, token
    arrays padded a worker — `core.distributed.shard_corpus` builds that
    layout). The `pserver` backend does this partitioning itself and is
    the routed pod default; this backend remains the replicated
    small-grid oracle.
    """

    def __init__(self, workers=1, block: int = 4096, sync_every: int = 1):
        from repro_torch.pserver import comm

        self.comm = comm.make(workers)
        self.block = block
        self.sync_every = sync_every

    def sweep(self, cfg, state, corpus, gen):
        from repro_torch.core import distributed

        with _swept(self.name, corpus):
            real = decode_state(cfg, state)
            fn = distributed.make_client_server_sweep(cfg, self.comm, block=self.block,
                                                      sync_every=self.sync_every)
            z, n_dt, n_wt, n_t = fn(corpus.docs, corpus.words, real.z, corpus.weights,
                                    real.n_dt, real.n_wt, gen)
            return encode_state(cfg, LDAState(z=z, n_dt=n_dt, n_wt=n_wt, n_t=n_t))


@register_backend("pserver", SamplerCapabilities(device_kind="pod"))
class PServerSampler(_BaseSampler):
    """Parameter-server fit tier (`repro_torch.pserver`) — the routed pod
    path.

    Doc-sharded tokens across every worker, vocab-sharded authoritative
    word-topic state across the "model" axis, and bounded-staleness
    per-worker support caches synced by sparse delta-row exchange every
    `staleness` sweeps. Callers hand over a flat corpus with *global* doc
    ids; the tier plans its own contiguous partition (any corpus fits any
    grid). `workers` is an (n_data, n_model) grid of workers stacked on
    the corpus's device (default (1, 1)) or a `pserver.comm` seam. `local`
    picks the per-worker sweep engine: "gibbs" (`core.distributed.
    local_sweep`), "cuda" (one Gibbs kernel launch a sweep for all
    workers; the reference's "pallas" is accepted), "mh" (AliasLDA MH
    whose accept step absorbs the cache staleness), or "auto" (cuda on the
    card, gibbs on the CPU).
    """

    def __init__(self, workers=(1, 1), block: int = 4096, staleness: int = 1,
                 local: str = "auto", cap=None, mh_steps: int = 4):
        from repro_torch.pserver.sampler import PServerFit

        self._fit = PServerFit(workers=workers, block=block, staleness=staleness,
                               local=local, cap=cap, mh_steps=mh_steps)
        self.staleness = staleness

    def sweep(self, cfg, state, corpus, gen):
        with _swept(self.name, corpus):
            return self._fit.sweep(cfg, state, corpus, gen)

    def run(self, cfg, corpus, gen, num_sweeps, state=None):
        with _swept(self.name, corpus, num_sweeps):
            return self._fit.run(cfg, corpus, gen, num_sweeps, state=state)


@register_backend(
    "alias",
    SamplerCapabilities(device_kind="gpu", proposal_based=True,
                        quant_modes=PACKED_QUANT_MODES),
)
class AliasSampler(_BaseSampler):
    """AliasLDA sweep-parallel MH: stale per-word and per-doc alias
    proposals (Li et al.'s word/doc cycle), corrected by `mh_steps` MH
    rounds a sweep. Per-token cost is O(1) a round, independent of K, so
    this is the large-corpus fit path. Counts cross the boundary in stored
    units. Each sweep is `kernels.alias_mh.ops.mh_sweep`: one Hopper kernel
    launch on a CUDA corpus, its plain version on a CPU one; a packed
    `cfg.quant` builds the word proposals from, and scores against, the
    fake-quantized word-topic table. The stacked `run_many` keeps the exact
    path, as the reference's batched alias sweep does.
    """

    def __init__(self, mh_steps: int = 4):
        self.mh_steps = mh_steps

    def sweep(self, cfg, state, corpus, gen):
        from repro_torch.kernels.alias_mh import ops as kops

        with _swept(self.name, corpus):
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
        with _swept(self.name, corpora, num_sweeps):
            return alias.run_many(cfg, states, corpora, gens, num_sweeps, self.mh_steps,
                                  lengths)


@register_backend("sparse", SamplerCapabilities(device_kind="phone"))
class SparseSampler(_BaseSampler):
    """SparseLDA sequential s/r/q-bucket sweep (`core.sparse`).

    The paper's phone-side sampler as a first-class backend: exact
    sequential collapsed Gibbs in numpy, O(k_d + k_w) per token. Slow on
    large corpora by design — it models the mobile device — and the
    `device_kind="phone"` route of the `auto` selector. Its numpy seed is
    one draw from the caller's generator, so the same generator state gives
    the same chain; the state it returns is rebuilt from the final `z` on
    the corpus's device.
    """

    def __init__(self, dense: bool = False):
        self.dense = dense  # True => the O(k) MALLET-style baseline

    def _sequential(self, cfg, state, corpus, gen, num_sweeps):
        from repro_torch.core import codec, sparse

        cls = sparse.DenseGibbsSampler if self.dense else sparse.SparseLDASampler
        # Stored counts cross the boundary decoded, not rebuilt from
        # (z, weights): for incremental updates the corpus freezes old
        # tokens by zeroing their weights while their mass must keep
        # participating in the conditional.
        with _swept(self.name, corpus, num_sweeps):
            seed = int(torch.randint(0, np.iinfo(np.int32).max, (1,), generator=gen,
                                     device=gen.device))
            s = cls(
                cfg,
                codec.as_numpy(corpus.docs),
                codec.as_numpy(corpus.words),
                codec.as_numpy(state.z),
                weights=codec.as_numpy(corpus.weights).astype(np.float64),
                seed=seed,
                counts=codec.decode_counts_np(cfg, state),
            )
            s.run(num_sweeps)
            z = torch.as_tensor(s.z.astype(np.int32), device=corpus.device)
            return codec.rebuild_state(cfg, corpus, z)

    def sweep(self, cfg, state, corpus, gen):
        return self._sequential(cfg, state, corpus, gen, 1)

    def run(self, cfg, corpus, gen, num_sweeps, state=None):
        if state is None:
            state = encode_state(cfg, init_state(cfg, corpus, gen))
        # One sampler instance for the whole run: counts and bucket caches
        # are built once, not once per sweep.
        return self._sequential(cfg, state, corpus, gen, num_sweeps)


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

        with _swept(self.name, corpora):
            return batch.sweep_batch(cfg, states, corpora, gens, lengths)

    def run_many(self, cfg, corpora, gens, num_sweeps, states=None, lengths=None):
        """Batched multi-sweep fit/refit: cold when `states` is None."""
        from repro_torch.core import batch

        with _swept(self.name, corpora, num_sweeps):
            return batch.fit_many(cfg, corpora, gens, num_sweeps, states=states,
                                  lengths=lengths)

    def sweep(self, cfg, state, corpus, gen):
        return _unstack1(self.sweep_batch(cfg, _stack1(state), _stack1(corpus), [gen]))

    def run(self, cfg, corpus, gen, num_sweeps, state=None):
        return _unstack1(self.run_many(cfg, _stack1(corpus), [gen], num_sweeps,
                                       states=None if state is None else _stack1(state)))
