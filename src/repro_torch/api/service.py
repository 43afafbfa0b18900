"""`VedaliaService` — the one public facade over the paper's system (§3-§5).

Reviews stream in, RLDA models are fit and incrementally updated, and
bandwidth-frugal model views stream out:

    rlda.prepare -> <sampler backend>.run -> update.add_documents
                 -> coreset.select_core_set -> views.build_view

    fit(reviews)            -> ModelHandle
    fit_batch(review_sets)  -> [ModelHandle]    (one model per product)
    refine_many(handles, n) -> [ModelHandle]    (coalesced warm refits)
    update(handle, reviews) -> UpdateResponse   (incremental, §3.2)
    view(handle)            -> ViewResponse     (streamed payload, §4.2)
    top_reviews(handle, t)  -> TopReviewsResponse (ViewPager order, §3.4)

Every served model lives on the service's device: CUDA unless the caller
asks for ``device="cpu"``. Randomness comes from a `torch.Generator` on
that device, seeded with the integer the reference would turn into a key
(`seed`, or ``seed*1_000_003 + op`` per operation). The multi-model verbs
give model i of a batch its own generator, seeded ``seed + i`` when a seed
is given (the reference's own sequential-fallback seeds), so a batched fit
and M sequential fits from those seeds are the same chains.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api.backends import AUTO, ORACLE, Sampler, canonical, get_backend, select_backend
from repro_torch.core import codec, coreset, perplexity as perplexity_lib, rlda, update
from repro_torch.core import views as views_lib
from repro_torch.core.rlda import Review, RLDACorpus
from repro_torch.core.types import LDAState
from repro_torch.core.views import ModelView
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import metrics, timers, trace

#: Backend-labelled service-op latency. Device ops (`fit`, `refine`,
#: `update`) stop via `DeviceTimer.sync(state)` so async launches can't
#: fake a fast sampler.
_OP_SECONDS = metrics.histogram(
    "vedalia_service_op_seconds",
    "Service operation latency by op and sampler backend.",
    labels=("op", "backend"))
_VIEW_BYTES = metrics.histogram(
    "vedalia_service_view_bytes",
    "Serialized view payload size (what a device downloads).",
    labels=(), buckets=metrics.BYTE_BUCKETS)


@contextlib.contextmanager
def _op(op: str, backend: str, **attrs):
    """One service op's `service.<op>` span (attrs `backend`, `sweeps`,
    `tokens`) and its `_OP_SECONDS` timer.

    The body hands the op's output to the yielded `wait`. The timer then
    waits for the output's device work (only while obs is on:
    `DeviceTimer.sync`) and the device-timed spans inside resolve, both
    inside the span, so the span covers all the host time the op costs. A
    host-side op hands nothing and stops unsynced. The span itself is not
    device-timed: events recorded before the op's first launch and read
    after its synchronize would lengthen the time the device waits between
    requests.
    """
    timer = timers.DeviceTimer(_OP_SECONDS, op=op, backend=backend)
    out = []
    with trace.span(f"service.{op}", backend=backend, **attrs):
        timer.start()
        yield out.append
        timer.sync(out[0] if out else None)
        trace.resolve()


@dataclasses.dataclass(frozen=True)
class FitRequest:
    """A fit task (the queue item of `serving.TopicEngine`)."""

    uid: int
    reviews: Sequence[Review]
    num_topics: int = 12
    base_vocab: Optional[int] = None  # None => inferred from the reviews
    alpha: float = 0.1
    beta: float = 0.01
    w_bits: Optional[int] = 8
    backend: Optional[str] = None  # None => the service default
    num_sweeps: Optional[int] = None
    top_n: int = 10  # used by TopicEngine's fit+view serving


@dataclasses.dataclass
class ModelHandle:
    """A served topic model: prepared corpus metadata + live sampler state.

    `prep` grows with every `update` (helpfulness/rating metadata must cover
    the appended reviews so views stay computable).
    """

    handle_id: int
    prep: RLDACorpus
    model: update.UpdatableModel
    backend: str
    sweeps_run: int = 0

    @property
    def cfg(self):
        return self.model.cfg

    @property
    def state(self) -> LDAState:
        return self.model.state

    @property
    def num_reviews(self) -> int:
        return self.model.cfg.num_docs


@dataclasses.dataclass(frozen=True)
class UpdateResponse:
    handle_id: int
    num_new_reviews: int
    kind: str  # "incremental" | "full_recompute"
    perplexity: float


@dataclasses.dataclass(frozen=True)
class ViewResponse:
    handle_id: int
    view: ModelView
    topic_ids: list[int]
    payload: str  # the JSON actually streamed to a device
    valid: bool  # Chital validation stage (§2.5.5)

    @property
    def payload_bytes(self) -> int:
        return len(self.payload)


@dataclasses.dataclass(frozen=True)
class TopReviewsResponse:
    handle_id: int
    topic_id: int
    review_ids: list[int]


@dataclasses.dataclass(frozen=True)
class SpotCheckResponse:
    """Outcome of the server-side check of a device-computed state.

    `state_perplexity` is the server's own recomputation on the submitted
    state; `post_perplexity` is the perplexity after `num_sweeps` of
    server-side re-Gibbs on a throwaway copy; `deviation` is the relative
    gap between the claimed and recomputed perplexity, when claimed.
    """

    valid: bool
    reason: str
    state_perplexity: Optional[float] = None
    post_perplexity: Optional[float] = None
    deviation: Optional[float] = None


def _infer_base_vocab(reviews: Sequence[Review]) -> int:
    hi = 0
    for r in reviews:
        if len(r.tokens):
            hi = max(hi, int(np.max(r.tokens)))
    return hi + 1


class VedaliaService:
    """Fit / update / view topic models through pluggable sampler backends."""

    def __init__(
        self,
        *,
        backend: str = ORACLE,
        num_sweeps: int = 30,
        update_sweeps: int = 3,
        backend_opts: Optional[dict] = None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.default_backend = backend
        self.num_sweeps = num_sweeps
        self.update_sweeps = update_sweeps
        self._backend_opts = dict(backend_opts or {})
        self._samplers: dict[str, Sampler] = {}
        self._seed = seed
        self._op = 0
        self.handles: dict[int, ModelHandle] = {}
        self._next_id = 0

    # -- internals ---------------------------------------------------------

    def sampler(self, name: Optional[str] = None) -> Sampler:
        """The (cached) sampler backend instance for `name`."""
        name = name or self.default_backend
        if name == AUTO:  # no workload context here: the generic route
            name = select_backend()
        name = canonical(name)
        if name not in self._samplers:
            self._samplers[name] = get_backend(
                name, **self._backend_opts.get(name, {}))
        return self._samplers[name]

    def _resolve(
        self,
        backend: Optional[str],
        *,
        num_tokens: int,
        task: str,
        device_kind: Optional[str] = None,
        num_models: int = 1,
    ) -> str:
        """Concrete backend name for a call (routes the `auto` pseudo-backend
        by workload: corpus size, fit-vs-update, device kind, model count)."""
        backend = backend or self.default_backend
        if backend == AUTO:
            backend = select_backend(
                num_tokens=num_tokens, task=task, device_kind=device_kind,
                num_models=num_models)
        return canonical(backend)

    def _generator(self, seed: Optional[int] = None) -> torch.Generator:
        """A generator on the service's device, seeded as the reference
        seeds its per-op key."""
        if seed is None:
            self._op += 1
            seed = self._seed * 1_000_003 + self._op
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _generators(self, m: int, seed: Optional[int] = None) -> list[torch.Generator]:
        """One independent generator per model of a batch: seeded
        ``seed + i`` when a seed is given, else each a fresh
        `_generator()`."""
        if seed is not None:
            return [self._generator(seed + i) for i in range(m)]
        return [self._generator() for _ in range(m)]

    def _register(self, handle: ModelHandle) -> ModelHandle:
        self.handles[handle.handle_id] = handle
        return handle

    def _new_id(self) -> int:
        hid = self._next_id
        self._next_id += 1
        return hid

    def prepare(self, reviews: Sequence[Review], **kwargs) -> RLDACorpus:
        """`rlda.prepare` with the corpus on the service's device."""
        return rlda.prepare(list(reviews), device=self.device, **kwargs)

    # -- fit ---------------------------------------------------------------

    def fit(
        self,
        reviews: Sequence[Review],
        *,
        num_topics: int = 12,
        base_vocab: Optional[int] = None,
        alpha: float = 0.1,
        beta: float = 0.01,
        w_bits: Optional[int] = 8,
        backend: Optional[str] = None,
        num_sweeps: Optional[int] = None,
        seed: Optional[int] = None,
        device_kind: Optional[str] = None,
    ) -> ModelHandle:
        """Prepare raw reviews (§4.3 transformation) and fit from scratch."""
        if not len(reviews):
            raise ValueError("fit() needs at least one review")
        if base_vocab is None:
            base_vocab = _infer_base_vocab(reviews)
        prep = self.prepare(reviews, base_vocab=base_vocab, num_topics=num_topics,
                            alpha=alpha, beta=beta, w_bits=w_bits)
        return self.fit_prepared(
            prep, backend=backend, num_sweeps=num_sweeps, seed=seed,
            device_kind=device_kind)

    def fit_prepared(
        self,
        prep: RLDACorpus,
        *,
        backend: Optional[str] = None,
        num_sweeps: Optional[int] = None,
        seed: Optional[int] = None,
        device_kind: Optional[str] = None,
    ) -> ModelHandle:
        """Fit an already-prepared RLDA corpus (moved to the service's
        device if it is not there)."""
        prep = self._on_device(prep)
        backend = self._resolve(
            backend, num_tokens=prep.corpus.num_tokens, task="fit",
            device_kind=device_kind)
        sweeps = num_sweeps if num_sweeps is not None else self.num_sweeps
        with _op("fit", backend, sweeps=sweeps,
                 tokens=prep.corpus.num_tokens) as wait:
            state = self.sampler(backend).run(
                prep.cfg, prep.corpus, self._generator(seed), sweeps)
            wait(state.n_wt)
        model = update.UpdatableModel(
            cfg=prep.cfg, corpus=prep.corpus, state=state)
        return self._register(ModelHandle(
            handle_id=self._new_id(), prep=prep, model=model,
            backend=backend, sweeps_run=sweeps))

    def fit_batch(
        self,
        review_sets: Sequence[Sequence[Review]],
        *,
        num_topics: int = 12,
        base_vocab: Optional[int] = None,
        alpha: float = 0.1,
        beta: float = 0.01,
        w_bits: Optional[int] = 8,
        backend: Optional[str] = None,
        num_sweeps: Optional[int] = None,
        seed: Optional[int] = None,
        device_kind: Optional[str] = None,
    ) -> list[ModelHandle]:
        """Fit one model per review set — batched into as few sampler
        launches as bucketing allows (`serving.batch_engine`).

        All sets share the fit parameters, so the prepared models are
        stack-compatible by construction; a `base_vocab` of None is
        inferred over *all* sets jointly (per-set inference would make the
        models vocabulary-incompatible).
        """
        if not len(review_sets):
            raise ValueError("fit_batch() needs at least one review set")
        for i, rs in enumerate(review_sets):
            if not len(rs):
                raise ValueError(f"fit_batch() review set {i} is empty")
        if base_vocab is None:
            base_vocab = max(_infer_base_vocab(rs) for rs in review_sets)
        preps = [
            self.prepare(rs, base_vocab=base_vocab, num_topics=num_topics,
                         alpha=alpha, beta=beta, w_bits=w_bits)
            for rs in review_sets
        ]
        return self.fit_batch_prepared(
            preps, backend=backend, num_sweeps=num_sweeps, seed=seed,
            device_kind=device_kind)

    def fit_batch_prepared(
        self,
        preps: Sequence[RLDACorpus],
        *,
        backend: Optional[str] = None,
        num_sweeps: Optional[int] = None,
        seed: Optional[int] = None,
        device_kind: Optional[str] = None,
    ) -> list[ModelHandle]:
        """Batched fit of already-prepared corpora (one handle each).

        The `auto` route resolves multi-model fits to the `batched`
        backend. Any resolved backend whose sampler carries the stacked
        `run_many` surface (`batched`, `alias`) runs through
        `serving.batch_engine`; other backends (or a single model) fall
        back to sequential `fit_prepared` calls with seeds ``seed + i``.
        """
        if not len(preps):
            raise ValueError("fit_batch_prepared() needs at least one corpus")
        preps = [self._on_device(p) for p in preps]
        total_tokens = sum(p.corpus.num_tokens for p in preps)
        backend = self._resolve(
            backend, num_tokens=total_tokens, task="fit",
            device_kind=device_kind, num_models=len(preps))
        sampler = self.sampler(backend)
        if len(preps) == 1 or not hasattr(sampler, "run_many"):
            return [
                self.fit_prepared(p, backend=backend, num_sweeps=num_sweeps,
                                  seed=seed if seed is None else seed + i)
                for i, p in enumerate(preps)
            ]
        from repro_torch.serving import batch_engine

        sweeps = num_sweeps if num_sweeps is not None else self.num_sweeps
        with _op("fit_batch", backend, sweeps=sweeps,
                 tokens=total_tokens) as wait:
            states, _ = batch_engine.run_batched(
                sampler, [p.cfg for p in preps], [p.corpus for p in preps],
                self._generators(len(preps), seed), sweeps)
            wait(states[-1].n_wt)
        return [
            self._register(ModelHandle(
                handle_id=self._new_id(), prep=p,
                model=update.UpdatableModel(cfg=p.cfg, corpus=p.corpus, state=st),
                backend=backend, sweeps_run=sweeps))
            for p, st in zip(preps, states)
        ]

    def _on_device(self, prep: RLDACorpus) -> RLDACorpus:
        if prep.corpus.device == self.device:
            return prep
        return dataclasses.replace(prep, corpus=prep.corpus.to(self.device))

    def adopt(
        self,
        prep: RLDACorpus,
        state: LDAState,
        *,
        backend: Optional[str] = None,
        sweeps_run: int = 0,
    ) -> ModelHandle:
        """Wrap an externally-fitted state into a served handle."""
        prep = self._on_device(prep)
        model = update.UpdatableModel(
            cfg=prep.cfg, corpus=prep.corpus, state=state.to(self.device))
        return self._register(ModelHandle(
            handle_id=self._new_id(), prep=prep, model=model,
            backend=self._resolve(
                backend, num_tokens=prep.corpus.num_tokens, task="update"),
            sweeps_run=sweeps_run))

    def refine(
        self,
        handle: ModelHandle,
        num_sweeps: int,
        *,
        backend: Optional[str] = None,
        seed: Optional[int] = None,
    ) -> ModelHandle:
        """Continue sampling the handle's model (any backend, warm state)."""
        backend = self._resolve(
            backend or handle.backend,
            num_tokens=handle.model.corpus.num_tokens, task="update")
        with _op("refine", backend, sweeps=num_sweeps,
                 tokens=handle.model.corpus.num_tokens) as wait:
            handle.model.state = self.sampler(backend).run(
                handle.cfg, handle.model.corpus, self._generator(seed), num_sweeps,
                state=handle.model.state)
            wait(handle.model.state.n_wt)
        handle.sweeps_run += num_sweeps
        handle.backend = backend
        return handle

    def refine_many(
        self,
        handles: Sequence[ModelHandle],
        num_sweeps: int,
        *,
        backend: Optional[str] = None,
        seed: Optional[int] = None,
    ) -> list[ModelHandle]:
        """Warm-refit several served models at once.

        `backend=None` takes the service default, not each handle's own
        (as the reference does): the `auto` route resolves multi-model
        refits to `batched`. A resolved backend with the stacked `run_many`
        surface (`batched`, `alias`) continues the handles' chains in
        bucketed stacked runs (`serving.batch_engine`) instead of N
        sequential `refine` calls; a backend without it, or a single
        handle, falls back to per-handle `refine` with seeds ``seed + i``.
        """
        handles = list(handles)
        if not handles:
            return handles
        # Dedup repeated handles (same served model named twice): each model
        # runs its sweeps once, not one stacked slot per mention.
        unique = list({h.handle_id: h for h in handles}.values())
        backend = self._resolve(
            backend,
            num_tokens=max(h.model.corpus.num_tokens for h in unique),
            task="update", num_models=len(unique))
        sampler = self.sampler(backend)
        if len(unique) == 1 or not hasattr(sampler, "run_many"):
            for i, h in enumerate(unique):
                self.refine(h, num_sweeps, backend=backend,
                            seed=seed if seed is None else seed + i)
            return handles
        from repro_torch.serving import batch_engine

        with _op("refine_many", backend, sweeps=num_sweeps,
                 tokens=sum(h.model.corpus.num_tokens for h in unique)) as wait:
            states, _ = batch_engine.run_batched(
                sampler, [h.cfg for h in unique], [h.model.corpus for h in unique],
                self._generators(len(unique), seed), num_sweeps,
                states=[h.model.state for h in unique])
            wait(states[-1].n_wt)
        for h, st in zip(unique, states):
            h.model.state = st
            h.sweeps_run += num_sweeps
            h.backend = backend
        return handles

    # -- update (§3.2) -----------------------------------------------------

    def update(
        self,
        handle: ModelHandle,
        new_reviews: Sequence[Review],
        *,
        update_sweeps: Optional[int] = None,
        seed: Optional[int] = None,
        backend: Optional[str] = None,
    ) -> UpdateResponse:
        """Add reviews to a served model: incremental resampling of the new
        tokens, with the periodic full recompute of §3.2."""
        if not len(new_reviews):
            raise ValueError("update() needs at least one new review")
        prep, cfg = handle.prep, handle.cfg
        prep_new = rlda.prepare(
            list(new_reviews), base_vocab=prep.base_vocab,
            num_topics=cfg.num_topics, alpha=cfg.alpha, beta=cfg.beta,
            w_bits=cfg.w_bits, device="cpu")

        backend = self._resolve(
            backend or handle.backend,
            num_tokens=handle.model.corpus.num_tokens, task="update")
        handle.backend = backend
        sweeps = update_sweeps if update_sweeps is not None else self.update_sweeps
        tokens = handle.model.corpus.num_tokens + prep_new.corpus.num_tokens
        with _op("update", backend, sweeps=sweeps, tokens=tokens) as wait:
            handle.model = update.add_documents(
                handle.model,
                prep_new.corpus.docs.numpy() + cfg.num_docs,
                prep_new.corpus.words.numpy(),
                prep_new.corpus.weights.numpy(),
                self._generator(seed),
                update_sweeps=sweeps,
                sampler=self.sampler(backend),
                # Explicit: token-free trailing reviews still count as docs.
                num_docs=cfg.num_docs + len(new_reviews),
            )
            wait(handle.model.state.n_wt)
        # Corpus and per-review metadata must cover the appended documents.
        handle.prep = dataclasses.replace(
            prep,
            cfg=handle.model.cfg,
            corpus=handle.model.corpus,
            psi=np.concatenate([prep.psi, prep_new.psi]),
            tiers=np.concatenate([prep.tiers, prep_new.tiers]),
            tier_probs=np.concatenate([prep.tier_probs, prep_new.tier_probs]),
            ratings=np.concatenate([prep.ratings, prep_new.ratings]),
            helpful=np.concatenate([prep.helpful, prep_new.helpful]),
            unhelpful=np.concatenate([prep.unhelpful, prep_new.unhelpful]),
        )
        kind = ("full_recompute"
                if handle.model.updates_since_recompute == 0 else
                "incremental")
        return UpdateResponse(
            handle_id=handle.handle_id,
            num_new_reviews=len(new_reviews),
            kind=kind,
            perplexity=self.perplexity(handle),
        )

    # -- serving (§4.2, §3.4) ----------------------------------------------

    def view(
        self,
        handle: ModelHandle,
        topics: Optional[Sequence[int]] = None,
        top_n: int = 10,
        *,
        mass_coverage: float = 0.9,
        max_topics: Optional[int] = None,
    ) -> ViewResponse:
        """The streamed model view. `topics=None` selects the core set
        (§3.3); the response carries the JSON payload a device receives."""
        if topics is None:
            core, _ = coreset.select_core_set(
                handle.cfg, handle.state,
                mass_coverage=mass_coverage, max_topics=max_topics)
            topics = core
        # host-side op: nothing async to wait out
        with _op("view", handle.backend, sweeps=0,
                 tokens=handle.model.corpus.num_tokens):
            topic_ids = [int(t) for t in topics]
            view = views_lib.build_view(
                handle.prep, handle.state, topic_ids, top_n=top_n)
            payload = view.to_json()
        _VIEW_BYTES.observe(len(payload))
        return ViewResponse(
            handle_id=handle.handle_id,
            view=view,
            topic_ids=topic_ids,
            payload=payload,
            valid=view.validate(),
        )

    def top_reviews(
        self, handle: ModelHandle, topic_id: int, n: int = 5
    ) -> TopReviewsResponse:
        ids = views_lib.top_reviews_for_topic(
            handle.prep, handle.state, int(topic_id), n=n)
        return TopReviewsResponse(
            handle_id=handle.handle_id, topic_id=int(topic_id),
            review_ids=ids)

    def perplexity(self, handle: ModelHandle) -> float:
        return float(perplexity_lib.perplexity(
            handle.cfg, handle.state, handle.model.corpus))

    def heldout_perplexity(
        self, handle: ModelHandle, reviews: Sequence[Review]
    ) -> float:
        """Perplexity of *unseen* reviews under the handle's current model:
        tokens are scored under the posterior-predictive mixture with the
        corpus-wide topic weights, p(w) = Σ_t θ̄_t φ̂_tw, θ̄_t ∝ n_t + α."""
        if not len(reviews):
            raise ValueError("heldout_perplexity() needs at least one review")
        cfg = handle.cfg
        prep = rlda.prepare(
            list(reviews), base_vocab=handle.prep.base_vocab,
            num_topics=cfg.num_topics, alpha=cfg.alpha, beta=cfg.beta,
            w_bits=cfg.w_bits, device="cpu")
        sc = codec.codec_for(cfg)
        n_wt = sc.decode_array_np(handle.state.n_wt)  # (V, K)
        n_t = sc.decode_array_np(handle.state.n_t)  # (K,)
        phi = (n_wt + cfg.beta) / (n_t[None, :] + cfg.beta_bar)
        theta_bar = (n_t + cfg.alpha) / (n_t.sum() + cfg.alpha * cfg.num_topics)
        words = prep.corpus.words.numpy()
        wts = prep.corpus.weights.numpy().astype(np.float64)
        p = phi[words] @ theta_bar  # (N,)
        ll = float(np.sum(wts * np.log(np.maximum(p, 1e-30))))
        return float(np.exp(-ll / max(wts.sum(), 1e-9)))

    # -- offload tier (§2.5.5 server-side checks) ---------------------------

    def validate_state(
        self, handle: ModelHandle, state: LDAState, *, count_tol: float = 2.0
    ) -> tuple[bool, str]:
        """Structural validation of an externally-computed state against the
        handle's corpus: shapes, z in `[0, K)`, finite counts, and counts
        consistent with a scatter-rebuild from `(corpus, z)` within
        `count_tol` stored units."""
        cfg, corpus = handle.cfg, handle.model.corpus
        z = codec.as_numpy(state.z)
        if z.shape != (corpus.num_tokens,):
            return False, (f"z has shape {z.shape}; corpus needs "
                           f"{(corpus.num_tokens,)}")
        if not np.issubdtype(z.dtype, np.integer):
            return False, f"z must be integer topic ids, got {z.dtype}"
        if z.size and (z.min() < 0 or z.max() >= cfg.num_topics):
            return False, (f"z assignments outside [0, {cfg.num_topics})")
        expect = {
            "n_dt": (cfg.num_docs, cfg.num_topics),
            "n_wt": (cfg.vocab_size, cfg.num_topics),
            "n_t": (cfg.num_topics,),
        }
        for name, shape in expect.items():
            arr = codec.as_numpy(getattr(state, name))
            if arr.shape != shape:
                return False, (f"{name} has shape {arr.shape}; corpus needs "
                               f"{shape}")
            if not np.all(np.isfinite(arr)):
                return False, f"{name} contains non-finite entries"
        rebuilt = codec.rebuild_state(
            cfg, corpus, torch.as_tensor(z.astype(np.int32), device=self.device))
        for name in expect:
            got = codec.as_numpy(getattr(state, name)).astype(np.float64)
            want = codec.as_numpy(getattr(rebuilt, name)).astype(np.float64)
            dev = float(np.max(np.abs(got - want))) if got.size else 0.0
            if dev > count_tol:
                return False, (f"{name} inconsistent with its own "
                               f"assignments (max deviation {dev:.1f} "
                               f"stored units)")
        return True, "ok"

    def spot_check(
        self,
        handle: ModelHandle,
        state: LDAState,
        *,
        claimed_perplexity: Optional[float] = None,
        num_sweeps: int = 0,
        claim_tol: float = 0.01,
        backend: Optional[str] = None,
        seed: Optional[int] = None,
    ) -> SpotCheckResponse:
        """Server-side check of a device-computed state, without touching
        the served handle: validation, the server's own perplexity, and
        with `num_sweeps > 0` re-Gibbs on a throwaway copy."""
        ok, reason = self.validate_state(handle, state)
        if not ok:
            return SpotCheckResponse(valid=False, reason=reason)
        state = state.to(self.device)
        cfg, corpus = handle.cfg, handle.model.corpus
        state_ppx = float(perplexity_lib.perplexity(cfg, state, corpus))
        deviation = None
        if claimed_perplexity is not None:
            claimed = float(claimed_perplexity)
            deviation = abs(state_ppx - claimed) / max(abs(claimed), 1e-9)
            if deviation > claim_tol:
                return SpotCheckResponse(
                    valid=False,
                    reason=(f"claimed perplexity {claimed:.3f} deviates "
                            f"{deviation:.1%} from recomputed "
                            f"{state_ppx:.3f}"),
                    state_perplexity=state_ppx, deviation=deviation)
        post_ppx = None
        if num_sweeps > 0:
            backend = self._resolve(
                backend, num_tokens=corpus.num_tokens, task="update")
            post = self.sampler(backend).run(
                cfg, corpus, self._generator(seed), num_sweeps, state=state)
            post_ppx = float(perplexity_lib.perplexity(cfg, post, corpus))
        return SpotCheckResponse(
            valid=True, reason="ok", state_perplexity=state_ppx,
            post_perplexity=post_ppx, deviation=deviation)

    def adopt_state(
        self, handle: ModelHandle, state: LDAState, *, sweeps_run: int = 0
    ) -> ModelHandle:
        """Swap a device-computed state into an *existing* served handle,
        after validation (adoption is the trust boundary)."""
        ok, reason = self.validate_state(handle, state)
        if not ok:
            raise ValueError(f"refusing to adopt state: {reason}")
        handle.model.state = state.to(self.device)
        handle.sweeps_run += int(sweeps_run)
        return handle

    def release(self, handle) -> None:
        """Drop a served handle (by handle or id); frees model state."""
        hid = handle.handle_id if isinstance(handle, ModelHandle) else int(handle)
        self.handles.pop(hid, None)
