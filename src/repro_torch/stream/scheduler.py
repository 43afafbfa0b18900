"""`IncrementalScheduler` — micro-batched online refitting per product.

Incremental Variational Inference for LDA (Archambeau & Ermiş, 2015) shows
online topic updates match batch quality at a fraction of the cost —
*until* the data drifts, at which point a full re-fit is needed. The
scheduler realizes that policy over the Vedalia protocol:

  1. drain the router's per-shard queue; group events by product;
  2. bootstrap: the first `min_fit_reviews` reviews of a product become a
     server-side `fit` (backend resolved by the capability-aware registry);
  3. steady state: reviews are `ingest`-ed (acked server-side), and once a
     product has `microbatch` unapplied reviews — or its oldest unapplied
     event exceeds the **staleness budget** — one `update(drain=True)`
     folds them in as a warm incremental update (the `auto` route resolves
     updates to the exact `torch` sweep);
  4. drift trigger: after each applied micro-batch the scheduler scores
     the current view against the **anchor** signatures cut at the last
     full (re)fit — the continuous `core.views.signature_distance`, so
     drift accumulates across micro-batches — and scores a held-out
     reservoir (`perplexity(reviews=...)`). When mean drift exceeds
     `drift_threshold`, or held-out perplexity degrades past `ppx_guard` ×
     the post-fit baseline, it schedules a full re-fit, then re-anchors.

Re-fits are **coalesced per scheduling window**: triggers queue during a
`step`, and at the end of the step each shard's queued re-fits go out as
ONE `refine_batch` call — the server stacks compatible models through
`serving.batch_engine` and sweeps them in a single batched launch instead
of N sequential `refine` calls. A shard whose server predates the
`batched` backend (absent from its `hello`) degrades to the sequential
per-product `refine` path, with the backend chosen by `select_backend`
per corpus size (alias for large corpora, torch otherwise).

Every applied event contributes one **staleness sample** (apply time minus
event time); `SchedulerStats.staleness_p` reports the p50/p99.

Time is *event time*, driven by the source's timestamps — the scheduler is
single-threaded and deterministic, which is what makes the drift-vs-always
refit comparison and the kill/restore tests replayable.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from repro_torch.api.backends import select_backend
from repro_torch.api.client import VedaliaClient
from repro_torch.api.protocol import RemoteError
from repro_torch.core import views as views_lib
from repro_torch.core.rlda import Review
from repro_torch.obs import config as obs_config
from repro_torch.obs import metrics, trace
from repro_torch.stream.router import StreamRouter
from repro_torch.stream.sources import ReviewEvent

#: `SchedulerStats` counters published as labelled gauges (gauges, not
#: counters: the stats object is the source of truth and restores from
#: snapshots — the gauge mirrors whatever it says now).
_SCHED_STAT = metrics.gauge(
    "vedalia_scheduler_stat",
    "IncrementalScheduler counters, one series per stat field.",
    labels=("stat",))
_STALENESS_P = metrics.gauge(
    "vedalia_scheduler_staleness_seconds",
    "View-staleness percentiles over the sliding sample window.",
    labels=("quantile",))
_QUEUE_DEPTH = metrics.gauge(
    "vedalia_router_queue_depth",
    "Per-shard router queue depth after the last scheduler step.",
    labels=("shard",))

REFIT_POLICIES = ("drift", "always", "never")

#: A pluggable full-refit executor, called once per shard per scheduling
#: window: ``(shard_id, client, statuses, num_sweeps, now) -> launches``.
#: It must bring every status's served handle to a freshly-refit state by
#: whatever means it owns (`repro_torch.offload.OffloadCoordinator` leases
#: the work to a device fleet and falls back to server-side `refine` when
#: the fleet yields nothing adoptable) and return the number of wire
#: launches it made. The scheduler still re-anchors and
#: re-baselines each product afterwards, so the drift guard is executor-
#: agnostic.
RefitExecutor = Callable[
    [int, VedaliaClient, "list[ProductStatus]", int, float], int]

# Staleness percentiles are reported over a sliding window of the most
# recent samples: a scheduler that lives for days at production rates
# must not grow one float per event forever.
STALENESS_WINDOW = 100_000


@dataclasses.dataclass
class ProductStatus:
    """Scheduler-side state for one product's served model."""

    product_id: int
    shard_id: int
    handle_id: Optional[int] = None
    pending_fit: list[ReviewEvent] = dataclasses.field(default_factory=list)
    unapplied_ts: list[float] = dataclasses.field(default_factory=list)
    heldout: list[Review] = dataclasses.field(default_factory=list)
    baseline_ppx: Optional[float] = None
    # topic_id -> views.topic_signature at the last fit/refit — the anchor
    # the continuous drift score is measured against.
    signatures: dict[int, dict] = dataclasses.field(default_factory=dict)
    tokens_ingested: int = 0
    acked: int = 0
    seen: int = 0  # events observed (heldout reservoir counter)


@dataclasses.dataclass
class SchedulerStats:
    fits: int = 0
    updates: int = 0
    refits: int = 0
    refit_launches: int = 0  # wire calls actually made (<= refits)
    coalesced_refits: int = 0  # refits that shared a batched launch
    # Token-weighted Gibbs sweep work the *server* ran for re-fits
    # (sweeps x corpus tokens, summed). The built-in refit path accrues it
    # here; a pluggable `refit_executor` accounts its own server-side work
    # (spot-checks, fallbacks) instead, so an offload tier can compare the two.
    refit_sweep_work: float = 0.0
    drift_triggers: int = 0
    ppx_triggers: int = 0
    forced_by_staleness: int = 0
    events_applied: int = 0
    events_held_out: int = 0
    overloaded_retries: int = 0
    staleness: "collections.deque[float]" = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=STALENESS_WINDOW))

    def staleness_p(self, q: float) -> float:
        """The q-th percentile of per-event view staleness (seconds),
        over the `STALENESS_WINDOW` most recent applied events."""
        if not self.staleness:
            return 0.0
        return float(np.percentile(np.asarray(self.staleness), q))


class IncrementalScheduler:
    """Drive per-shard `VedaliaClient`s from a `StreamRouter`'s queues."""

    def __init__(
        self,
        clients: Mapping[int, VedaliaClient],
        router: StreamRouter,
        *,
        microbatch: int = 8,
        min_fit_reviews: int = 12,
        staleness_budget: float = 10.0,
        drift_threshold: float = 0.5,
        ppx_guard: float = 1.15,
        heldout_every: int = 5,
        max_heldout: int = 40,
        refit_sweeps: int = 10,
        refit_policy: str = "drift",
        fit_kwargs: Optional[dict] = None,
        refit_executor: Optional[RefitExecutor] = None,
    ):
        if refit_policy not in REFIT_POLICIES:
            raise ValueError(
                f"unknown refit policy {refit_policy!r}; "
                f"policies: {REFIT_POLICIES}")
        missing = set(router.shard_ids) - set(clients)
        if missing:
            raise ValueError(f"no client for router shard(s) {sorted(missing)}")
        if "base_vocab" not in (fit_kwargs or {}):
            # Never inferred: the stream's vocabulary must be fixed up
            # front, because later reviews can use words the bootstrap
            # batch never saw — an inferred vocab would make their token
            # ids out of range for every subsequent update.
            raise ValueError("fit_kwargs must include base_vocab")
        self.clients = dict(clients)
        self.router = router
        self.microbatch = microbatch
        self.min_fit_reviews = min_fit_reviews
        self.staleness_budget = staleness_budget
        self.drift_threshold = drift_threshold
        self.ppx_guard = ppx_guard
        self.heldout_every = heldout_every
        self.max_heldout = max_heldout
        self.refit_sweeps = refit_sweeps
        self.refit_policy = refit_policy
        self.refit_executor = refit_executor
        self.fit_kwargs = dict(fit_kwargs or {})
        self.products: dict[int, ProductStatus] = {}
        self.stats = SchedulerStats()
        # Re-fits triggered during the current scheduling window; flushed
        # as one batched launch per shard at the end of each step.
        self._refit_queue: list[ProductStatus] = []
        # Capability-aware refit routing: ask each shard what it can run.
        self._backends = {
            sid: c.hello().backends for sid, c in self.clients.items()
        }
        # Each shard's ingest-queue bound: batches larger than this can
        # never be accepted whole, so `_ingest` chunks to it.
        self._max_queue = {
            sid: c.stats().max_ingest_queue
            for sid, c in self.clients.items()
        }

    # -- shard membership ----------------------------------------------------

    def rebind_shard(self, shard_id: int, client: VedaliaClient) -> None:
        """Swap in the client of a restored shard (after kill/restore, the
        handles keep their ids, so product state carries over unchanged)."""
        self.clients[shard_id] = client
        self._backends[shard_id] = client.hello().backends
        self._max_queue[shard_id] = client.stats().max_ingest_queue

    def drop_shard(self, shard_id: int) -> None:
        """Decommission a shard for good (no snapshot to restore — that
        case is `rebind_shard`). Call *after* `router.remove_shard`, then
        re-offer its orphans: every product fitted on the dead shard is
        reset to re-bootstrap on its new route. Its model and any
        acked-but-unapplied reviews died with the shard; `pending_fit`
        reviews never reached it, so they seed the re-bootstrap.
        """
        if shard_id in self.router.shard_ids:
            raise ValueError(
                f"shard {shard_id} is still in the router; call "
                f"router.remove_shard first so products can be rerouted")
        self.clients.pop(shard_id, None)
        self._backends.pop(shard_id, None)
        self._max_queue.pop(shard_id, None)
        for status in self.products.values():
            if status.shard_id != shard_id:
                continue
            status.shard_id = self.router.route(status.product_id)
            status.handle_id = None
            status.unapplied_ts = []
            status.baseline_ppx = None
            status.signatures = {}
            status.tokens_ingested = 0
            status.acked = 0

    # -- the event loop ------------------------------------------------------

    def step(self, now: float) -> None:
        """Drain router queues and run fit/ingest/apply decisions at `now`."""
        if not obs_config._enabled:
            return self._step(now)
        # The step span is the trace root of everything this window does:
        # ingests, updates, and (via `_flush_refits`) refits and any refit
        # executor's work all hang off one trace id.
        with trace.span("scheduler.step", now=now):
            self._step(now)
        self.publish_metrics()

    def _step(self, now: float) -> None:
        for sid in self.router.shard_ids:
            events = self.router.drain(sid)
            by_product: dict[int, list[ReviewEvent]] = {}
            for e in events:
                by_product.setdefault(e.product_id, []).append(e)
            for pid, evs in by_product.items():
                self._dispatch(self._status(pid, sid), evs, now)
        # Apply pass: staleness can force work even with no new arrivals —
        # an overdue micro-batch is applied short, and an overdue bootstrap
        # is fit with however few reviews have arrived (a rough model now
        # beats a good model past the budget).
        for status in self.products.values():
            if status.handle_id is None:
                if status.pending_fit and (
                        now - status.pending_fit[0].t
                        ) > self.staleness_budget:
                    self.stats.forced_by_staleness += 1
                    self._fit(status, now)
                continue
            if status.unapplied_ts:
                overdue = (now - min(status.unapplied_ts)
                           ) > self.staleness_budget
                if len(status.unapplied_ts) >= self.microbatch or overdue:
                    if overdue and len(status.unapplied_ts) < self.microbatch:
                        self.stats.forced_by_staleness += 1
                    self._apply(status, now)
        # End of the scheduling window: every re-fit triggered above goes
        # out now, one batched launch per shard.
        self._flush_refits(now)

    def flush(self, now: float) -> None:
        """End of stream: drain everything and apply all residual batches."""
        self.step(now)
        for status in self.products.values():
            if status.handle_id is None and status.pending_fit:
                self._fit(status, now)
            elif status.handle_id is not None and status.unapplied_ts:
                self._apply(status, now)
        self._flush_refits(now)

    # -- internals -----------------------------------------------------------

    def _status(self, pid: int, sid: int) -> ProductStatus:
        status = self.products.get(pid)
        if status is None:
            status = self.products[pid] = ProductStatus(
                product_id=pid, shard_id=sid)
        return status

    def _dispatch(
        self, status: ProductStatus, events: Sequence[ReviewEvent], now: float
    ) -> None:
        ingestable = []
        for e in events:
            status.seen += 1
            if (status.seen % self.heldout_every == 0
                    and len(status.heldout) < self.max_heldout):
                status.heldout.append(e.review)  # guard reservoir, never fit
                self.stats.events_held_out += 1
            else:
                ingestable.append(e)

        if status.handle_id is None:
            status.pending_fit.extend(ingestable)
            if len(status.pending_fit) >= self.min_fit_reviews:
                self._fit(status, now)
            return
        if ingestable:
            self._ingest(status, ingestable, now)

    def _fit(self, status: ProductStatus, now: float) -> None:
        client = self.clients[status.shard_id]
        reviews = [e.review for e in status.pending_fit]
        fit = client.fit(reviews, backend="auto", **self.fit_kwargs)
        status.handle_id = fit.handle_id
        status.tokens_ingested += sum(len(r.tokens) for r in reviews)
        # Held-out units only: when the reservoir is still empty the
        # baseline stays None and `_apply` anchors it to the first held-out
        # score — never to `fit.perplexity`, which is training-corpus
        # perplexity and routinely lower (a guaranteed spurious trigger).
        status.baseline_ppx = self._guard_ppx(status)
        self.stats.fits += 1
        self.stats.events_applied += len(status.pending_fit)
        self.stats.staleness.extend(
            now - e.t for e in status.pending_fit)
        status.pending_fit = []
        self._anchor(status)  # drift is measured from the post-fit view

    def _ingest(
        self, status: ProductStatus, events: Sequence[ReviewEvent], now: float
    ) -> None:
        client = self.clients[status.shard_id]
        # A batch larger than the shard's queue bound can never be accepted
        # whole, so chunk to it; each chunk then needs at most one
        # fold-and-retry to land, because an apply empties the queue.
        max_q = self._max_queue[status.shard_id]
        for i in range(0, len(events), max_q):
            chunk = events[i:i + max_q]
            batch = [e.review for e in chunk]
            try:
                ack = client.ingest(status.handle_id, batch)
            except RemoteError as err:
                if err.code != "overloaded":
                    raise
                # Backpressure: fold the queued backlog in, then retry once.
                self._apply(status, now)
                self.stats.overloaded_retries += 1
                ack = client.ingest(status.handle_id, batch)
            status.acked = ack.acked
            status.tokens_ingested += sum(len(r.tokens) for r in batch)
            status.unapplied_ts.extend(e.t for e in chunk)

    def _apply(self, status: ProductStatus, now: float) -> None:
        """Fold the acked backlog into the model and run the refit check."""
        client = self.clients[status.shard_id]
        client.update(status.handle_id, drain=True, backend="auto")
        self.stats.updates += 1
        self.stats.events_applied += len(status.unapplied_ts)
        self.stats.staleness.extend(now - t for t in status.unapplied_ts)
        status.unapplied_ts = []

        if self.refit_policy == "never":
            return
        if self.refit_policy == "always":
            self._queue_refit(status)
            return

        # Drift trigger: continuous `views.topic_signature` distance of the
        # current view against the anchor cut at the last fit/refit — drift
        # accumulates across micro-batches until a refit resets the anchor.
        drift = views_lib.view_drift(
            status.signatures, client.view(status.handle_id).view)
        if drift > self.drift_threshold:
            # Already refitting: skip the held-out scoring (a server-side
            # prepare per call) — the refit re-baselines the guard anyway.
            self.stats.drift_triggers += 1
            self._queue_refit(status)
            return
        guard = self._guard_ppx(status)
        if guard is None:
            return
        if status.baseline_ppx is None:
            # The reservoir was empty at (re)fit time; its first score
            # becomes the baseline the guard measures against.
            status.baseline_ppx = guard
            return
        if guard > self.ppx_guard * status.baseline_ppx:
            self.stats.ppx_triggers += 1
            self._queue_refit(status)

    def _queue_refit(self, status: ProductStatus) -> None:
        """Defer a triggered re-fit to the end of the scheduling window so
        same-window triggers coalesce into one batched launch per shard."""
        if not any(s is status for s in self._refit_queue):
            self._refit_queue.append(status)

    def _flush_refits(self, now: float) -> None:
        """Launch every queued re-fit, grouped per shard. With a pluggable
        `refit_executor` the whole group is delegated to it (an offload
        tier); the built-in path is one `refine_batch` per shard where the
        server advertises the `batched` backend, the sequential
        per-product path otherwise. Either way the scheduler re-anchors
        and re-baselines each product afterwards."""
        if not self._refit_queue:
            return
        queue, self._refit_queue = self._refit_queue, []
        by_shard: dict[int, list[ProductStatus]] = {}
        for status in queue:
            # A shard drop between trigger and flush re-bootstraps the
            # product elsewhere; its queued re-fit is moot.
            if status.handle_id is None or status.shard_id not in self.clients:
                continue
            by_shard.setdefault(status.shard_id, []).append(status)
        for sid, statuses in by_shard.items():
            with trace.span("scheduler.refit", shard=sid,
                            num_products=len(statuses)):
                launches = self._execute_refits(sid, statuses, now)
            self.stats.refits += len(statuses)
            self.stats.refit_launches += launches
            self.stats.coalesced_refits += max(0, len(statuses) - launches)
            for status in statuses:
                status.baseline_ppx = self._guard_ppx(status)
                self._anchor(status)

    def _execute_refits(
        self, sid: int, statuses: "list[ProductStatus]", now: float
    ) -> int:
        """Run one shard's due re-fits; returns the wire launches made."""
        client = self.clients[sid]
        if self.refit_executor is not None:
            return self.refit_executor(
                sid, client, list(statuses), self.refit_sweeps, now)
        if len(statuses) > 1 and "batched" in self._backends[sid]:
            # The window's coalesced launch: `auto` resolves the
            # multi-model route server-side (-> the batched sampler), and
            # `serving.batch_engine` buckets whatever is stack-compatible.
            client.refine_batch(
                [status.handle_id for status in statuses],
                self.refit_sweeps, backend="auto")
            self.stats.refit_sweep_work += float(sum(
                self.refit_sweeps * s.tokens_ingested for s in statuses))
            return 1
        for status in statuses:
            # Full re-fit via `refine`, on a fit-grade backend chosen by
            # the capability-aware registry for this corpus size.
            backend = select_backend(
                num_tokens=status.tokens_ingested, task="fit",
                available=self._backends[sid])
            client.refine(status.handle_id, self.refit_sweeps, backend=backend)
            self.stats.refit_sweep_work += float(
                self.refit_sweeps * status.tokens_ingested)
        return len(statuses)

    def _anchor(self, status: ProductStatus) -> None:
        """Store the post-(re)fit topic signatures as the drift anchor."""
        view = self.clients[status.shard_id].view(status.handle_id).view
        status.signatures = {
            t.topic_id: views_lib.topic_signature(t) for t in view.topics
        }

    def publish_metrics(self) -> None:
        """Mirror `SchedulerStats` and the router's queue depths into the
        obs registry (gauges). Runs after every step while obs is enabled;
        call it directly for a final end-of-stream reading."""
        if not obs_config._enabled:
            return
        for field in dataclasses.fields(SchedulerStats):
            if field.name == "staleness":
                continue
            _SCHED_STAT.set(
                float(getattr(self.stats, field.name)), stat=field.name)
        _STALENESS_P.set(self.stats.staleness_p(50), quantile="p50")
        _STALENESS_P.set(self.stats.staleness_p(99), quantile="p99")
        for sid, depth in self.router.stats().depths.items():
            _QUEUE_DEPTH.set(float(depth), shard=sid)

    def _guard_ppx(self, status: ProductStatus) -> Optional[float]:
        if not status.heldout:
            return None
        return self.clients[status.shard_id].perplexity(
            status.handle_id, reviews=status.heldout)


def pump(
    events: Sequence[ReviewEvent],
    router: StreamRouter,
    scheduler: IncrementalScheduler,
    *,
    step_interval: float = 2.0,
    on_step: Optional[Callable[[float], None]] = None,
) -> float:
    """Feed a time-ordered event sequence through router + scheduler.

    Steps fire on a regular event-time grid (every `step_interval`
    seconds), the way a deployment's timer would — including across
    arrival gaps, so a burst's tail is applied within the staleness budget
    even when the stream then goes quiet. Refused events (``block``
    backpressure) are re-offered after a step drains the queues. Returns
    the final event time.

    `on_step(t)` runs after each grid step — the hook where a deployment
    hangs its concurrent readers, health checks, or (in `chip_smoke.py`'s
    `stream` phase) a mid-run shard kill/restore.
    """
    last_step = 0.0
    now = 0.0
    for e in events:
        now = e.t
        while last_step + step_interval <= now:
            last_step += step_interval
            scheduler.step(last_step)
            if on_step is not None:
                on_step(last_step)
        while not router.offer(e):
            scheduler.step(now)  # drain, then the offer must land
    scheduler.flush(now)
    return now
