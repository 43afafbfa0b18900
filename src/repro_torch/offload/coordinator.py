"""`OffloadCoordinator` — the server-cost reduction loop (paper §2.2, §2.5).

The coordinator is a `stream.RefitExecutor`: the scheduler hands it each
window's due full re-fits, and instead of burning server sweeps it leases
every task into the Chital marketplace:

  1. the matcher pairs the task with two fleet devices; both run the fit
     for real (`DeviceFleet.execute` — export, local re-Gibbs, upload);
  2. every state-carrying upload passes the server's *validation* stage
     (`spot_check(num_sweeps=0)`): structural consistency plus a
     recompute-vs-claim perplexity check — fabricated claims and corrupted
     states die here deterministically;
  3. the surviving pair goes through selection + Eq. (6) verification,
     where `reverify` is a **real server-side re-Gibbs spot-check**
     (`spot_check(num_sweeps=spot_check_sweeps)`) on the submitted state;
  4. the winner's state is swapped into the *serving* handle
     (`adopt_state`, which re-validates at the trust boundary), credit
     settles loser -> winner, and the winner earns t·i* lottery tickets;
  5. any failure — no pair available, both uploads invalid, winner
     rejected by verification — falls back to an ordinary server-side
     `refine`, so a served view never stalls on a flaky fleet.

Server-side work is accounted in token-weighted sweep-equivalents
(`OffloadStats.server_sweep_work`) so `chip_smoke.py`'s `offload` phase
can compare against the scheduler's built-in refit path
(`SchedulerStats.refit_sweep_work`) and report the fraction of sweep-work
the fleet took off the server.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.api.client import VedaliaClient
from repro_torch.chital.marketplace import Marketplace
from repro_torch.chital.matching import MATCHERS, BuyerRequest, Seller
from repro_torch.chital.verification import Submission
from repro_torch.obs import metrics, trace
from repro_torch.offload.fleet import DeviceFleet, OffloadTask

_LEASES = metrics.counter(
    "vedalia_offload_leases_total",
    "Lease outcomes: adopted, fallback_unmatched, fallback_rejected.",
    labels=("outcome",))
_VALIDATION_FAILURES = metrics.counter(
    "vedalia_offload_validation_failures_total",
    "Uploads rejected by the server-side validation stage.")
_LEASE_EVENTS = metrics.counter(
    "vedalia_offload_lease_events_total",
    "Mid-lease fleet events (churned, timed_out).",
    labels=("event",))

#: Buyer ids live in their own range so fleet device ids never collide.
BUYER_ID_BASE = 1_000_000

#: Sweep-equivalent cost charged per server-side validation pass (a
#: scatter-rebuild + one perplexity evaluation over the corpus — much
#: cheaper than a Gibbs sweep, which draws a topic per token).
VALIDATION_COST_SWEEPS = 0.25


@dataclasses.dataclass
class OffloadStats:
    """Coordinator-side counters; sweep work is token-weighted."""

    tasks: int = 0
    adopted: int = 0
    adopted_phony: int = 0  # adopted from a malicious device (must stay 0)
    fallback_unmatched: int = 0  # matcher found no free pair
    fallback_rejected: int = 0  # no valid winner survived evaluation
    lease_timeouts: int = 0
    churned: int = 0
    invalid_submissions: int = 0  # uploads rejected by validation
    validations: int = 0
    spot_checks: int = 0  # Eq.(6)-gated re-Gibbs verifications
    device_sweep_work: float = 0.0  # sweeps the fleet ran (off-server)
    server_sweep_work: float = 0.0  # sweep-equivalents the server still ran

    @property
    def fallbacks(self) -> int:
        return self.fallback_unmatched + self.fallback_rejected


class OffloadCoordinator:
    """Lease the stream scheduler's full-refit queue to a device fleet."""

    def __init__(
        self,
        fleet: DeviceFleet,
        *,
        matcher: str = "greedy_gain",
        spot_check_sweeps: int = 2,
        deviation_tol: float = 0.08,
        claim_tol: float = 0.01,
        lease_timeout_factor: Optional[float] = 2.0,
        server_speed: float = 200_000.0,
        seed: int = 0,
    ):
        self.fleet = fleet
        self.spot_check_sweeps = spot_check_sweeps
        self.claim_tol = claim_tol
        # Lease deadline = factor x the slowest *advertised* device's
        # completion time: every healthy device makes it, stragglers
        # (whose true speed is advertised/straggler_factor) mostly miss.
        # None disables deadlines entirely.
        self.lease_timeout_factor = lease_timeout_factor
        self.server_speed = server_speed
        self.stats = OffloadStats()
        self.marketplace = Marketplace(
            matcher=MATCHERS[matcher](),
            runtime=self._runtime,
            sellers=fleet.sellers(),
            deviation_tol=deviation_tol,
            reverify=self._reverify,
            seed=seed,
        )
        self._next_task = 0
        # Lease context for the synchronous marketplace round-trip: the
        # runtime and reverify hooks are called from inside
        # `marketplace.submit`, which this class always invokes with the
        # current task/client set here first.
        self._task: Optional[OffloadTask] = None
        self._client: Optional[VedaliaClient] = None

    # -- the RefitExecutor surface ------------------------------------------

    def __call__(self, shard_id, client, statuses, num_sweeps, now) -> int:
        """`stream.RefitExecutor`: lease each due re-fit; one wire launch
        (`adopt_state` or the fallback `refine`) per product."""
        launches = 0
        for status in statuses:
            self._lease(shard_id, client, status, num_sweeps, now)
            launches += 1
        return launches

    # -- internals -----------------------------------------------------------

    def _deadline(self, task: OffloadTask) -> Optional[float]:
        if self.lease_timeout_factor is None:
            return None
        work = float(task.tokens) * task.num_sweeps
        return self.lease_timeout_factor * work / self.fleet.min_speed

    def _lease(self, shard_id, client, status, num_sweeps, now) -> None:
        with trace.span("offload.lease", shard=shard_id,
                        product=status.product_id) as sp:
            self._lease_traced(
                shard_id, client, status, num_sweeps, now, sp)

    def _lease_traced(
            self, shard_id, client, status, num_sweeps, now, sp) -> None:
        task = OffloadTask(
            task_id=self._next_task,
            shard_id=shard_id,
            handle_id=status.handle_id,
            product_id=status.product_id,
            tokens=max(int(status.tokens_ingested), 1),
            num_sweeps=num_sweeps,
        )
        self._next_task += 1
        self.stats.tasks += 1
        buyer = BuyerRequest(
            buyer_id=BUYER_ID_BASE + task.task_id,
            # Task size in the matcher's work units: tokens x sweeps, the
            # same unit device speeds are advertised in.
            task_tokens=int(task.tokens * task.num_sweeps),
            arrival=now,
            local_speed=self.server_speed,
        )
        self._task, self._client = task, client
        try:
            rec = self.marketplace.submit(buyer, now=now)
        finally:
            self._task = self._client = None

        winner = rec.result.winner if rec.result is not None else None
        if winner is not None and winner.payload is not None:
            # Verified adoption into the *serving* handle (`adopt_state`
            # re-validates server-side at the trust boundary).
            client.adopt_state(
                task.handle_id, winner.payload,
                sweeps_run=winner.iterations)
            self.stats.server_sweep_work += (
                VALIDATION_COST_SWEEPS * task.tokens)
            self.stats.adopted += 1
            if not self.fleet.devices[winner.seller_id].honest:
                self.stats.adopted_phony += 1
            _LEASES.inc(outcome="adopted")
            sp.set(outcome="adopted", device=winner.seller_id)
            return

        # Fallback: the marketplace produced nothing adoptable (no pair,
        # both uploads invalid, or the winner was rejected by
        # verification) — the server re-fits itself so views never stall.
        if rec.match is None:
            self.stats.fallback_unmatched += 1
            outcome = "fallback_unmatched"
        else:
            self.stats.fallback_rejected += 1
            outcome = "fallback_rejected"
        _LEASES.inc(outcome=outcome)
        sp.set(outcome=outcome)
        client.refine(task.handle_id, num_sweeps, backend="auto")
        self.stats.server_sweep_work += float(num_sweeps * task.tokens)

    # -- marketplace hooks ---------------------------------------------------

    def _runtime(self, seller: Seller, _buyer: BuyerRequest) -> Submission:
        """SellerRuntime: run the lease on the device, then validate the
        upload server-side before it enters selection."""
        task, client = self._task, self._client
        assert task is not None and client is not None, \
            "marketplace runtime called outside a lease"
        run = self.fleet.execute(
            seller.seller_id, task, client.transport,
            deadline=self._deadline(task))
        if run.churned:
            self.stats.churned += 1
            _LEASE_EVENTS.inc(event="churned")
        if run.timed_out:
            self.stats.lease_timeouts += 1
            _LEASE_EVENTS.inc(event="timed_out")
        if not run.completed:
            return run.submission
        if self.fleet.devices[seller.seller_id].honest:
            self.stats.device_sweep_work += float(
                task.num_sweeps * task.tokens)
        # Validation stage (§2.5.5), state-carrying edition: structural
        # consistency + the server's own perplexity recompute vs the claim.
        with trace.span("offload.validate", product=task.product_id):
            check = client.spot_check(
                task.handle_id, run.submission.payload,
                claimed_perplexity=run.submission.perplexity,
                num_sweeps=0, claim_tol=self.claim_tol)
        self.stats.validations += 1
        self.stats.server_sweep_work += VALIDATION_COST_SWEEPS * task.tokens
        if not check.valid:
            self.stats.invalid_submissions += 1
            _VALIDATION_FAILURES.inc()
            return dataclasses.replace(run.submission, valid=False)
        return run.submission

    def _reverify(self, sub: Submission) -> float:
        """Eq. (6)'s verification made real: a few server-side re-Gibbs
        sweeps on the submitted state (on a throwaway copy)."""
        task, client = self._task, self._client
        assert task is not None and client is not None, \
            "reverify called outside a lease"
        with trace.span("offload.reverify", product=task.product_id):
            check = client.spot_check(
                task.handle_id, sub.payload,
                num_sweeps=self.spot_check_sweeps,
                seed=task.task_id)
        self.stats.spot_checks += 1
        self.stats.server_sweep_work += (
            (self.spot_check_sweeps + VALIDATION_COST_SWEEPS) * task.tokens)
        if check.post_perplexity is None:
            # Validation failed inside the spot check (should have been
            # caught earlier): treat as an unconverged submission.
            return float("inf")
        return check.post_perplexity
