"""The Chital marketplace: task distribution + lifecycle (paper §2.5.1).

Sequence per query:
  1. buyer submits a modeling task (a product's review set);
  2. if the buyer's device is capable, it is simultaneously listed as a
     seller for the duration of its computation;
  3. the matcher pairs the buyer with two sellers, both of which compute a
     model from the supplied data;
  4. results return to the central servers: validation → selection (lower
     perplexity) → Eq.(6) verification;
  5. credit settles zero-sum loser→winner; the winner earns t·i* lottery
     tickets; the surviving model is returned to the buyer.

Execution of a seller's job is pluggable (`SellerRuntime`) so the same
marketplace drives (a) real Gibbs sampling on the local devices (examples,
integration tests) and (b) the analytic event-driven simulator.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.chital.credit import CreditLedger
from repro_torch.chital.lottery import Lottery
from repro_torch.chital.matching import BuyerRequest, Match, Matcher, Seller
from repro_torch.chital.verification import EvaluationResult, Submission, evaluate

# A SellerRuntime executes a task on a seller device and returns a Submission.
SellerRuntime = Callable[[Seller, BuyerRequest], Submission]


@dataclasses.dataclass
class TaskRecord:
    buyer: BuyerRequest
    # Both None for an unmatched query: the buyer fell back to computing
    # locally. The fallback is recorded (not dropped) so marketplace-level
    # metrics average over *all* queries, not just the matched ones.
    match: Optional[Match]
    result: Optional[EvaluationResult]
    response_time: float  # buyer-observed latency
    local_time: float  # counterfactual: computing alone
    tickets_awarded: int

    @property
    def matched(self) -> bool:
        return self.match is not None


@dataclasses.dataclass
class Marketplace:
    matcher: Matcher
    runtime: SellerRuntime
    sellers: list[Seller] = dataclasses.field(default_factory=list)
    ledger: CreditLedger = dataclasses.field(default_factory=CreditLedger)
    lottery: Lottery = dataclasses.field(default_factory=Lottery)
    deviation_tol: float = 0.05
    # Credit transferred when a submission is REJECTED by verification. The
    # paper fixes the normal settlement at 1 credit but not the rejection
    # settlement; 2.0 = the normal settlement the cheat would have lost as
    # the true worst model (1) + forfeiture of the credit it fraudulently
    # claimed (1). With Eq.(6) this makes the cheater's expected credit
    # drift negative at credit 0 (drift = 1 - 3·p_v < 0 for p_v > 1/3),
    # which is what produces the paper's §2.5.2 bad→good credit flow; at
    # 1.0 a cheater at credit 0 has *positive* drift (1 - 2·p_v > 0 for
    # p_v < 1/2) and the feedback loop runs the wrong way.
    rejection_penalty: float = 2.0
    # Optional server-side re-Gibbs hook: `reverify(sub) -> float` runs a
    # few extra sweeps on the submitted model and returns the post-check
    # perplexity (`repro_torch.offload` wires a real `spot_check` here). None
    # keeps the simulator's analytic `converged_perplexity` behavior.
    reverify: Optional[Callable[[Submission], float]] = None
    seed: int = 0
    history: list[TaskRecord] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        for s in self.sellers:
            self.ledger.register(s.seller_id)

    def opt_in(self, seller: Seller) -> None:
        """A user opts into background computation (becomes a seller)."""
        self.sellers.append(seller)
        self.ledger.register(seller.seller_id)

    def submit(self, buyer: BuyerRequest, now: float = 0.0) -> TaskRecord:
        """Run one buyer query through the full marketplace pipeline.

        An unmatched query (not enough available sellers) is recorded as an
        explicit local-fit fallback entry — `match`/`result` are None and the
        response time equals the local time — so `mean_time_saved` and
        `matched_rate` average over every query instead of silently
        conditioning on the matched ones.
        """
        match = self.matcher.match(buyer, self.sellers, now, self.rng)
        if match is None:
            local = buyer.task_tokens / max(buyer.local_speed, 1e-9)
            rec = TaskRecord(
                buyer=buyer, match=None, result=None,
                response_time=local, local_time=local, tickets_awarded=0)
            self.history.append(rec)
            return rec

        s1, s2 = match.sellers
        sub1 = self.runtime(s1, buyer)
        sub2 = self.runtime(s2, buyer)

        # Sellers become unavailable for their busy period (§2.5.3).
        s1.busy_until = now + Matcher.busy_period(s1, buyer)
        s2.busy_until = now + Matcher.busy_period(s2, buyer)

        result = evaluate(
            sub1,
            sub2,
            self.ledger.get(s1.seller_id),
            self.ledger.get(s2.seller_id),
            self.rng,
            deviation_tol=self.deviation_tol,
            reverify=self.reverify,
        )

        tickets = 0
        if result.winner is not None and result.loser is not None:
            amount = self.rejection_penalty if result.rejected else 1.0
            self.ledger.transfer(
                result.loser.seller_id, result.winner.seller_id, amount
            )
            tickets = self.lottery.award(
                result.winner.seller_id,
                result.winner.tokens_processed,
                result.winner.iterations,
            )

        # Buyer-observed latency: the *winning* seller's compute time (both
        # run concurrently), plus a fixed server round-trip overhead.
        if result.winner is not None:
            win_seller = s1 if result.winner.seller_id == s1.seller_id else s2
            response = buyer.task_tokens / max(win_seller.speed, 1e-9)
        else:
            # Rejected: buyer falls back to local computation.
            response = buyer.task_tokens / max(buyer.local_speed, 1e-9)

        rec = TaskRecord(
            buyer=buyer,
            match=match,
            result=result,
            response_time=response,
            local_time=buyer.task_tokens / max(buyer.local_speed, 1e-9),
            tickets_awarded=tickets,
        )
        self.history.append(rec)
        return rec

    # -- metrics ---------------------------------------------------------------
    def matched_rate(self) -> float:
        """Fraction of submitted queries the matcher found a seller pair
        for; the rest fell back to local computation."""
        if not self.history:
            return 0.0
        return float(np.mean([r.matched for r in self.history]))

    def verification_rate(self) -> float:
        """Fraction of *evaluated* (matched) queries where Eq.(6) fired —
        unmatched fallbacks never reach the verification stage, so they are
        excluded by construction rather than silently counted as 0."""
        evaluated = [r.result.verified for r in self.history if r.result is not None]
        if not evaluated:
            return 0.0
        return float(np.mean(evaluated))

    def mean_time_saved(self) -> float:
        """Mean (local − observed) latency over ALL queries; a local-fit
        fallback contributes exactly 0 saved."""
        if not self.history:
            return 0.0
        return float(np.mean([r.local_time - r.response_time for r in self.history]))
