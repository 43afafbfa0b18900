"""Event-driven simulation of the Chital network (paper §2.5, §2.5.4).

Simulates a population of heterogeneous devices (speed, honesty) serving a
Poisson stream of buyer queries, reproducing the paper's empirical claims:

  * honest sellers keep ≈0 expected credit; malicious sellers drain credit;
  * as credit separates, Eq. (6) verifies good users *less* and bad users
    *more*;
  * "users always save overall computation time by a large margin"
    (§2.5.4) under the gain-maximizing matcher.

Malicious sellers submit phony (unconverged) models: reported perplexity is
optimistically low but server-side re-Gibbs reveals a large deviation, so
verification rejects them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.chital.marketplace import BuyerRequest, Marketplace, Seller, Submission
from repro_torch.chital.matching import MATCHERS


@dataclasses.dataclass(frozen=True)
class SimSpec:
    num_sellers: int = 50
    malicious_frac: float = 0.2
    num_queries: int = 400
    arrival_rate: float = 2.0  # queries per unit time (Poisson)
    mean_task_tokens: int = 30000  # 487-review product ≈ 30k tokens (§5)
    seller_speed_range: tuple[float, float] = (2000.0, 20000.0)
    buyer_speed: float = 1500.0  # buyers are the slowest devices
    matcher: str = "greedy_gain"
    iterations: int = 100  # Gibbs iterations per model
    deviation_tol: float = 0.05
    seed: int = 0


@dataclasses.dataclass
class SimResult:
    marketplace: Marketplace
    honest_credit: float
    malicious_credit: float
    honest_verification_rate: float
    malicious_involved_verification_rate: float
    mean_time_saved: float
    mean_speedup: float
    rejected_rate: float
    matched_rate: float


def _make_runtime(spec: SimSpec, rng: np.random.Generator):
    """Analytic seller execution: honest sellers converge (tight perplexity
    around the task's true optimum), malicious sellers fake low perplexity
    that re-verification exposes."""

    def runtime(seller: Seller, buyer: BuyerRequest) -> Submission:
        true_perp = 300.0 + 40.0 * rng.standard_normal() + buyer.task_tokens * 1e-4
        true_perp = max(true_perp, 50.0)
        if seller.honest:
            reported = true_perp * (1.0 + 0.01 * abs(rng.standard_normal()))
            converged = reported * (1.0 + 0.005 * rng.standard_normal())
        else:
            # Phony result: claims an implausibly good model; actual model
            # (if re-sampled) is far worse.
            reported = true_perp * 0.6
            converged = true_perp * (1.3 + 0.2 * abs(rng.standard_normal()))
        return Submission(
            seller_id=seller.seller_id,
            perplexity=float(reported),
            tokens_processed=buyer.task_tokens,
            iterations=spec.iterations,
            converged_perplexity=float(converged),
        )

    return runtime


def run(spec: SimSpec) -> SimResult:
    rng = np.random.default_rng(spec.seed)

    sellers = []
    n_mal = int(spec.num_sellers * spec.malicious_frac)
    for i in range(spec.num_sellers):
        sellers.append(
            Seller(
                seller_id=i,
                speed=float(rng.uniform(*spec.seller_speed_range)),
                honest=i >= n_mal,
            )
        )

    mp = Marketplace(
        matcher=MATCHERS[spec.matcher](),
        runtime=_make_runtime(spec, rng),
        sellers=sellers,
        deviation_tol=spec.deviation_tol,
        seed=spec.seed + 1,
    )

    now = 0.0
    for q in range(spec.num_queries):
        now += float(rng.exponential(1.0 / spec.arrival_rate))
        tokens = max(1000, int(rng.normal(spec.mean_task_tokens, spec.mean_task_tokens * 0.3)))
        buyer = BuyerRequest(
            buyer_id=10_000 + q,
            task_tokens=tokens * spec.iterations // 100,  # effective work units
            arrival=now,
            local_speed=spec.buyer_speed,
        )
        mp.submit(buyer, now=now)

    honest_ids = {s.seller_id for s in sellers if s.honest}
    mal_ids = {s.seller_id for s in sellers if not s.honest}
    credits = mp.ledger.credits
    honest_credit = float(np.mean([credits.get(i, 0.0) for i in honest_ids]))
    mal_credit = (
        float(np.mean([credits.get(i, 0.0) for i in mal_ids])) if mal_ids else 0.0
    )

    # Verification rates conditioned on who was involved in the pair
    # (local-fit fallback entries never reach the evaluation stage).
    hv, mv = [], []
    for r in mp.history:
        if r.match is None:
            continue
        pair_ids = {p.seller_id for p in r.match.sellers}
        if pair_ids & mal_ids:
            mv.append(r.result.verified)
        else:
            hv.append(r.result.verified)

    # Time metrics over ALL queries: a fallback saves exactly 0 (1x).
    saved = [r.local_time - r.response_time for r in mp.history]
    speedups = [r.local_time / max(r.response_time, 1e-9) for r in mp.history]
    rejected = [r.result.rejected for r in mp.history if r.result is not None]
    return SimResult(
        marketplace=mp,
        honest_credit=honest_credit,
        malicious_credit=mal_credit,
        honest_verification_rate=float(np.mean(hv)) if hv else 0.0,
        malicious_involved_verification_rate=float(np.mean(mv)) if mv else 0.0,
        mean_time_saved=float(np.mean(saved)) if saved else 0.0,
        mean_speedup=float(np.mean(speedups)) if speedups else 0.0,
        rejected_rate=float(np.mean(rejected)) if rejected else 0.0,
        matched_rate=mp.matched_rate(),
    )
