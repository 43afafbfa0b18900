"""Chital evaluation pipeline: validation → selection → verification (§2.5.5).

Secondary-verification probability (paper Eq. 6), with c₁,c₂ the sellers'
credits and p₁,p₂ their models' perplexities:

    p_v = 1 - (1/3) [ 1/(1+e^-(c₁+c₂))  +  2 · min(p₁,p₂)/max(p₁,p₂) ]

High seller credit and closely-matched perplexities ⇒ low verification
probability. Verification itself runs a few extra Gibbs iterations on the
selected model server-side and rejects it if perplexity deviates
substantially (an unconverged — or dishonest — submission).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np


def verification_probability(c1: float, c2: float, p1: float, p2: float) -> float:
    """Paper Eq. (6). Defined for p1,p2 > 0."""
    lo, hi = min(p1, p2), max(p1, p2)
    ratio = lo / hi if hi > 0 else 1.0
    sig = 1.0 / (1.0 + math.exp(-(c1 + c2)))
    return 1.0 - (sig + 2.0 * ratio) / 3.0


def sole_submission_verification_probability(c1: float, c2: float) -> float:
    """Eq. (6) degenerate case: only one submission survived validation.

    With no second model to match perplexities against, the ratio term is
    dropped at its *worst* case (0), not its best (1):

        p_v = 1 - (1/3) · 1/(1+e^-(c₁+c₂))  ∈  (2/3, 1)

    so a lone unvetted model faces near-certain verification — the cross-
    check that normally substitutes for verification simply never happened.
    (Using `verification_probability(c1, c2, p, p)` here would set the
    ratio to 1 and make the sole submission *least* likely to be verified.)
    """
    sig = 1.0 / (1.0 + math.exp(-(c1 + c2)))
    return 1.0 - sig / 3.0


@dataclasses.dataclass
class Submission:
    seller_id: int
    perplexity: float
    tokens_processed: int  # t  (lottery §2.5.2)
    iterations: int  # i*
    payload: object = None  # the model view / state
    valid: bool = True  # distribution sanity (validation stage)
    # True perplexity after convergence — what server-side re-Gibbs reveals.
    # For honest converged submissions this equals `perplexity`.
    converged_perplexity: Optional[float] = None


@dataclasses.dataclass
class EvaluationResult:
    winner: Optional[Submission]
    loser: Optional[Submission]
    verification_prob: float
    verified: bool  # whether secondary verification was run
    rejected: bool  # winner rejected by validation/verification
    reason: str


def evaluate(
    sub1: Submission,
    sub2: Submission,
    credit1: float,
    credit2: float,
    rng: np.random.Generator,
    *,
    deviation_tol: float = 0.05,
    reverify: Optional[Callable[[Submission], float]] = None,
) -> EvaluationResult:
    """Run the three-stage §2.5.5 pipeline on a pair of submissions.

    `reverify(sub)` runs extra Gibbs iterations server-side and returns the
    post-convergence perplexity; defaults to the submission's
    `converged_perplexity` field (used by the simulator).
    """
    # -- validation ----------------------------------------------------------
    s1_ok, s2_ok = sub1.valid, sub2.valid
    if not s1_ok and not s2_ok:
        return EvaluationResult(None, None, 1.0, False, True, "both failed validation")
    if not s1_ok or not s2_ok:
        winner = sub1 if s1_ok else sub2
        loser = sub2 if s1_ok else sub1
        # Sole valid model still faces verification with certainty-ish prior:
        pv = sole_submission_verification_probability(credit1, credit2)
        return _verify(winner, loser, pv, rng, deviation_tol, reverify)

    # -- selection: lower perplexity wins ------------------------------------
    if sub1.perplexity <= sub2.perplexity:
        winner, loser = sub1, sub2
    else:
        winner, loser = sub2, sub1

    pv = verification_probability(credit1, credit2, sub1.perplexity, sub2.perplexity)
    return _verify(winner, loser, pv, rng, deviation_tol, reverify)


def _verify(winner, loser, pv, rng, tol, reverify) -> EvaluationResult:
    """Sample s ~ U[0,1]; verification occurs with probability p_v.

    Note: §2.5.5 of the paper says "if s > p_v, verification occurs", which
    contradicts §2.5.1 ("high seller credit scores and high perplexity match
    REDUCE the probability of verification") — Eq. (6) *is* the verification
    probability, so the comparison in §2.5.5 is a typo; we implement
    P(verify) = p_v, i.e. verify when s < p_v, matching Eq. (6) semantics.
    """
    s = rng.uniform(0.0, 1.0)
    do_verify = s < pv
    if not do_verify:
        return EvaluationResult(winner, loser, pv, False, False, "accepted unverified")

    post = (
        reverify(winner)
        if reverify is not None
        else (
            winner.converged_perplexity
            if winner.converged_perplexity is not None
            else winner.perplexity
        )
    )
    deviation = abs(post - winner.perplexity) / max(winner.perplexity, 1e-9)
    if deviation > tol:
        # Phony/unconverged submission: reject it and promote the runner-up.
        # This is how "the credit distribution shifts from the bad to good
        # users" (§2.5.2) — settlement then transfers cheat → runner-up.
        promoted = loser if (loser is not None and loser.valid) else None
        return EvaluationResult(
            promoted, winner, pv, True, True,
            f"rejected: deviation {deviation:.3f}; runner-up promoted",
        )
    return EvaluationResult(winner, loser, pv, True, False, "accepted verified")
