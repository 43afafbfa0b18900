"""Client-backed `SellerRuntime` — sellers speak the Vedalia protocol.

The marketplace's real-sampling runtime used to hand-wire `sampler.run`
against locally-held prepared corpora. Here a seller device is modeled the
way the serving architecture intends: the buyer's corpus is prepared once
server-side (`client.prepare` -> corpus_id), and each matched seller fits
it *by reference* through the versioned protocol (`client.fit_prepared`),
returning a `Submission` whose payload is the fitted model's handle_id.
The winner's handle IS the served model — no state re-upload — and losing
handles are released to free server memory.

Heterogeneous device speed maps to sweep budget exactly as before: a slow
seller runs fewer sweeps and reports a worse perplexity.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.api.client import VedaliaClient
from repro_torch.chital.matching import BuyerRequest, Seller
from repro_torch.chital.verification import Submission


def client_runtime(
    client: VedaliaClient,
    corpus_ids: dict[int, int],
    *,
    max_sweeps: int = 40,
    min_sweeps: int = 5,
    backend: Optional[str] = None,
):
    """Build a `SellerRuntime` that fits through the Vedalia protocol.

    `corpus_ids` maps buyer_id -> server-side corpus_id (from
    `client.prepare`). The returned runtime satisfies
    `repro_torch.chital.marketplace.SellerRuntime`.
    """

    def runtime(seller: Seller, buyer: BuyerRequest) -> Submission:
        sweeps = max(min_sweeps, min(max_sweeps, int(seller.speed / 400)))
        fit = client.fit_prepared(
            corpus_ids[buyer.buyer_id],
            backend=backend,
            num_sweeps=sweeps,
            seed=seller.seller_id,
        )
        return Submission(
            seller_id=seller.seller_id,
            perplexity=fit.perplexity,
            tokens_processed=buyer.task_tokens,
            iterations=sweeps,
            payload=fit.handle_id,  # the served model, by reference
            converged_perplexity=fit.perplexity,  # honest sellers
        )

    return runtime


def release_losers(client: VedaliaClient, result) -> None:
    """Free the losing submission's server-side handle after evaluation."""
    if result.loser is not None and result.loser.payload is not None:
        client.release(int(result.loser.payload))
