"""Zero-sum credit system (paper §2.5.2).

    "A 0-sum credit system is established ... each user that joins the system
     as a seller begins with 0 credit. When building a model, the
     perplexities of each of the two models returned by the sellers are
     compared; a credit from the worst model's seller is then transferred to
     the best model's seller."

Invariant (property-tested): Σ credits = 0 at all times. Honest sellers have
zero expected drift; dishonest sellers leak credit to honest ones, which via
Eq. (6) lowers verification cost for good users and raises it for bad ones.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict


@dataclasses.dataclass
class CreditLedger:
    credits: dict[int, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float)
    )

    def register(self, seller_id: int) -> None:
        self.credits.setdefault(seller_id, 0.0)

    def get(self, seller_id: int) -> float:
        return self.credits.get(seller_id, 0.0)

    def transfer(self, from_seller: int, to_seller: int, amount: float = 1.0) -> None:
        """Move `amount` credit loser -> winner (the paper uses 1 credit)."""
        self.register(from_seller)
        self.register(to_seller)
        self.credits[from_seller] -= amount
        self.credits[to_seller] += amount

    def total(self) -> float:
        """Zero-sum invariant: always 0 (up to float round-off)."""
        return sum(self.credits.values())

    def settle_pair(self, winner_id: int, loser_id: int) -> None:
        """Apply the per-task settlement of §2.5.2."""
        if winner_id != loser_id:
            self.transfer(loser_id, winner_id, 1.0)
