"""Lottery incentive system (paper §2.5.2, §2.5.4).

Winning seller of each task earns  t · i*  tickets (t = tokens processed,
i* = sampling iterations of the best model). At the end of a lottery period
a winner is drawn with probability proportional to ticket count and receives
the full pot (a slice of ad revenue). Optional by design — §2.5.4 notes a
strategyproof matching mechanism alone suffices for rational participation.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np


def tickets_for(tokens_processed: int, iterations: int) -> int:
    """Paper §2.5.2: t · i* tickets to the winning seller."""
    return int(tokens_processed) * int(iterations)


@dataclasses.dataclass
class Lottery:
    tickets: dict[int, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int)
    )

    def award(self, seller_id: int, tokens_processed: int, iterations: int) -> int:
        n = tickets_for(tokens_processed, iterations)
        self.tickets[seller_id] += n
        return n

    def draw(self, rng: np.random.Generator, pot: float) -> tuple[int | None, float]:
        """End-of-period draw; resets tickets. Returns (winner, amount)."""
        if not self.tickets:
            return None, 0.0
        ids = list(self.tickets)
        counts = np.array([self.tickets[i] for i in ids], dtype=np.float64)
        if counts.sum() <= 0:
            return None, 0.0
        winner = ids[int(rng.choice(len(ids), p=counts / counts.sum()))]
        self.tickets.clear()
        return winner, pot
