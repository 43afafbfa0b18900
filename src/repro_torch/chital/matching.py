"""Real-time matching mechanisms (paper §2.5.3).

Buyers (queries) and sellers (opted-in devices) both arrive online; each
buyer must be matched to a *pair* of sellers; matched sellers become
temporarily unavailable "for a period of time based on the performance of
seller nodes and the task size of buyer node" before re-entering the pool.

Classic online bipartite matching (Karp–Vazirani–Vazirani 1990; Mehta 2013)
does not apply directly because of this extra time dimension and because the
objective is overall *user gain* (time saved vs. computing locally), so we
implement the suite the companion work (Robinson & Li, 2015) studies:

  RandomMatcher   uniform among available sellers (baseline)
  RankingMatcher  KVV-style: fixed random priority over sellers
  GreedyGainMatcher  pick the pair maximizing the buyer's time saved
                     (fastest available sellers first) — the gain-maximizing
                     mechanism; with truthful speed reports this is
                     strategyproof in the simulator's model: a seller cannot
                     improve its own completion times by misreporting.
"""

from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod

import numpy as np


@dataclasses.dataclass
class Seller:
    seller_id: int
    speed: float  # tokens/sec the device can sample
    busy_until: float = 0.0
    honest: bool = True

    def available(self, now: float) -> bool:
        return now >= self.busy_until


@dataclasses.dataclass
class BuyerRequest:
    buyer_id: int
    task_tokens: int  # task size (tokens × iterations)
    arrival: float
    local_speed: float  # what the buyer could do alone (gain baseline)


@dataclasses.dataclass
class Match:
    buyer: BuyerRequest
    sellers: tuple[Seller, Seller]
    expected_gain: float  # time saved vs. local computation


class Matcher(ABC):
    """Matches one buyer to a pair of available sellers (or defers)."""

    @abstractmethod
    def match(
        self, buyer: BuyerRequest, sellers: list[Seller], now: float,
        rng: np.random.Generator,
    ) -> Match | None:
        ...

    @staticmethod
    def _gain(buyer: BuyerRequest, pair: tuple[Seller, Seller]) -> float:
        """Time saved: local time minus the best seller's completion time.

        The buyer gets the *best* of the two models; response time is
        governed by the faster seller (the slower is redundancy/verification
        material), matching the marketplace's duplicate-task design.
        """
        local = buyer.task_tokens / max(buyer.local_speed, 1e-9)
        remote = buyer.task_tokens / max(max(p.speed for p in pair), 1e-9)
        return local - remote

    @staticmethod
    def busy_period(seller: Seller, buyer: BuyerRequest) -> float:
        """Unavailability window: task size over seller performance (§2.5.3)."""
        return buyer.task_tokens / max(seller.speed, 1e-9)


class RandomMatcher(Matcher):
    def match(self, buyer, sellers, now, rng):
        avail = [s for s in sellers if s.available(now)]
        if len(avail) < 2:
            return None
        i, j = rng.choice(len(avail), size=2, replace=False)
        pair = (avail[int(i)], avail[int(j)])
        return Match(buyer, pair, self._gain(buyer, pair))


class RankingMatcher(Matcher):
    """KVV Ranking adapted: a fixed random permutation ranks sellers; each
    buyer takes the two highest-ranked available sellers."""

    def __init__(self, seed: int = 0):
        self._rank: dict[int, float] = {}
        self._rng = np.random.default_rng(seed)

    def _rank_of(self, s: Seller) -> float:
        if s.seller_id not in self._rank:
            self._rank[s.seller_id] = float(self._rng.uniform())
        return self._rank[s.seller_id]

    def match(self, buyer, sellers, now, rng):  # noqa: ARG002 - Matcher interface
        avail = [s for s in sellers if s.available(now)]
        if len(avail) < 2:
            return None
        avail.sort(key=self._rank_of)
        pair = (avail[0], avail[1])
        return Match(buyer, pair, self._gain(buyer, pair))


class GreedyGainMatcher(Matcher):
    """Maximize the buyer's time saved: the two fastest available sellers."""

    def match(self, buyer, sellers, now, rng):  # noqa: ARG002 - Matcher interface
        avail = [s for s in sellers if s.available(now)]
        if len(avail) < 2:
            return None
        avail.sort(key=lambda s: -s.speed)
        pair = (avail[0], avail[1])
        return Match(buyer, pair, self._gain(buyer, pair))


MATCHERS = {
    "random": RandomMatcher,
    "ranking": RankingMatcher,
    "greedy_gain": GreedyGainMatcher,
}
