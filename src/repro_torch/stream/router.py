"""`StreamRouter` — consistent-hash sharding of products over servers.

The parameter-server layout of Li et al. (2015) applied to Vedalia: each
product's model lives on exactly one `VedaliaServer` shard, chosen by
consistent hashing so that adding or removing a shard remaps only ~1/N of
the products (a mod-N hash would reshuffle nearly all of them, invalidating
every shard's warm model state).

Each shard gets a bounded FIFO of pending :class:`ReviewEvent`s. When a
queue is full the router applies one of two backpressure policies:

  drop_oldest  evict the oldest queued event to admit the new one — bounded
               memory, bounded staleness, lossy under sustained overload
               (the dropped count is the observable);
  block        refuse the new event (`offer` returns False) — lossless, the
               source must hold the event and re-offer after the scheduler
               drains the queue.

Hashing uses blake2b, not Python's salted `hash()`, so placement is stable
across processes — a restored shard owns exactly the products it owned
before the kill.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
from collections import deque
from typing import Optional

from repro_torch.stream.sources import ReviewEvent

POLICIES = ("drop_oldest", "block")


def _point(key: str) -> int:
    """Stable 64-bit ring position for a key."""
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")


@dataclasses.dataclass(frozen=True)
class RouterStats:
    routed: int  # events accepted into some queue
    dropped: int  # drop_oldest evictions
    refused: int  # block-policy refusals (the source must re-offer)
    depths: dict[int, int]  # shard -> current queue depth

    @property
    def total_queued(self) -> int:
        return sum(self.depths.values())


class StreamRouter:
    """Route review events to per-shard bounded queues by product id."""

    def __init__(
        self,
        shard_ids,
        *,
        capacity: int = 64,
        policy: str = "drop_oldest",
        vnodes: int = 64,
    ):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown backpressure policy {policy!r}; policies: {POLICIES}")
        if capacity < 1:
            raise ValueError("queue capacity must be >= 1")
        self.capacity = capacity
        self.policy = policy
        self.vnodes = vnodes
        self.queues: dict[int, deque[ReviewEvent]] = {}
        self._ring: list[tuple[int, int]] = []  # (point, shard), sorted
        self._routed = 0
        self._dropped = 0
        self._refused = 0
        for sid in shard_ids:
            self.add_shard(int(sid))
        if not self.queues:
            raise ValueError("router needs at least one shard")

    # -- membership ----------------------------------------------------------

    @property
    def shard_ids(self) -> list[int]:
        return sorted(self.queues)

    def add_shard(self, shard_id: int) -> None:
        if shard_id in self.queues:
            raise ValueError(f"shard {shard_id} already present")
        self.queues[shard_id] = deque()
        for v in range(self.vnodes):
            pair = (_point(f"shard:{shard_id}:{v}"), shard_id)
            bisect.insort(self._ring, pair)

    def remove_shard(self, shard_id: int) -> list[ReviewEvent]:
        """Drop a shard from the ring; returns its still-queued events so
        the caller can re-offer them (they now route to surviving shards)."""
        if shard_id not in self.queues:
            raise KeyError(f"unknown shard {shard_id}")
        orphaned = list(self.queues.pop(shard_id))
        self._ring = [(p, s) for p, s in self._ring if s != shard_id]
        return orphaned

    # -- routing -------------------------------------------------------------

    def route(self, product_id) -> int:
        """The shard that owns `product_id` (stable across processes)."""
        if not self._ring:
            raise RuntimeError("router has no shards")
        h = _point(f"product:{product_id}")
        i = bisect.bisect_right(self._ring, (h, -1))
        if i == len(self._ring):
            i = 0  # wrap around the ring
        return self._ring[i][1]

    def offer(self, event: ReviewEvent) -> bool:
        """Enqueue an event for its owning shard.

        Returns True when the event is queued. Under the ``block`` policy a
        full queue refuses the event (returns False) and the caller must
        re-offer it later; under ``drop_oldest`` the oldest queued event is
        evicted and this one always lands.
        """
        q = self.queues[self.route(event.product_id)]
        if len(q) >= self.capacity:
            if self.policy == "block":
                self._refused += 1
                return False
            q.popleft()
            self._dropped += 1
        q.append(event)
        self._routed += 1
        return True

    def drain(
        self, shard_id: int, max_events: Optional[int] = None
    ) -> list[ReviewEvent]:
        """Pop up to `max_events` queued events for a shard, FIFO."""
        q = self.queues[shard_id]
        n = len(q) if max_events is None else min(max_events, len(q))
        return [q.popleft() for _ in range(n)]

    def depth(self, shard_id: int) -> int:
        return len(self.queues[shard_id])

    def oldest_event_time(self, shard_id: int) -> Optional[float]:
        """Event time of the head of a shard's queue (staleness signal)."""
        q = self.queues[shard_id]
        return q[0].t if q else None

    def stats(self) -> RouterStats:
        return RouterStats(
            routed=self._routed,
            dropped=self._dropped,
            refused=self._refused,
            depths={sid: len(q) for sid, q in self.queues.items()},
        )
