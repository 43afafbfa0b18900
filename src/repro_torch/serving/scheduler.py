"""Wave scheduling shared by every serving engine.

Serving engines share one loop — submit requests, bucket them by a
compatibility key, drain each bucket in bounded waves (the reference's
`repro.serving.scheduler`). The topic-model `serving.TopicEngine` buckets
by the full fit parameterization, so a wave of product fits can share one
batched `fit_batch` call; the transformer `Engine` of the reference is not
ported yet.

Subclasses implement `bucket_key(request)` and `_run_wave(wave)`; everything
about queueing and wave formation lives here.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Hashable


class WaveScheduler:
    """Submit/bucket/drain scheduling over homogeneous waves."""

    def __init__(self, *, max_batch: int = 8):
        self.max_batch = max_batch
        self.queue: list[Any] = []

    # -- subclass surface --------------------------------------------------

    def bucket_key(self, request) -> Hashable:
        """Requests with equal keys may share a wave. Keys must sort."""
        raise NotImplementedError

    def _run_wave(self, wave: list) -> list:
        """Serve one wave (at most `max_batch` same-bucket requests)."""
        raise NotImplementedError

    def _validate(self, request) -> None:
        """Admission check; raise to reject a request at submit time."""

    # -- shared loop -------------------------------------------------------

    def submit(self, request) -> None:
        self._validate(request)
        self.queue.append(request)

    def pending(self) -> int:
        return len(self.queue)

    def run(self) -> list:
        """Drain the queue: bucket, then serve each bucket in waves."""
        buckets: dict[Hashable, list] = defaultdict(list)
        for r in self.queue:
            buckets[self.bucket_key(r)].append(r)
        self.queue.clear()

        results = []
        for key in sorted(buckets):
            reqs = buckets[key]
            for i in range(0, len(reqs), self.max_batch):
                results.extend(self._run_wave(reqs[i : i + self.max_batch]))
        return results
