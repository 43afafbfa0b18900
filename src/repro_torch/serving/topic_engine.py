"""Batched multi-product topic-model serving through the wave scheduler.

Vedalia's workload is many *products*, each wanting an RLDA fit and a
streamed model view. `TopicEngine` (the reference's
`repro.serving.topic_engine`) queues `FitRequest`s, buckets them by their
full fit parameterization, and drains each wave through one shared
`VedaliaClient` — every fit and view crosses the versioned wire protocol,
so the engine exercises exactly what a remote deployment would.

A wave of more than one request whose backend routes to the batched
engine ("auto" or "batched") is served by ONE `fit_batch` protocol call:
the server stacks the models and runs them through `serving.batch_engine`
and the `batched` sampler, one batched kernel launch a sweep for the
bucket. Other waves keep the per-request path. `fit_many` is the
submit+drain convenience over that.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from repro_torch.api.backends import ORACLE
from repro_torch.api.client import FitResult, VedaliaClient, ViewResult
from repro_torch.api.protocol import RemoteError
from repro_torch.api.service import FitRequest
from repro_torch.serving.scheduler import WaveScheduler


@dataclasses.dataclass
class TopicResult:
    uid: int
    fit: FitResult  # handle_id, resolved backend, num_topics, ...
    view: ViewResult
    perplexity: float
    fit_s: float

    @property
    def handle_id(self) -> int:
        return self.fit.handle_id


class TopicEngine(WaveScheduler):
    """Fit-and-view serving for batches of products (protocol-backed)."""

    def __init__(
        self,
        client: Optional[VedaliaClient] = None,
        *,
        max_batch: int = 4,
        backend: str = ORACLE,
        num_sweeps: int = 20,
    ):
        super().__init__(max_batch=max_batch)
        self.client = client or VedaliaClient(backend=backend, num_sweeps=num_sweeps)
        self.default_backend = self.client.hello().default_backend

    def _validate(self, req: FitRequest) -> None:
        if not len(req.reviews):
            raise ValueError(f"request {req.uid}: empty review set")

    def bucket_key(self, req: FitRequest):
        # The full fit parameterization: requests sharing a key are
        # batch-compatible, which is what lets `_run_wave` serve a whole
        # wave with one `fit_batch` call. None-able ints map to -1 so keys
        # stay sortable (the scheduler sorts buckets).
        def opt(v):
            return -1 if v is None else v

        return (
            req.num_topics,
            req.backend or self.default_backend,
            opt(req.base_vocab),
            req.alpha,
            req.beta,
            opt(req.w_bits),
            opt(req.num_sweeps),
        )

    def fit_many(self, requests: list[FitRequest]) -> list[TopicResult]:
        """Submit-and-drain convenience: fit a batch of products through
        wave scheduling (batched launches where buckets allow)."""
        for req in requests:
            self.submit(req)
        return self.run()

    def serve_views(self, handle_ids: list[int], *,
                    top_n: int = 10) -> dict[int, Optional[ViewResult]]:
        """Cursor-tracked view syncs for handles this engine did not fit.
        A handle that vanished mid-sync maps to None instead of aborting
        the whole wave."""
        out: dict[int, Optional[ViewResult]] = {}
        for hid in handle_ids:
            try:
                out[hid] = self.client.sync_view(hid, top_n=top_n)
            except RemoteError as e:
                if e.code != "not_found":
                    raise
                out[hid] = None
        return out

    def _run_wave(self, wave: list[FitRequest]) -> list[TopicResult]:
        backend = wave[0].backend or self.default_backend
        if len(wave) > 1 and backend in ("auto", "batched"):
            return self._run_batched_wave(wave, backend)
        results = []
        for req in wave:
            t0 = time.perf_counter()
            fit = self.client.fit(
                req.reviews,
                num_topics=req.num_topics,
                base_vocab=req.base_vocab,
                alpha=req.alpha,
                beta=req.beta,
                w_bits=req.w_bits,
                backend=req.backend,
                num_sweeps=req.num_sweeps,
            )
            view = self.client.sync_view(fit.handle_id, top_n=req.top_n)
            results.append(TopicResult(uid=req.uid, fit=fit, view=view,
                                       perplexity=fit.perplexity,
                                       fit_s=time.perf_counter() - t0))
        return results

    def _run_batched_wave(self, wave: list[FitRequest],
                          backend: str) -> list[TopicResult]:
        """One `fit_batch` call for the whole wave (the bucket key
        guarantees the requests share every fit parameter). `fit_s` is the
        amortized per-model share of the batch wall time."""
        t0 = time.perf_counter()
        fits = self.client.fit_batch(
            [req.reviews for req in wave],
            num_topics=wave[0].num_topics,
            base_vocab=wave[0].base_vocab,
            alpha=wave[0].alpha,
            beta=wave[0].beta,
            w_bits=wave[0].w_bits,
            backend=backend,
            num_sweeps=wave[0].num_sweeps,
        )
        fit_s = (time.perf_counter() - t0) / len(wave)
        return [
            TopicResult(uid=req.uid, fit=fit,
                        view=self.client.sync_view(fit.handle_id, top_n=req.top_n),
                        perplexity=fit.perplexity, fit_s=fit_s)
            for req, fit in zip(wave, fits)
        ]
