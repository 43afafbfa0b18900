"""`VedaliaClient` — the thin device-side end of the Vedalia protocol.

The client owns no model state: it turns method calls into request
envelopes, hands them to a *transport* (`str -> str`), and parses the
response envelopes back into small typed results. The default transport is
in-process — a `VedaliaServer` constructed (or passed) right here — but
anything that moves strings (a socket, an HTTP POST) slots in unchanged:

    client = VedaliaClient(backend="cuda")            # in-process server
    client = VedaliaClient(device="cpu")              # ... on the CPU
    client = VedaliaClient(transport=post_to_server)  # the same API, remote

The in-process server runs on CUDA unless `device="cpu"` is passed, and
raises when CUDA is absent. The remote server may be either package's.

Bandwidth-frugal sync (§4.2): `sync_view` keeps one cursor per handle, so
the first call streams the full view and every later call streams only the
topics that drifted since — `ViewResult.payload_bytes` is the actual wire
size either way.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch.api import protocol
from repro_torch.api.server import VedaliaServer
from repro_torch.core import codec as codec_lib
from repro_torch.core.rlda import Review
from repro_torch.core.types import Corpus, LDAConfig, LDAState, corpus_from_numpy
from repro_torch.core.views import ModelView, TopicView, decode_topic_q
from repro_torch.core.quant import QuantSpec
from repro_torch.obs import trace

Transport = Callable[[str], str]


def _upload_spec(quant: Optional[str]):
    """A `quant` keyword ("int8" / "int4_packed" / None) -> QuantSpec or
    None, validated client-side so a typo fails before anything ships."""
    return None if quant is None else QuantSpec.from_wire(quant)


@dataclasses.dataclass(frozen=True)
class ServerInfo:
    protocol_version: int
    backends: list[str]
    capabilities: dict[str, dict]
    default_backend: str


@dataclasses.dataclass(frozen=True)
class PrepareResult:
    corpus_id: int
    num_reviews: int
    num_tokens: int


@dataclasses.dataclass(frozen=True)
class FitResult:
    handle_id: int
    backend: str
    num_topics: int
    num_reviews: int
    sweeps_run: int
    perplexity: float


@dataclasses.dataclass(frozen=True)
class UpdateResult:
    handle_id: int
    num_new_reviews: int
    kind: str  # "incremental" | "full_recompute" | "noop" (empty drain)
    perplexity: float
    backend: str
    drained: int = 0  # queued-ingest reviews folded into this update


@dataclasses.dataclass(frozen=True)
class IngestResult:
    """Ack for one queued ingest batch.

    `acked` is the server's cumulative ack cursor for the handle: the total
    number of reviews accepted so far, monotonic and session-independent —
    a client that is evicted and resyncs never loses acked reviews.
    """

    handle_id: int
    acked: int
    queued: int


@dataclasses.dataclass(frozen=True)
class StatsResult:
    """Server observability counters (`stats` verb)."""

    num_sessions: int
    num_handles: int
    num_corpora: int
    ingest_queued: dict[int, int]  # handle_id -> queued depth
    ingest_acked: dict[int, int]  # handle_id -> ack cursor
    total_queued: int
    max_ingest_queue: int


@dataclasses.dataclass(frozen=True)
class ViewResult:
    """One streamed (full or delta) model view.

    `topics` holds only the transmitted topics: all current core-set topics
    on a full sync, the drifted ones on a delta. `topic_ids` always lists
    the current core set; `removed_topic_ids` tells the device which
    locally-cached topics to drop.
    """

    handle_id: int
    topic_ids: list[int]
    topics: list[TopicView]
    removed_topic_ids: list[int]
    delta: bool
    resync: bool
    cursor: Optional[str]
    valid: bool
    payload: str  # the raw response envelope — the bytes on the wire

    @property
    def payload_bytes(self) -> int:
        return len(self.payload)

    @property
    def view(self) -> ModelView:
        return ModelView(topics=self.topics)


@dataclasses.dataclass(frozen=True)
class ExportedModel:
    """A served model checked out for device-local computation
    (`export_model`): enough to warm-start any sampler backend on the
    device and compute real perplexity locally. Tensors are on the CPU."""

    handle_id: int
    cfg: LDAConfig
    corpus: Corpus
    state: LDAState  # stored units (fixed point when cfg.w_bits is set)
    base_vocab: int
    sweeps_run: int
    num_tokens: int


@dataclasses.dataclass(frozen=True)
class SpotCheckResult:
    """Server verdict on an uploaded state (`spot_check`).

    `state_perplexity` is the server's own recomputation (the claim is
    never trusted); `post_perplexity` is set when the server ran re-Gibbs
    sweeps on a throwaway copy (the real Eq. (6) `reverify`).
    """

    handle_id: int
    valid: bool
    reason: str
    state_perplexity: Optional[float]
    post_perplexity: Optional[float]
    deviation: Optional[float]


@dataclasses.dataclass(frozen=True)
class MetricsResult:
    """The server process's metrics registry (`metrics` verb).

    `enabled` reports the server's obs switch — a disabled server answers
    with an empty snapshot, not an error. `exposition` carries the
    Prometheus text rendering when requested with `format="prometheus"`.
    """

    enabled: bool
    metrics: dict
    exposition: Optional[str]


@dataclasses.dataclass(frozen=True)
class TopReviewsResult:
    handle_id: int
    topic_id: int
    review_ids: list[int]


class VedaliaClient:
    """Speak the versioned Vedalia protocol through any string transport."""

    def __init__(
        self,
        transport: Optional[Transport] = None,
        *,
        server: Optional[VedaliaServer] = None,
        **server_kwargs,
    ):
        if transport is None:
            server = server or VedaliaServer(**server_kwargs)
            transport = server.handle_raw
        elif server_kwargs:
            raise ValueError(
                "server_kwargs only apply to the in-process transport")
        self.server = server  # None for remote transports
        self._transport = transport
        self.session_id: Optional[str] = None
        self.cursors: dict[int, str] = {}  # handle_id -> last synced cursor

    # -- plumbing -----------------------------------------------------------

    @property
    def transport(self) -> Transport:
        """The underlying `str -> str` transport — share it to point more
        clients (e.g. a simulated device fleet) at the same server."""
        return self._transport

    def rebind(
        self,
        transport: Optional[Transport] = None,
        *,
        server: Optional[VedaliaServer] = None,
    ) -> None:
        """Point this client at a restarted/restored server.

        The session and cursors are kept: the restored server won't know
        them, so the first view after a rebind degrades to one full resync
        through the existing recovery path — never an error, and handle ids
        stay valid because `stream.snapshot` restores them verbatim.
        """
        if (transport is None) == (server is None):
            raise ValueError("rebind() needs exactly one of transport/server")
        self.server = server
        self._transport = transport if transport is not None \
            else server.handle_raw

    def _call(self, kind: str, payload: Optional[dict] = None) -> dict:
        # The wire context is computed *inside* the call span, so the
        # server's dispatch span hangs off this client call — one trace id
        # from device method to server verb, across any transport.
        with trace.span(f"client.{kind}"):
            raw = self._transport(protocol.make_request(
                kind, payload, trace=trace.wire_context()))
        return protocol.parse_response(raw, expect_kind=kind)

    def _ensure_session(self) -> str:
        if self.session_id is None:
            self.session_id = self._call("open_session")["session_id"]
        return self.session_id

    # -- handshake ----------------------------------------------------------

    def hello(self) -> ServerInfo:
        p = self._call("hello")
        return ServerInfo(
            protocol_version=p["protocol_version"],
            backends=list(p["backends"]),
            capabilities=dict(p["capabilities"]),
            default_backend=p["default_backend"],
        )

    # -- model lifecycle -----------------------------------------------------

    def prepare(
        self,
        reviews: Sequence[Review],
        *,
        base_vocab: int,
        num_topics: int = 12,
        alpha: float = 0.1,
        beta: float = 0.01,
        w_bits: Optional[int] = 8,
    ) -> PrepareResult:
        """Server-side §4.3 preparation; the returned corpus_id lets
        sellers fit by reference instead of re-shipping the tokens.
        Preparation is deterministic — seeds only enter at fit time."""
        p = self._call("prepare", {
            "reviews": protocol.encode_reviews(reviews),
            "base_vocab": base_vocab,
            "num_topics": num_topics,
            "alpha": alpha,
            "beta": beta,
            "w_bits": w_bits,
        })
        return PrepareResult(
            corpus_id=int(p["corpus_id"]),
            num_reviews=int(p["num_reviews"]),
            num_tokens=int(p["num_tokens"]),
        )

    def _fit_result(self, p: dict) -> FitResult:
        return FitResult(
            handle_id=int(p["handle_id"]),
            backend=p["backend"],
            num_topics=int(p["num_topics"]),
            num_reviews=int(p["num_reviews"]),
            sweeps_run=int(p["sweeps_run"]),
            perplexity=float(p["perplexity"]),
        )

    def fit(
        self,
        reviews: Sequence[Review],
        *,
        num_topics: int = 12,
        base_vocab: Optional[int] = None,
        alpha: float = 0.1,
        beta: float = 0.01,
        w_bits: Optional[int] = 8,
        backend: Optional[str] = None,
        num_sweeps: Optional[int] = None,
        seed: Optional[int] = None,
        device_kind: Optional[str] = None,
    ) -> FitResult:
        return self._fit_result(self._call("fit", {
            "reviews": protocol.encode_reviews(reviews),
            "num_topics": num_topics,
            "base_vocab": base_vocab,
            "alpha": alpha,
            "beta": beta,
            "w_bits": w_bits,
            "backend": backend,
            "num_sweeps": num_sweeps,
            "seed": seed,
            "device_kind": device_kind,
        }))

    def fit_batch(
        self,
        review_sets: Sequence[Sequence[Review]],
        *,
        num_topics: int = 12,
        base_vocab: Optional[int] = None,
        alpha: float = 0.1,
        beta: float = 0.01,
        w_bits: Optional[int] = 8,
        backend: Optional[str] = None,
        num_sweeps: Optional[int] = None,
        seed: Optional[int] = None,
        device_kind: Optional[str] = None,
    ) -> list[FitResult]:
        """Fit one model per review set in one request; the server batches
        compatible models into shared sampler launches (the `batched`
        backend) and answers with one `FitResult` per set, in order."""
        p = self._call("fit_batch", {
            "review_sets": [protocol.encode_reviews(rs)
                            for rs in review_sets],
            "num_topics": num_topics,
            "base_vocab": base_vocab,
            "alpha": alpha,
            "beta": beta,
            "w_bits": w_bits,
            "backend": backend,
            "num_sweeps": num_sweeps,
            "seed": seed,
            "device_kind": device_kind,
        })
        return [self._fit_result(f) for f in p["fits"]]

    def refine_batch(
        self,
        handle_ids: Sequence[int],
        num_sweeps: int,
        *,
        backend: Optional[str] = None,
        seed: Optional[int] = None,
    ) -> list[FitResult]:
        """Continue sampling several handles in one request — the wire
        face of coalesced refits (stack-compatible handles share one
        batched launch server-side)."""
        p = self._call("refine_batch", {
            "handle_ids": [int(h) for h in handle_ids],
            "num_sweeps": num_sweeps,
            "backend": backend,
            "seed": seed,
        })
        return [self._fit_result(f) for f in p["fits"]]

    def fit_prepared(
        self,
        corpus_id: int,
        *,
        backend: Optional[str] = None,
        num_sweeps: Optional[int] = None,
        seed: Optional[int] = None,
        device_kind: Optional[str] = None,
    ) -> FitResult:
        return self._fit_result(self._call("fit_prepared", {
            "corpus_id": corpus_id,
            "backend": backend,
            "num_sweeps": num_sweeps,
            "seed": seed,
            "device_kind": device_kind,
        }))

    def adopt(
        self,
        corpus_id: int,
        state,
        *,
        backend: Optional[str] = None,
        sweeps_run: int = 0,
    ) -> FitResult:
        """Upload an externally-fitted `LDAState` (in *stored* units — fixed
        point when the corpus was prepared with w_bits) against a prepared
        corpus; the server wraps it into a served handle."""
        return self._fit_result(self._call("adopt", {
            "corpus_id": corpus_id,
            "state": {
                "z": protocol.encode_array(state.z),
                "n_dt": protocol.encode_array(state.n_dt),
                "n_wt": protocol.encode_array(state.n_wt),
                "n_t": protocol.encode_array(state.n_t),
            },
            "backend": backend,
            "sweeps_run": sweeps_run,
        }))

    # -- offload tier --------------------------------------------------------

    def export_model(self, handle_id: int,
                     *, quant: Optional[str] = None) -> ExportedModel:
        """Check a served model out for local computation: config, corpus
        and current state cross the wire; the handle keeps serving.

        `quant` ("int8" / "int4_packed") asks the server to pack the big
        count tables. The download shrinks by ~4x/8x; the returned state is
        still *exact* because `z` ships raw and the counts are scatter-
        rebuilt from it locally (same rule the server applies to quantized
        uploads).
        """
        payload: dict = {"handle_id": handle_id}
        if quant is not None:
            payload["quant"] = quant
        p = self._call("export_model", payload)
        c = p["cfg"]
        cfg = LDAConfig(
            num_topics=int(c["num_topics"]),
            vocab_size=int(c["vocab_size"]),
            num_docs=int(c["num_docs"]),
            alpha=float(c["alpha"]),
            beta=float(c["beta"]),
            w_bits=None if c["w_bits"] is None else int(c["w_bits"]),
        )
        corpus: Corpus = corpus_from_numpy(
            *(protocol.decode_array(p["corpus"][f])
              for f in ("docs", "words", "weights")),
            device="cpu")
        arrays = protocol.decode_state_arrays(p["state"])
        if protocol.state_arrays_quantized(p["state"]):
            state = codec_lib.rebuild_state(
                cfg, corpus, torch.as_tensor(arrays["z"]).to(torch.int32))
        else:
            state = LDAState(**{name: torch.as_tensor(arrays[name])
                                for name in protocol.STATE_FIELDS})
        return ExportedModel(
            handle_id=int(p["handle_id"]), cfg=cfg, corpus=corpus,
            state=state, base_vocab=int(p["base_vocab"]),
            sweeps_run=int(p["sweeps_run"]),
            num_tokens=int(p["num_tokens"]),
        )

    def spot_check(
        self,
        handle_id: int,
        state,
        *,
        claimed_perplexity: Optional[float] = None,
        num_sweeps: int = 0,
        claim_tol: float = 0.01,
        backend: Optional[str] = None,
        seed: Optional[int] = None,
        quant: Optional[str] = None,
    ) -> SpotCheckResult:
        """Ask the server to validate (and optionally re-Gibbs) a locally
        computed state for `handle_id` without adopting it. `quant` packs
        the uploaded count tables (the server rebuilds exact counts from
        the raw `z` before validating)."""
        p = self._call("spot_check", {
            "handle_id": handle_id,
            "state": protocol.encode_state_arrays(
                state, spec=_upload_spec(quant)),
            "claimed_perplexity": claimed_perplexity,
            "num_sweeps": num_sweeps,
            "claim_tol": claim_tol,
            "backend": backend,
            "seed": seed,
        })
        return SpotCheckResult(
            handle_id=int(p["handle_id"]),
            valid=bool(p["valid"]),
            reason=str(p["reason"]),
            state_perplexity=None if p["state_perplexity"] is None
            else float(p["state_perplexity"]),
            post_perplexity=None if p["post_perplexity"] is None
            else float(p["post_perplexity"]),
            deviation=None if p["deviation"] is None
            else float(p["deviation"]),
        )

    def adopt_state(
        self, handle_id: int, state, *, sweeps_run: int = 0,
        quant: Optional[str] = None,
    ) -> FitResult:
        """Swap a device-computed state (stored units) into the *existing*
        served handle; the server re-validates before adopting. `quant`
        packs the uploaded count tables (the server rebuilds exact counts
        from the raw `z` before validating)."""
        return self._fit_result(self._call("adopt_state", {
            "handle_id": handle_id,
            "state": protocol.encode_state_arrays(
                state, spec=_upload_spec(quant)),
            "sweeps_run": sweeps_run,
        }))

    def refine(
        self,
        handle_id: int,
        num_sweeps: int,
        *,
        backend: Optional[str] = None,
        seed: Optional[int] = None,
    ) -> FitResult:
        return self._fit_result(self._call("refine", {
            "handle_id": handle_id,
            "num_sweeps": num_sweeps,
            "backend": backend,
            "seed": seed,
        }))

    def update(
        self,
        handle_id: int,
        reviews: Sequence[Review] = (),
        *,
        update_sweeps: Optional[int] = None,
        seed: Optional[int] = None,
        backend: Optional[str] = None,
        drain: bool = False,
    ) -> UpdateResult:
        """Apply new reviews incrementally. `drain=True` additionally folds
        the handle's queued-ingest reviews (everything acked but not yet
        applied) into this update, ahead of `reviews`."""
        p = self._call("update", {
            "handle_id": handle_id,
            "reviews": protocol.encode_reviews(reviews),
            "update_sweeps": update_sweeps,
            "seed": seed,
            "backend": backend,
            "drain": drain,
        })
        return UpdateResult(
            handle_id=int(p["handle_id"]),
            num_new_reviews=int(p["num_new_reviews"]),
            kind=p["kind"],
            # An empty drain ("noop") skips the model evaluation and sends
            # null — surface it as NaN, not a made-up number.
            perplexity=float("nan") if p["perplexity"] is None
            else float(p["perplexity"]),
            backend=p["backend"],
            drained=int(p.get("drained", 0)),
        )

    def ingest(self, handle_id: int, reviews: Sequence[Review]) -> IngestResult:
        """Queue reviews against a handle (streaming ingestion). Returns the
        server's cumulative ack cursor; raises `RemoteError` with code
        ``overloaded`` when the bounded queue rejects the batch."""
        p = self._call("ingest", {
            "handle_id": handle_id,
            "reviews": protocol.encode_reviews(reviews),
        })
        return IngestResult(
            handle_id=int(p["handle_id"]),
            acked=int(p["acked"]),
            queued=int(p["queued"]),
        )

    # -- serving -------------------------------------------------------------

    def view(
        self,
        handle_id: int,
        *,
        since: Optional[str] = None,
        top_n: int = 10,
        topics: Optional[Sequence[int]] = None,
        mass_coverage: float = 0.9,
        max_topics: Optional[int] = None,
        rel_mass_tol: Optional[float] = None,
        weight_tol: Optional[float] = None,
        quant: Optional[str] = None,
    ) -> ViewResult:
        """One view sync. `since=None` -> full view; `since=<cursor>` ->
        delta against that cursor. Either way the response carries the next
        cursor (when a session exists).

        `quant` ("int8" / "int4_packed") opts this sync into the
        version-2 quantized topic payload: word weights arrive as packed
        codes + one scale per topic, decoded transparently here. Delta
        semantics are unchanged — drift is judged server-side on exact
        weights.
        """
        payload = {
            "handle_id": handle_id,
            "session_id": self._ensure_session(),
            "since": since,
            "top_n": top_n,
            "topics": list(topics) if topics is not None else None,
            "mass_coverage": mass_coverage,
            "max_topics": max_topics,
        }
        if rel_mass_tol is not None:
            payload["rel_mass_tol"] = rel_mass_tol
        if weight_tol is not None:
            payload["weight_tol"] = weight_tol
        if quant is not None:
            payload["quant"] = _upload_spec(quant).to_wire()
        with trace.span("client.view"):
            raw = self._transport(protocol.make_request(
                "view", payload, trace=trace.wire_context()))
        try:
            p = protocol.parse_response(raw, expect_kind="view")
        except protocol.RemoteError as e:
            # A restarted/evicted server no longer knows our session: open
            # a fresh one and resend. The lost cursor degrades this (and
            # any later stale-cursor) sync to a full resync, never an error.
            if e.code != "not_found" or "session_id" not in str(e):
                raise
            self.session_id = None
            payload["session_id"] = self._ensure_session()
            with trace.span("client.view", retry=True):
                raw = self._transport(protocol.make_request(
                    "view", payload, trace=trace.wire_context()))
            p = protocol.parse_response(raw, expect_kind="view")
        resp_mode = p.get("quant")
        if resp_mode is not None:
            bits = QuantSpec.from_wire(resp_mode).bits
            topics_out = [decode_topic_q(d, bits) for d in p["topics"]]
        else:
            topics_out = [TopicView(**d) for d in p["topics"]]
        result = ViewResult(
            handle_id=int(p["handle_id"]),
            topic_ids=[int(t) for t in p["topic_ids"]],
            topics=topics_out,
            removed_topic_ids=[int(t) for t in p["removed_topic_ids"]],
            delta=bool(p["delta"]),
            resync=bool(p["resync"]),
            cursor=p.get("cursor"),
            valid=bool(p["valid"]),
            payload=raw,
        )
        if result.cursor is not None:
            self.cursors[result.handle_id] = result.cursor
        return result

    def sync_view(self, handle_id: int, **kwargs) -> ViewResult:
        """Cursor-tracking view: full on first call, delta afterwards."""
        return self.view(
            handle_id, since=self.cursors.get(handle_id), **kwargs)

    def top_reviews(
        self, handle_id: int, topic_id: int, n: int = 5
    ) -> TopReviewsResult:
        p = self._call("top_reviews", {
            "handle_id": handle_id, "topic_id": topic_id, "n": n})
        return TopReviewsResult(
            handle_id=int(p["handle_id"]),
            topic_id=int(p["topic_id"]),
            review_ids=[int(d) for d in p["review_ids"]],
        )

    def perplexity(
        self, handle_id: int, reviews: Optional[Sequence[Review]] = None
    ) -> float:
        """Training-corpus perplexity, or — with `reviews` — held-out
        perplexity of those reviews under the handle's current model."""
        payload: dict = {"handle_id": handle_id}
        if reviews is not None:
            payload["reviews"] = protocol.encode_reviews(reviews)
        return float(self._call("perplexity", payload)["perplexity"])

    def metrics(self, format: str = "dict") -> MetricsResult:
        """Fetch the server's metrics registry. An old server that predates
        the verb answers `bad_request` ("unknown request kind"), which
        surfaces as the usual typed `RemoteError` — no special casing."""
        p = self._call("metrics", {"format": format})
        return MetricsResult(
            enabled=bool(p["enabled"]),
            metrics=dict(p["metrics"]),
            exposition=p.get("exposition"),
        )

    def stats(self) -> StatsResult:
        p = self._call("stats")
        return StatsResult(
            num_sessions=int(p["num_sessions"]),
            num_handles=int(p["num_handles"]),
            num_corpora=int(p["num_corpora"]),
            ingest_queued={int(k): int(v)
                           for k, v in p["ingest_queued"].items()},
            ingest_acked={int(k): int(v)
                          for k, v in p["ingest_acked"].items()},
            total_queued=int(p["total_queued"]),
            max_ingest_queue=int(p["max_ingest_queue"]),
        )

    def release(self, handle_id: int) -> None:
        self._call("release", {"handle_id": handle_id})
        self.cursors.pop(handle_id, None)

    def release_corpus(self, corpus_id: int) -> None:
        """Free a server-side prepared corpus (live handles are unaffected —
        they hold their own reference)."""
        self._call("release_corpus", {"corpus_id": corpus_id})

    def close(self) -> None:
        """Close the server-side session (cursors die with it). A session
        the server already evicted counts as closed."""
        if self.session_id is not None:
            try:
                self._call("close_session",
                           {"session_id": self.session_id})
            except protocol.RemoteError as e:
                if e.code != "not_found":
                    raise
            finally:
                self.session_id = None
                self.cursors.clear()
