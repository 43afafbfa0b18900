"""`VedaliaServer` — the wire-facing side of the Vedalia protocol.

Owns the `VedaliaService` (handles, samplers), server-side prepared corpora
(so sellers can fit a buyer's corpus by id instead of re-shipping tokens),
and *sessions*: per-client state whose only job today is the **view
cursor** (§4.2 bandwidth).

Cursor lifecycle:

    view(since=None)    -> full view; response carries a fresh `cursor`
    view(since=cursor)  -> delta view: only topics whose mass or top words
                           drifted beyond the thresholds are transmitted,
                           plus the ids of topics that left the core set;
                           the response carries the next cursor
    unknown/expired cursor -> the server falls back to a full view and
                           flags it with `resync: true`

A cursor names a server-stored snapshot of per-topic signatures
(`views.topic_signature`). Each session keeps a bounded number of live
snapshots (oldest pruned), so a device that lags by many syncs simply
resyncs with one full view.

Transport is whatever moves strings: `handle_raw` is `str -> str` over the
envelopes of `repro_torch.api.protocol` (the reference package's envelopes,
so either package's client can drive this server). Errors never escape as
exceptions — they come back as `ok=false` envelopes with a wire code.

Served models live on the server's device: CUDA unless constructed with
``device="cpu"``. The multi-model verbs `fit_batch` and `refine_batch`
reach `VedaliaService.fit_batch` / `refine_many`, which stack compatible
models into one batched launch a sweep.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.api import backends as backends_mod
from repro_torch.api import protocol
from repro_torch.api.backends import available_backends, backend_capabilities
from repro_torch.api.service import ModelHandle, VedaliaService
from repro_torch.core import codec as codec_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core import rlda, views as views_lib
from repro_torch.core.types import LDAState
from repro_torch.obs import config as obs_config
from repro_torch.obs import metrics, trace

_REQS_TOTAL = metrics.counter(
    "vedalia_server_requests_total",
    "Protocol requests handled, by verb and wire status.",
    labels=("verb", "status"))
_REQ_SECONDS = metrics.histogram(
    "vedalia_server_request_seconds",
    "End-to-end handle_raw latency per verb.",
    labels=("verb",))
_REQ_BYTES = metrics.histogram(
    "vedalia_server_request_bytes",
    "Request envelope size per verb.",
    labels=("verb",), buckets=metrics.BYTE_BUCKETS)
_RESP_BYTES = metrics.histogram(
    "vedalia_server_response_bytes",
    "Response envelope size per verb.",
    labels=("verb",), buckets=metrics.BYTE_BUCKETS)


@dataclasses.dataclass
class Session:
    """Per-client server state: live view cursors, insertion-ordered.

    Cursors are bound to the handle they were cut from — a cursor from one
    handle is never accepted as a sync point for another — and bounded
    *per handle*, so a client round-robin syncing many products never has
    one product's cursors evicted by another's.
    """

    session_id: str
    # handle_id -> {cursor id -> {topic_id: signature}}
    cursors: dict[int, dict[str, dict[int, dict]]] = dataclasses.field(
        default_factory=dict)

    def store(self, handle_id: int, cursor_id: str,
              sigs: dict[int, dict], limit: int):
        per_handle = self.cursors.setdefault(handle_id, {})
        per_handle[cursor_id] = sigs
        while len(per_handle) > limit:
            per_handle.pop(next(iter(per_handle)))

    def lookup(self, handle_id: int, cursor_id: str):
        return self.cursors.get(handle_id, {}).get(cursor_id)

    def drop_handle(self, handle_id: int):
        self.cursors.pop(handle_id, None)


class VedaliaServer:
    """Serve the Vedalia protocol over an in-process `VedaliaService`."""

    def __init__(
        self,
        service: Optional[VedaliaService] = None,
        *,
        max_cursors_per_session: int = 8,
        max_sessions: int = 1024,
        max_ingest_queue: int = 1024,
        rel_mass_tol: float = views_lib.REL_MASS_TOL,
        weight_tol: float = views_lib.WEIGHT_TOL,
        **service_kwargs,
    ):
        self.service = service or VedaliaService(**service_kwargs)
        self.device = self.service.device
        self.max_cursors_per_session = max_cursors_per_session
        self.max_sessions = max_sessions
        self.max_ingest_queue = max_ingest_queue
        self.rel_mass_tol = rel_mass_tol
        self.weight_tol = weight_tol
        self.sessions: dict[str, Session] = {}
        self.preps: dict[int, rlda.RLDACorpus] = {}
        # Streaming ingest: queued-but-unapplied reviews per handle, plus
        # the cumulative ack cursor. Both are handle-scoped (not session-
        # scoped) so acked reviews survive session eviction and client
        # churn; they are applied by an `update` with drain=true.
        self.ingest_queues: dict[int, list[rlda.Review]] = {}
        self.ingest_acked: dict[int, int] = {}
        self._next_session = 0
        self._next_corpus = 0
        self._next_cursor = 0

    # -- transport entry point ---------------------------------------------

    def handle_raw(self, raw: str) -> str:
        """One request envelope in, one response envelope out."""
        if not obs_config._enabled:
            return self._dispatch(raw)[2]
        t0 = time.perf_counter()
        kind, status, resp = self._dispatch(raw)
        verb = kind or "<unparsed>"
        _REQ_SECONDS.observe(time.perf_counter() - t0, verb=verb)
        _REQS_TOTAL.inc(verb=verb, status=status)
        _REQ_BYTES.observe(len(raw) if isinstance(raw, str) else 0, verb=verb)
        _RESP_BYTES.observe(len(resp), verb=verb)
        return resp

    def _dispatch(self, raw: str) -> tuple[Optional[str], str, str]:
        """(kind, wire status, response envelope). The obs-disabled fast
        path calls this directly, so the error-mapping contract lives here
        and `handle_raw` only adds telemetry."""
        kind = None
        try:
            kind, payload, wire_trace = protocol.parse_request_traced(raw)
            handler = getattr(self, f"_handle_{kind}")
            # Adopt the caller's trace (if any) so the dispatch span — and
            # everything the handler opens below it — joins the trace that
            # started on the client, across the wire rather than ambiently.
            with trace.remote_parent(wire_trace), \
                    trace.span(f"server.{kind}"):
                response = protocol.make_response(kind, handler(payload))
            return kind, "ok", response
        except protocol.NotFound as e:
            return kind, "not_found", protocol.make_error(
                kind, "not_found", str(e))
        except protocol.Overloaded as e:
            # Backpressure, not failure: the batch was rejected whole and
            # the client should retry after the queue drains.
            return kind, "overloaded", protocol.make_error(
                kind, "overloaded", str(e))
        except protocol.ProtocolError as e:
            return kind, e.code, protocol.make_error(kind, e.code, str(e))
        except KeyError as e:
            # Only reached by `payload["field"]` in a handler: the request
            # is missing a required field. Server-object lookup misses are
            # typed (NotFound) and handled above.
            return kind, "bad_request", protocol.make_error(
                kind, "bad_request", f"missing required field {e}")
        except ValueError as e:
            return kind, "invalid_argument", protocol.make_error(
                kind, "invalid_argument", str(e))
        except Exception as e:  # defensive: a server must always answer
            return kind, "internal", protocol.make_error(
                kind, "internal", f"{type(e).__name__}: {e}")

    # -- helpers ------------------------------------------------------------

    def _resolve_handle(self, payload: dict) -> ModelHandle:
        hid = int(payload["handle_id"])
        if hid not in self.service.handles:
            raise protocol.NotFound(f"unknown handle_id {hid}")
        return self.service.handles[hid]

    def _session_of(self, payload: dict) -> Session:
        sid = payload.get("session_id")
        if sid is None or sid not in self.sessions:
            raise protocol.NotFound(f"unknown session_id {sid!r}")
        return self.sessions[sid]

    def _quant_arg(self, payload: dict):
        """The optional `quant` payload field -> packed QuantSpec or None.

        Quantized encodings are strictly opt-in per request: a server
        never volunteers them, so clients that predate the field keep
        receiving (and parsing) raw arrays and version-1 views.
        """
        mode = payload.get("quant")
        if mode is None:
            return None
        return quant_lib.QuantSpec.from_wire(mode)  # ValueError on bad mode

    def _backend_arg(self, payload: dict):
        name = payload.get("backend")
        if name is not None and name != backends_mod.AUTO \
                and not backends_mod.known_backend(name):
            raise ValueError(
                f"unknown sampler backend {name!r}; "
                f"available: {available_backends()} (or 'auto', or the "
                f"aliases {sorted(backends_mod.ALIASES)})")
        return name

    def _tensor(self, array) -> torch.Tensor:
        """A decoded wire array -> a tensor on the server's device."""
        return torch.as_tensor(array, device=self.device)

    def _state(self, arrays: dict) -> LDAState:
        return LDAState(**{name: self._tensor(arrays[name])
                           for name in protocol.STATE_FIELDS})

    def _fit_payload(self, handle: ModelHandle) -> dict:
        return {
            "handle_id": handle.handle_id,
            "backend": handle.backend,
            "num_topics": handle.cfg.num_topics,
            "num_reviews": handle.num_reviews,
            "sweeps_run": handle.sweeps_run,
            "perplexity": self.service.perplexity(handle),
        }

    # -- verbs ---------------------------------------------------------------

    def _handle_hello(self, _payload: dict) -> dict:
        return {
            "protocol_version": protocol.PROTOCOL_VERSION,
            "backends": available_backends(),
            "capabilities": {
                name: caps.to_dict()
                for name, caps in backend_capabilities().items()
            },
            "default_backend": self.service.default_backend,
            # Additive capability advertisement: which packed array
            # encodings this server can emit on request (`quant` options
            # of view / export_model / adopt_state / spot_check) and the
            # newest view format it serves.
            "quant_modes": list(quant_lib.PACKED_MODES),
            "view_version": views_lib.VIEW_VERSION,
        }

    def _handle_open_session(self, _payload: dict) -> dict:
        sid = f"s{self._next_session}"
        self._next_session += 1
        self.sessions[sid] = Session(session_id=sid)
        # Bound total session state: churning clients that never close
        # evict the oldest sessions, whose devices then simply resync.
        while len(self.sessions) > self.max_sessions:
            self.sessions.pop(next(iter(self.sessions)))
        return {"session_id": sid}

    def _handle_close_session(self, payload: dict) -> dict:
        session = self._session_of(payload)
        del self.sessions[session.session_id]
        return {"session_id": session.session_id, "closed": True}

    def _handle_prepare(self, payload: dict) -> dict:
        reviews = protocol.decode_reviews(payload["reviews"])
        if not reviews:
            raise ValueError("prepare needs at least one review")
        prep = self.service.prepare(
            reviews,
            base_vocab=int(payload["base_vocab"]),
            num_topics=int(payload.get("num_topics", 12)),
            alpha=float(payload.get("alpha", 0.1)),
            beta=float(payload.get("beta", 0.01)),
            w_bits=payload.get("w_bits", 8),
        )
        cid = self._next_corpus
        self._next_corpus += 1
        self.preps[cid] = prep
        return {
            "corpus_id": cid,
            "num_reviews": len(reviews),
            "num_tokens": prep.corpus.num_tokens,
        }

    def _handle_fit(self, payload: dict) -> dict:
        handle = self.service.fit(
            protocol.decode_reviews(payload["reviews"]),
            num_topics=int(payload.get("num_topics", 12)),
            base_vocab=payload.get("base_vocab"),
            alpha=float(payload.get("alpha", 0.1)),
            beta=float(payload.get("beta", 0.01)),
            w_bits=payload.get("w_bits", 8),
            backend=self._backend_arg(payload),
            num_sweeps=payload.get("num_sweeps"),
            seed=payload.get("seed"),
            device_kind=payload.get("device_kind"),
        )
        return self._fit_payload(handle)

    def _handle_fit_batch(self, payload: dict) -> dict:
        """Fit one model per review set through the batched multi-model
        engine (`VedaliaService.fit_batch`); one fit payload per set, in
        request order."""
        sets = [protocol.decode_reviews(s) for s in payload["review_sets"]]
        handles = self.service.fit_batch(
            sets,
            num_topics=int(payload.get("num_topics", 12)),
            base_vocab=payload.get("base_vocab"),
            alpha=float(payload.get("alpha", 0.1)),
            beta=float(payload.get("beta", 0.01)),
            w_bits=payload.get("w_bits", 8),
            backend=self._backend_arg(payload),
            num_sweeps=payload.get("num_sweeps"),
            seed=payload.get("seed"),
            device_kind=payload.get("device_kind"),
        )
        return {"fits": [self._fit_payload(h) for h in handles]}

    def _handle_refine_batch(self, payload: dict) -> dict:
        """Warm-refit several handles in one coalesced run
        (`VedaliaService.refine_many`); one fit payload per handle."""
        handles = [
            self._resolve_handle({"handle_id": hid})
            for hid in payload["handle_ids"]
        ]
        if not handles:
            raise ValueError("refine_batch needs at least one handle_id")
        self.service.refine_many(
            handles,
            int(payload["num_sweeps"]),
            backend=self._backend_arg(payload),
            seed=payload.get("seed"),
        )
        return {"fits": [self._fit_payload(h) for h in handles]}

    def _handle_fit_prepared(self, payload: dict) -> dict:
        cid = int(payload["corpus_id"])
        if cid not in self.preps:
            raise protocol.NotFound(f"unknown corpus_id {cid}")
        handle = self.service.fit_prepared(
            self.preps[cid],
            backend=self._backend_arg(payload),
            num_sweeps=payload.get("num_sweeps"),
            seed=payload.get("seed"),
            device_kind=payload.get("device_kind"),
        )
        return self._fit_payload(handle)

    def _handle_adopt(self, payload: dict) -> dict:
        """Wrap an externally-fitted state (a device's local computation)
        into a served handle: corpus by reference, tensors on the wire."""
        cid = int(payload["corpus_id"])
        if cid not in self.preps:
            raise protocol.NotFound(f"unknown corpus_id {cid}")
        prep = self.preps[cid]
        arrays = {
            name: protocol.decode_array(payload["state"][name])
            for name in ("z", "n_dt", "n_wt", "n_t")
        }
        cfg = prep.cfg
        expect = {
            "z": (prep.corpus.num_tokens,),
            "n_dt": (cfg.num_docs, cfg.num_topics),
            "n_wt": (cfg.vocab_size, cfg.num_topics),
            "n_t": (cfg.num_topics,),
        }
        for name, shape in expect.items():
            if arrays[name].shape != shape:
                raise ValueError(
                    f"adopted state {name} has shape {arrays[name].shape}, "
                    f"corpus {cid} needs {shape}")
        handle = self.service.adopt(
            prep,
            self._state(arrays),
            backend=self._backend_arg(payload),
            sweeps_run=int(payload.get("sweeps_run", 0)),
        )
        return self._fit_payload(handle)

    def _decode_state(self, payload: dict,
                      handle: Optional[ModelHandle] = None) -> LDAState:
        """Wire `state` field -> LDAState (shape checks happen later, in
        `VedaliaService.validate_state`, so malformed submissions come back
        as a typed `valid=False` instead of a wire error where possible).

        Quantized uploads (packed `n_dt`/`n_wt`) are lossy, so their count
        tables are *not* trusted: `z` is the ground truth and the counts
        are scatter-rebuilt from it against the handle's corpus before the
        unchanged validation runs — an honest device's packed upload
        validates exactly; a fabricated one still fails the re-Gibbs
        spot-check on `z`.
        """
        arrays = protocol.decode_state_arrays(payload["state"])
        z = self._tensor(arrays["z"])
        if handle is not None \
                and protocol.state_arrays_quantized(payload["state"]) \
                and z.shape == (handle.model.corpus.num_tokens,):
            return codec_lib.rebuild_state(
                handle.cfg, handle.model.corpus, z.to(torch.int32))
        return self._state(arrays)

    def _handle_export_model(self, payload: dict) -> dict:
        """A device downloads everything needed to continue a served model
        locally: config, the handle's (token-parallel) corpus, and the
        current stored-unit state — the offload tier's task lease."""
        handle = self._resolve_handle(payload)
        spec = self._quant_arg(payload)
        cfg = handle.cfg
        corpus = handle.model.corpus
        return {
            "handle_id": handle.handle_id,
            "cfg": {
                "num_topics": cfg.num_topics,
                "vocab_size": cfg.vocab_size,
                "num_docs": cfg.num_docs,
                "alpha": cfg.alpha,
                "beta": cfg.beta,
                "w_bits": cfg.w_bits,
            },
            "base_vocab": handle.prep.base_vocab,
            "corpus": {
                "docs": protocol.encode_array(corpus.docs),
                "words": protocol.encode_array(corpus.words),
                "weights": protocol.encode_array(corpus.weights),
            },
            "state": protocol.encode_state_arrays(handle.state, spec=spec),
            "sweeps_run": handle.sweeps_run,
            "num_tokens": corpus.num_tokens,
        }

    def _handle_spot_check(self, payload: dict) -> dict:
        """Validate + recompute-perplexity (+ optional re-Gibbs on a
        throwaway copy) of an uploaded state. Never touches the handle."""
        handle = self._resolve_handle(payload)
        state = self._decode_state(payload, handle)
        res = self.service.spot_check(
            handle,
            state,
            claimed_perplexity=payload.get("claimed_perplexity"),
            num_sweeps=int(payload.get("num_sweeps", 0)),
            claim_tol=float(payload.get("claim_tol", 0.01)),
            backend=self._backend_arg(payload),
            seed=payload.get("seed"),
        )
        return {
            "handle_id": handle.handle_id,
            "valid": res.valid,
            "reason": res.reason,
            "state_perplexity": res.state_perplexity,
            "post_perplexity": res.post_perplexity,
            "deviation": res.deviation,
        }

    def _handle_adopt_state(self, payload: dict) -> dict:
        """Swap a verified device-computed state into an existing served
        handle (re-validated server-side regardless of what the caller
        already checked)."""
        handle = self._resolve_handle(payload)
        state = self._decode_state(payload, handle)
        self.service.adopt_state(
            handle, state, sweeps_run=int(payload.get("sweeps_run", 0)))
        return self._fit_payload(handle)

    def _handle_refine(self, payload: dict) -> dict:
        handle = self._resolve_handle(payload)
        self.service.refine(
            handle,
            num_sweeps=int(payload["num_sweeps"]),
            backend=self._backend_arg(payload),
            seed=payload.get("seed"),
        )
        return self._fit_payload(handle)

    def _handle_ingest(self, payload: dict) -> dict:
        """Queue a batch of reviews against a handle; returns the ack cursor.

        The ack cursor is the cumulative count of reviews this server has
        accepted for the handle — monotonic, handle-scoped, independent of
        sessions. A batch that would overflow the bounded queue is rejected
        whole (`overloaded`), so the cursor never covers dropped reviews.
        """
        handle = self._resolve_handle(payload)
        batch = protocol.decode_reviews(payload["reviews"])
        if not batch:
            raise ValueError("ingest needs at least one review")
        queue = self.ingest_queues.setdefault(handle.handle_id, [])
        if len(queue) + len(batch) > self.max_ingest_queue:
            raise protocol.Overloaded(
                f"ingest queue for handle {handle.handle_id} is full "
                f"({len(queue)}/{self.max_ingest_queue} queued, "
                f"batch of {len(batch)} rejected)")
        queue.extend(batch)
        acked = self.ingest_acked.get(handle.handle_id, 0) + len(batch)
        self.ingest_acked[handle.handle_id] = acked
        return {
            "handle_id": handle.handle_id,
            "acked": acked,
            "queued": len(queue),
        }

    def _handle_update(self, payload: dict) -> dict:
        handle = self._resolve_handle(payload)
        reviews = protocol.decode_reviews(payload.get("reviews", []))
        drained = 0
        if payload.get("drain"):
            queued = self.ingest_queues.get(handle.handle_id, [])
            drained = len(queued)
            reviews = queued + reviews
            if not reviews:
                # A periodic flusher shouldn't have to pre-check queue
                # depth: an empty drain is a no-op success, not an error —
                # and a free one (no model evaluation on the tick path;
                # perplexity rides as null).
                return {
                    "handle_id": handle.handle_id,
                    "num_new_reviews": 0,
                    "drained": 0,
                    "kind": "noop",
                    "perplexity": None,
                    "backend": handle.backend,
                }
        # The queue is cleared iff the model absorbed the reviews, keyed on
        # the service's commit point (`handle.model` is reassigned exactly
        # when the new documents land) rather than a clean return. A
        # failure *before* the commit (bad backend name, anything the
        # service rejects) must not lose acked reviews — the ack cursor
        # promises durability; a failure *after* it (say the response's
        # perplexity evaluation) must not leave them to be double-applied
        # by the next drain.
        model_before = handle.model
        try:
            resp = self.service.update(
                handle,
                reviews,
                update_sweeps=payload.get("update_sweeps"),
                seed=payload.get("seed"),
                backend=self._backend_arg(payload),
            )
        finally:
            if drained and handle.model is not model_before:
                del self.ingest_queues[handle.handle_id][:drained]
        return {
            "handle_id": resp.handle_id,
            "num_new_reviews": resp.num_new_reviews,
            "drained": drained,
            "kind": resp.kind,
            "perplexity": resp.perplexity,
            "backend": handle.backend,
        }

    def _handle_view(self, payload: dict) -> dict:
        handle = self._resolve_handle(payload)
        spec = self._quant_arg(payload)
        resp = self.service.view(
            handle,
            topics=payload.get("topics"),
            top_n=int(payload.get("top_n", 10)),
            mass_coverage=float(payload.get("mass_coverage", 0.9)),
            max_topics=payload.get("max_topics"),
        )
        sigs_now = {
            t.topic_id: views_lib.topic_signature(t)
            for t in resp.view.topics
        }

        session = None
        if payload.get("session_id") is not None:
            session = self._session_of(payload)

        since = payload.get("since")
        resync = False
        if since is not None:
            # Cursors are looked up under this handle only: a cursor cut
            # from another handle (or pruned) is an ordinary resync.
            old = session.lookup(handle.handle_id, since) if session else None
            if old is None:
                resync = True  # unknown/expired cursor: full resend
                changed, removed = resp.view.topics, []
            else:
                changed, removed = views_lib.diff_view(
                    old, resp.view,
                    rel_mass_tol=float(
                        payload.get("rel_mass_tol", self.rel_mass_tol)),
                    weight_tol=float(
                        payload.get("weight_tol", self.weight_tol)),
                )
        else:
            changed, removed = resp.view.topics, []

        cursor = None
        if session is not None:
            cursor = f"c{self._next_cursor}"
            self._next_cursor += 1
            session.store(handle.handle_id, cursor, sigs_now,
                          self.max_cursors_per_session)

        # Cursor signatures (`sigs_now`, stored above) always come from the
        # *unquantized* view, so delta thresholds are judged on exact
        # weights no matter how the payload is encoded.
        if spec is not None:
            topics = [views_lib.encode_topic_q(t, spec.bits)
                      for t in changed]
        else:
            topics = [t.to_dict() for t in changed]
        out = {
            "handle_id": handle.handle_id,
            "topic_ids": resp.topic_ids,
            "topics": topics,
            "removed_topic_ids": removed,
            "delta": since is not None and not resync,
            "resync": resync,
            "cursor": cursor,
            "valid": resp.valid,
        }
        if spec is not None:
            out["view_version"] = views_lib.VIEW_VERSION
            out["quant"] = spec.to_wire()
        return out

    def _handle_top_reviews(self, payload: dict) -> dict:
        handle = self._resolve_handle(payload)
        resp = self.service.top_reviews(
            handle,
            int(payload["topic_id"]),
            n=int(payload.get("n", 5)),
        )
        return {
            "handle_id": resp.handle_id,
            "topic_id": resp.topic_id,
            "review_ids": resp.review_ids,
        }

    def _handle_perplexity(self, payload: dict) -> dict:
        """Training-corpus perplexity, or — with a `reviews` payload —
        held-out perplexity of those reviews under the current model
        (the streaming scheduler's refit guard)."""
        handle = self._resolve_handle(payload)
        if payload.get("reviews") is not None:
            ppx = self.service.heldout_perplexity(
                handle, protocol.decode_reviews(payload["reviews"]))
            return {"handle_id": handle.handle_id, "perplexity": ppx,
                    "heldout": True}
        return {
            "handle_id": handle.handle_id,
            "perplexity": self.service.perplexity(handle),
        }

    def _handle_stats(self, _payload: dict) -> dict:
        """Server observability: queue depths and object counts."""
        queues = {
            str(hid): len(q) for hid, q in self.ingest_queues.items() if q
        }
        return {
            "num_sessions": len(self.sessions),
            "num_handles": len(self.service.handles),
            "num_corpora": len(self.preps),
            "ingest_queued": queues,
            "ingest_acked": {
                str(hid): n for hid, n in self.ingest_acked.items()
            },
            "total_queued": sum(queues.values()),
            "max_ingest_queue": self.max_ingest_queue,
        }

    def _handle_metrics(self, payload: dict) -> dict:
        """The `repro_torch.obs` registry of this server process: a dict
        snapshot always, plus Prometheus text when the caller asks
        (`format: "prometheus"`). Answering is always allowed — with obs
        disabled the snapshot is simply empty and `enabled` says why."""
        fmt = payload.get("format", "dict")
        if fmt not in ("dict", "prometheus"):
            raise ValueError(
                f"unknown metrics format {fmt!r}; use 'dict' or 'prometheus'")
        out = {
            "enabled": obs_config.enabled(),
            "metrics": metrics.snapshot(),
        }
        if fmt == "prometheus":
            out["exposition"] = metrics.render_prometheus()
        return out

    def _handle_release(self, payload: dict) -> dict:
        handle = self._resolve_handle(payload)
        self.service.release(handle)
        for session in self.sessions.values():  # cursors die with the handle
            session.drop_handle(handle.handle_id)
        self.ingest_queues.pop(handle.handle_id, None)
        self.ingest_acked.pop(handle.handle_id, None)
        return {"handle_id": handle.handle_id, "released": True}

    def _handle_release_corpus(self, payload: dict) -> dict:
        cid = int(payload["corpus_id"])
        if cid not in self.preps:
            raise protocol.NotFound(f"unknown corpus_id {cid}")
        del self.preps[cid]  # live handles keep their own prep reference
        return {"corpus_id": cid, "released": True}
