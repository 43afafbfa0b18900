"""Wire-level Vedalia protocol: versioned JSON envelopes.

Everything a device exchanges with the model server is one JSON envelope:

    request   {"protocol_version": 1, "kind": "<verb>", "payload": {...}}
    response  {"protocol_version": 1, "kind": "<verb>", "ok": true,
               "payload": {...}}
    error     {"protocol_version": 1, "kind": "<verb>", "ok": false,
               "error": {"code": "...", "message": "..."}}

The same envelopes drive the in-process transport today and a socket/HTTP
transport later — `VedaliaServer.handle_raw` is `str -> str`, nothing else.
Binary tensors (the `adopt` verb's externally-fitted model states) ride as
base64 raw bytes with dtype and shape (`encode_array`; not to be confused
with `repro_torch.api.codec`, the fixed-point count codec); review records
are plain dicts with token lists. Envelopes, `KINDS` and the array codec
are the reference package's byte for byte, so clients and servers of the
two packages interoperate; tensors are encoded from any device.

Version discipline: both sides stamp `PROTOCOL_VERSION`; the server rejects
any other version with code ``version_mismatch`` (the client surfaces that
as :class:`ProtocolError`). Bump the version when an envelope's schema
changes shape; additive payload fields do not require a bump.
"""

from __future__ import annotations

import base64
import json
from typing import Optional

import numpy as np

from repro_torch.core import quant
from repro_torch.core.codec import as_numpy
from repro_torch.core.rlda import Review

PROTOCOL_VERSION = 1

#: The request verbs a server must answer. `hello` is the capability
#: handshake; everything else maps onto the service layer. `ingest` and
#: `stats` are the streaming verbs: batched review ingestion with an ack
#: cursor, and the observability surface backpressure decisions read.
#: `fit_batch` / `refine_batch` are the multi-model verbs: M review sets
#: (or M served handles) fitted/refitted through the batched sampler in
#: as few launches as bucketing allows. `export_model` / `spot_check` /
#: `adopt_state` are the offload-tier verbs (additive, no version bump):
#: a device downloads a served model's corpus+state, computes locally, and
#: the server validates + re-Gibbs-spot-checks the uploaded state before
#: swapping it into the *existing* served handle. `metrics` (additive) is
#: the observability verb: a dict snapshot — or Prometheus text — of the
#: server process's `repro_torch.obs` registry.
KINDS = (
    "hello",
    "open_session",
    "prepare",
    "fit",
    "fit_batch",
    "fit_prepared",
    "refine",
    "refine_batch",
    "update",
    "ingest",
    "view",
    "top_reviews",
    "adopt",
    "adopt_state",
    "export_model",
    "spot_check",
    "perplexity",
    "stats",
    "metrics",
    "release",
    "release_corpus",
    "close_session",
)


class ProtocolError(ValueError):
    """The envelope itself is malformed or from an incompatible version.

    `code` is the wire error code a server answers with ("bad_request"
    unless the constructor says otherwise, e.g. "version_mismatch").
    """

    def __init__(self, message: str, code: str = "bad_request"):
        super().__init__(message)
        self.code = code


class NotFound(KeyError):
    """A referenced server object (handle, corpus, session) does not exist.

    Subclasses KeyError so embedded (non-wire) callers of the service keep
    their existing `except KeyError` behavior; the server maps it to the
    "not_found" wire code.
    """

    def __str__(self):  # KeyError.__str__ repr-quotes the message
        return self.args[0] if self.args else ""


class RemoteError(RuntimeError):
    """The server answered with ok=false; carries the wire error code."""

    def __init__(self, code: str, message: str, kind: Optional[str] = None):
        super().__init__(f"[{code}] {message}")
        self.code = code
        self.kind = kind


class Overloaded(RuntimeError):
    """A bounded server-side queue is full (wire code ``overloaded``).

    Unlike the other wire errors this one is *retryable by design*: the
    client should back off and re-offer the same batch — nothing about the
    request itself is wrong. Raised server-side only; clients observe it
    as ``RemoteError(code="overloaded")``, which is how
    `stream.IncrementalScheduler` detects backpressure (it folds the
    queued backlog into the model, then retries the batch once).
    """


# -- tensor / record codecs --------------------------------------------------
#
# The array codec is versioned by shape, not by a number: the original
# (raw) form is {"dtype", "shape", "b64"}; the quantized form (additive —
# old decoders never receive it unless they asked) is
#
#     {"enc": "q", "mode": "int8"|"int4_packed", "dtype": "<orig dtype>",
#      "shape": [...], "scales": {raw array}, "b64": "<packed codes>"}
#
# with per-trailing-axis-row float32 scales and uint8 code payload
# (nibble-packed for int4, low nibble first — see `repro_torch.core.quant`).
# `decode_array` transparently handles both forms; servers only *emit* the
# quantized form when the request opted in, so pre-quant clients keep
# parsing every payload they can provoke.


def encode_array(x, spec=None) -> dict:
    """ndarray -> wire dict.

    Raw form (`spec=None`, the default): {"dtype", "shape", "b64"} with raw
    little-endian bytes. With a packed `QuantSpec` (mode int8/int4_packed),
    the lossy quantized form above: per-row scales + packed codes, an
    integer factor smaller for float/int32 tables.
    """
    a = np.ascontiguousarray(as_numpy(x))  # tensors on any device
    if spec is None or not getattr(spec, "packed", False):
        return {
            "dtype": a.dtype.str,
            "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode("ascii"),
        }
    if a.ndim == 0:
        raise ProtocolError("cannot quantize a 0-d array")
    codes, scales = quant.quantize_rows(a.astype(np.float32), spec.bits)
    return {
        "enc": "q",
        "mode": spec.mode,
        "dtype": a.dtype.str,
        "shape": list(a.shape),
        "scales": encode_array(scales),
        "b64": base64.b64encode(
            np.ascontiguousarray(codes).tobytes()).decode("ascii"),
    }


def decode_array(d: dict) -> np.ndarray:
    """Wire dict -> ndarray; handles both the raw and quantized forms.

    Quantized payloads dequantize to the original dtype (float dtypes
    exactly; integer dtypes round to nearest — counts, so non-negative).
    """
    try:
        if d.get("enc") == "q":
            spec = quant.QuantSpec.from_wire(d["mode"])
            shape = tuple(int(s) for s in d["shape"])
            k = shape[-1]
            stored_k = k // 2 + k % 2 if spec.bits == 4 else k
            codes = np.frombuffer(
                base64.b64decode(d["b64"]), dtype=np.uint8
            ).reshape(shape[:-1] + (stored_k,))
            scales = decode_array(d["scales"])
            out = quant.dequantize_rows(codes, scales, spec.bits, k)
            dt = np.dtype(d["dtype"])
            if dt.kind in "iu":
                out = np.rint(out)
            return out.astype(dt)
        buf = base64.b64decode(d["b64"])
        return np.frombuffer(buf, dtype=np.dtype(d["dtype"])).reshape(
            d["shape"]).copy()
    except (KeyError, TypeError, ValueError) as e:
        raise ProtocolError(f"bad array payload: {e}") from None


#: The four arrays of an `LDAState`, in wire order — shared by every verb
#: that moves model state (`adopt`, `adopt_state`, `export_model`,
#: `spot_check`).
STATE_FIELDS = ("z", "n_dt", "n_wt", "n_t")

#: State fields eligible for packed transport. `z` is the ground truth the
#: server rebuilds counts from (and spot-checks), so it always ships raw;
#: `n_t` is one row of K floats — not worth a lossy encode.
QUANT_STATE_FIELDS = ("n_dt", "n_wt")


def encode_state_arrays(state, spec=None) -> dict:
    """LDAState (stored units) -> {"z": {...}, "n_dt": {...}, ...}.

    With a packed `spec`, the big count tables (`n_dt`, `n_wt`) ship as
    quantized arrays; `z` and `n_t` stay raw. Receivers that need exact
    counts rebuild them from `z` (see `server._decode_state`).
    """
    out = {}
    for name in STATE_FIELDS:
        field_spec = spec if name in QUANT_STATE_FIELDS else None
        out[name] = encode_array(getattr(state, name), spec=field_spec)
    return out


def state_arrays_quantized(d: dict) -> bool:
    """Did any field of a wire state dict use the quantized encoding?"""
    return any(
        isinstance(d.get(name), dict) and d[name].get("enc") == "q"
        for name in STATE_FIELDS)


def decode_state_arrays(d: dict) -> dict:
    """Wire state dict -> {name: ndarray}; raises ProtocolError when a
    field is missing or malformed. Quantized fields dequantize here —
    callers that must not trust lossy counts check
    `state_arrays_quantized` and rebuild from `z`."""
    if not isinstance(d, dict):
        raise ProtocolError("state payload must be a JSON object")
    try:
        return {name: decode_array(d[name]) for name in STATE_FIELDS}
    except KeyError as e:
        raise ProtocolError(f"state payload missing field {e}") from None


def encode_review(r: Review) -> dict:
    return {
        "tokens": [int(t) for t in np.asarray(r.tokens).ravel()],
        "rating": float(r.rating),
        "user": int(r.user),
        "helpful": int(r.helpful),
        "unhelpful": int(r.unhelpful),
        "writing_quality": float(r.writing_quality),
    }


def decode_review(d: dict) -> Review:
    try:
        return Review(
            tokens=np.asarray(d["tokens"], np.int32),
            rating=float(d["rating"]),
            user=int(d["user"]),
            helpful=int(d["helpful"]),
            unhelpful=int(d["unhelpful"]),
            writing_quality=float(d["writing_quality"]),
        )
    except (KeyError, TypeError, ValueError) as e:
        raise ProtocolError(f"bad review payload: {e}") from None


def encode_reviews(reviews) -> list[dict]:
    return [encode_review(r) for r in reviews]


def decode_reviews(ds) -> list[Review]:
    return [decode_review(d) for d in ds]


# -- envelopes ---------------------------------------------------------------


def make_request(kind: str, payload: Optional[dict] = None,
                 trace: Optional[dict] = None) -> str:
    """`trace` is the additive observability envelope field
    (`{"trace_id", "parent_span_id"}`, see `repro_torch.obs.trace.wire_context`);
    servers that predate it ignore unknown envelope keys, so no version
    bump. Omitted entirely when None — the common, obs-disabled case."""
    if kind not in KINDS:
        raise ProtocolError(f"unknown request kind {kind!r}; kinds: {KINDS}")
    env = {
        "protocol_version": PROTOCOL_VERSION,
        "kind": kind,
        "payload": payload or {},
    }
    if trace is not None:
        env["trace"] = trace
    return json.dumps(env)


def parse_request_traced(raw: str) -> tuple[str, dict, Optional[dict]]:
    """Server side: raw request -> (kind, payload, trace-or-None).

    The third element is the additive `trace` envelope field when the
    caller sent one (malformed values are passed through untouched —
    `repro_torch.obs.trace.remote_parent` treats anything non-conforming as
    absent, because telemetry must never fail a request).
    """
    try:
        env = json.loads(raw)
    except (TypeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"request is not valid JSON: {e}") from None
    if not isinstance(env, dict):
        raise ProtocolError("request envelope must be a JSON object")
    version = env.get("protocol_version")
    if version != PROTOCOL_VERSION:
        raise ProtocolError(
            f"protocol version mismatch: got {version!r}, "
            f"server speaks {PROTOCOL_VERSION}",
            code="version_mismatch")
    kind = env.get("kind")
    if kind not in KINDS:
        raise ProtocolError(
            f"unknown request kind {kind!r}; kinds: {KINDS}")
    payload = env.get("payload", {})
    if not isinstance(payload, dict):
        raise ProtocolError("request payload must be a JSON object")
    return kind, payload, env.get("trace")


def parse_request(raw: str) -> tuple[str, dict]:
    """Server side: raw request -> (kind, payload); raises ProtocolError."""
    kind, payload, _ = parse_request_traced(raw)
    return kind, payload


def make_response(kind: str, payload: dict) -> str:
    return json.dumps({
        "protocol_version": PROTOCOL_VERSION,
        "kind": kind,
        "ok": True,
        "payload": payload,
    })


def make_error(kind: Optional[str], code: str, message: str) -> str:
    return json.dumps({
        "protocol_version": PROTOCOL_VERSION,
        "kind": kind,
        "ok": False,
        "error": {"code": code, "message": message},
    })


def parse_response(raw: str, expect_kind: Optional[str] = None) -> dict:
    """Client side: raw response -> payload dict.

    Raises RemoteError for ok=false answers and ProtocolError for envelopes
    the client cannot even interpret (bad JSON, wrong version, wrong kind).
    """
    try:
        env = json.loads(raw)
    except (TypeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"response is not valid JSON: {e}") from None
    if not isinstance(env, dict):
        raise ProtocolError("response envelope must be a JSON object")
    if env.get("protocol_version") != PROTOCOL_VERSION:
        raise ProtocolError(
            f"protocol version mismatch: got "
            f"{env.get('protocol_version')!r}, client speaks "
            f"{PROTOCOL_VERSION}")
    if not env.get("ok", False):
        err = env.get("error") or {}
        raise RemoteError(
            code=str(err.get("code", "unknown")),
            message=str(err.get("message", "unspecified server error")),
            kind=env.get("kind"),
        )
    if expect_kind is not None and env.get("kind") != expect_kind:
        raise ProtocolError(
            f"response kind {env.get('kind')!r} does not match the "
            f"request kind {expect_kind!r}")
    payload = env.get("payload", {})
    if not isinstance(payload, dict):
        raise ProtocolError("response payload must be a JSON object")
    return payload
