"""Context-manager spans with wire-propagated trace ids.

A *span* is one timed region with a name and attributes; spans nest via a
contextvar, and every span carries the **trace id** of its root, so one
user-visible operation — a client `refine`, a scheduler window, an offload
lease — is a tree the exports can reassemble:

    with trace.span("client.refine", handle=3):
        ...                      # children opened here share the trace id

Wire propagation: `wire_context()` serializes the current (trace_id,
span_id) into the additive `trace` envelope field of the Vedalia protocol
(`VedaliaClient` injects it on every request), and the server activates it
with `remote_parent(...)` before opening its dispatch span — so the
server's `server.<verb>` span is a *child of the client's call span even
across a real network transport*, not just via ambient context. Old
servers ignore the extra envelope field; old clients simply send none.

Ids: trace ids are 16 hex chars of process entropy; span ids are a
process-unique nonce plus a monotonic counter — a restored/restarted
server (or an evicted-and-reopened session) mints fresh ids, never
duplicates (`tests/test_obs.py` asserts this across
`stream.snapshot` save/restore and session eviction).

Finished spans land in a bounded process-wide buffer (oldest dropped),
exportable as Chrome trace-event JSON (`chrome://tracing`, Perfetto) or
JSONL. Everything is a no-op while `repro_torch.obs.config` is disabled.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import json
import os
import time
from collections import deque
from typing import Optional

from repro_torch.obs import config

#: Bounded span buffer: a long-lived server must not grow one record per
#: request forever. Export (or reset) before the window rolls over.
MAX_SPANS = 100_000

#: Envelope field name (additive; see `repro_torch.api.protocol`).
TRACE_FIELD = "trace"

_RUN_NONCE = os.urandom(4).hex()
_span_counter = itertools.count(1)


def _new_span_id() -> str:
    """Process-unique span id: entropy nonce + monotonic counter, so two
    runs (or a process and its restored snapshot) can never collide."""
    return f"{_RUN_NONCE}{next(_span_counter):08x}"


def new_trace_id() -> str:
    return os.urandom(8).hex()


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """The ambient (trace, parent-span) a new span attaches to."""

    trace_id: str
    span_id: Optional[str]  # None: remote parent did not send a span id


@dataclasses.dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    start_s: float  # monotonic (perf_counter) — durations, not wall clock
    duration_s: float = 0.0
    attrs: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_current: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("vedalia_trace", default=None)
_spans: deque[Span] = deque(maxlen=MAX_SPANS)


def current_context() -> Optional[TraceContext]:
    return _current.get()


def wire_context() -> Optional[dict]:
    """The current context as the additive `trace` envelope field, or None
    when there is nothing to propagate (disabled, or no active span)."""
    if not config._enabled:
        return None
    ctx = _current.get()
    if ctx is None:
        return None
    out = {"trace_id": ctx.trace_id}
    if ctx.span_id is not None:
        out["parent_span_id"] = ctx.span_id
    return out


@contextlib.contextmanager
def remote_parent(wire: Optional[dict]):
    """Server side: adopt a request envelope's trace context for the
    duration of the dispatch, so the server's spans join the caller's
    trace. Malformed/absent fields degrade to no adoption, never an error
    (telemetry must not fail a request)."""
    if not config._enabled or not isinstance(wire, dict) \
            or "trace_id" not in wire:
        yield
        return
    parent = wire.get("parent_span_id")
    token = _current.set(TraceContext(
        trace_id=str(wire["trace_id"]),
        span_id=None if parent is None else str(parent)))
    try:
        yield
    finally:
        _current.reset(token)


class _NullSpan:
    """What `span()` yields when obs is disabled: attribute sets no-op."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass


_NULL = _NullSpan()


@contextlib.contextmanager
def span(name: str, **attrs):
    """Open a timed span; children opened inside share its trace id.

    Yields the live `Span` (mutate `attrs` or call `.set(...)` to attach
    results) — or a no-op stand-in while obs is disabled.
    """
    if not config._enabled:
        yield _NULL
        return
    parent = _current.get()
    sp = Span(
        trace_id=parent.trace_id if parent else new_trace_id(),
        span_id=_new_span_id(),
        parent_id=parent.span_id if parent else None,
        name=name,
        start_s=time.perf_counter(),
        attrs=dict(attrs),
    )
    token = _current.set(TraceContext(sp.trace_id, sp.span_id))
    try:
        yield sp
    finally:
        _current.reset(token)
        sp.duration_s = time.perf_counter() - sp.start_s
        _spans.append(sp)


# Span.set lives here (not on the dataclass) so the live-span surface
# matches _NullSpan exactly.
def _span_set(self, **attrs) -> None:
    self.attrs.update(attrs)


Span.set = _span_set


def spans() -> list[Span]:
    """The buffered finished spans, oldest first."""
    return list(_spans)


def reset() -> None:
    _spans.clear()


# -- exports -----------------------------------------------------------------


def export_jsonl(path: str) -> int:
    """One JSON object per finished span; returns the span count."""
    buffered = spans()
    with open(path, "w") as f:
        for sp in buffered:
            f.write(json.dumps(sp.to_dict()) + "\n")
    return len(buffered)


def chrome_trace_events(buffered: Optional[list[Span]] = None) -> list[dict]:
    """Chrome trace-event (`ph: "X"` complete events) list. Each distinct
    trace id gets its own tid row so concurrent traces render side by
    side; `ts` is microseconds on the process-monotonic clock."""
    if buffered is None:
        buffered = spans()
    tids: dict[str, int] = {}
    events = []
    pid = os.getpid()
    for sp in buffered:
        tid = tids.setdefault(sp.trace_id, len(tids) + 1)
        events.append({
            "name": sp.name,
            "cat": "vedalia",
            "ph": "X",
            "ts": sp.start_s * 1e6,
            "dur": sp.duration_s * 1e6,
            "pid": pid,
            "tid": tid,
            "args": {
                "trace_id": sp.trace_id,
                "span_id": sp.span_id,
                "parent_id": sp.parent_id,
                **sp.attrs,
            },
        })
    return events


def export_chrome(path: str) -> int:
    """Write the buffer as a Chrome trace (`chrome://tracing` / Perfetto
    "Open trace file"); returns the event count."""
    events = chrome_trace_events()
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)
