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

Ids: a trace id is 64 random bits; a span id is a process-unique nonce
plus a monotonic counter — a restored/restarted server (or an
evicted-and-reopened session) mints fresh ids. Both come from a generator
seeded from the OS at import and again in a forked child, so a child
never repeats its parent's ids, and no id costs a system call (a
`getrandom` a request was measured to stall an H100 host for up to
milliseconds).

The profiler's clock: while a profiler records, every span also enters
`torch.profiler.record_function(name)`, so a `torch.profiler` trace holds
it as a host operation of its own name; `Span.start_ns` is its start
on the epoch clock (`time.time_ns`) that the profiler stamps its events
with. The epoch start is converted from `perf_counter_ns` through one
(time_ns, perf_counter_ns) anchor taken at import: durations stay
monotonic and no span reads the wall clock. `export_chrome` writes `ts` in
epoch microseconds, so the obs export and `prof.export_chrome_trace()`
lie on one time axis.

Device time: a span opened with `on=<a CUDA torch.device>` also records a
timing `torch.cuda.Event` on that device's current stream at entry and at
exit, and never synchronizes. `resolve()` reads the pairs whose end event
has completed (`Event.query`, no wait): the service calls it right after
the synchronize its op timer already makes while obs is on, inside the
op's span (`repro_torch.api.service`). A resolved pair puts its device
seconds on the span's attrs as `device_s` and onto the span's `counter`,
if it was opened with one, and its two events go back to a free list to
be recorded again. `flush()` waits for the pairs still pending
(exporters and tests).

Finished spans land in a bounded process-wide buffer (oldest dropped),
exportable as Chrome trace-event JSON (`chrome://tracing`, Perfetto).
Everything is a no-op while `repro_torch.obs.config` is disabled: a span
then costs one flag read, enters no `record_function` and records no
event.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import json
import os
import random
import threading
import time
from collections import deque
from typing import Optional

import torch

from repro_torch.obs import config

#: Bounded span buffer: a long-lived server must not grow one record per
#: request forever. Export (or reset) before the window rolls over.
MAX_SPANS = 100_000

#: Envelope field name (additive; see `repro_torch.api.protocol`).
TRACE_FIELD = "trace"

#: Device-timed spans left pending past this count are resolved when the
#: next one closes (a query, no wait), so a process that never reaches a
#: `resolve()` point holds a bounded number of CUDA events.
MAX_PENDING = 4096

_rng = random.Random()  # seeded from os.urandom
_RUN_NONCE = f"{_rng.getrandbits(32):08x}"
_span_counter = itertools.count(1)


def _reseed_after_fork() -> None:
    """A forked child draws its own ids, not its parent's."""
    global _RUN_NONCE
    _rng.seed()
    _RUN_NONCE = f"{_rng.getrandbits(32):08x}"


os.register_at_fork(after_in_child=_reseed_after_fork)

#: One (epoch, monotonic) anchor: a span's epoch start is its monotonic
#: start moved onto the profiler's clock, never a second wall-clock read.
_EPOCH_NS, _PERF_NS = time.time_ns(), time.perf_counter_ns()


def _new_span_id() -> str:
    """Process-unique span id: entropy nonce + monotonic counter, so two
    runs (or a process and its restored snapshot) can never collide."""
    return f"{_RUN_NONCE}{next(_span_counter):08x}"


def new_trace_id() -> str:
    """A trace id: 64 random bits as 16 hex chars."""
    return f"{_rng.getrandbits(64):016x}"


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
    start_ns: int = 0  # epoch ns (time.time_ns), the profiler's clock

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_current: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("vedalia_trace", default=None)
_spans: deque[Span] = deque(maxlen=MAX_SPANS)
# (span, device, start event, end event, counter or None) awaiting `resolve()`
_pending: list[tuple] = []
# device -> events of resolved pairs, free to record again
_free_events: dict[torch.device, list] = {}
_pending_lock = threading.Lock()


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


def _event(device: torch.device, stream) -> torch.cuda.Event:
    """A timing event of `device` recorded now on `stream`: a free one of a
    resolved pair when there is one (creating a CUDA event costs tens of µs
    of host time; recording one, a few)."""
    with _pending_lock:
        free = _free_events.get(device)
        ev = free.pop() if free else None
    if ev is None:
        ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


@contextlib.contextmanager
def span(name: str, *, on: Optional[torch.device] = None, counter=None, **attrs):
    """Open a timed span; children opened inside share its trace id.

    Yields the live `Span` (mutate `attrs` or call `.set(...)` to attach
    results) — or a no-op stand-in while obs is disabled. With `on` a CUDA
    device, the span's device work is timed by an event pair on that
    device's current stream; once resolved (`resolve`, `flush`) its device
    seconds land on `attrs["device_s"]` and are added to `counter` (a
    `metrics.Counter` without labels), if given.
    """
    if not config._enabled:
        yield _NULL
        return
    parent = _current.get()
    timed = on is not None and on.type == "cuda"
    # a record_function outside a profiled region records nothing: skip it
    mark = torch.profiler.record_function(name) if torch.autograd._profiler_enabled() \
        else contextlib.nullcontext()
    t0 = time.perf_counter_ns()
    with mark:
        sp = Span(
            trace_id=parent.trace_id if parent else new_trace_id(),
            span_id=_new_span_id(),
            parent_id=parent.span_id if parent else None,
            name=name,
            start_s=t0 * 1e-9,
            attrs=dict(attrs),
            start_ns=_EPOCH_NS + (t0 - _PERF_NS),
        )
        token = _current.set(TraceContext(sp.trace_id, sp.span_id))
        if timed:  # both events on the stream current at entry
            stream = torch.cuda.current_stream(on)
            start = _event(on, stream)
        try:
            yield sp
        finally:
            if timed:
                end = _event(on, stream)
                with _pending_lock:
                    _pending.append((sp, on, start, end, counter))
                    crowded = len(_pending) > MAX_PENDING
                if crowded:
                    resolve()
            _current.reset(token)
            sp.duration_s = (time.perf_counter_ns() - t0) * 1e-9
            _spans.append(sp)


# Span.set lives here (not on the dataclass) so the live-span surface
# matches _NullSpan exactly.
def _span_set(self, **attrs) -> None:
    self.attrs.update(attrs)


Span.set = _span_set


def resolve() -> int:
    """Resolve the device-timed spans whose end event has completed, without
    waiting: each gets `device_s`, and its counter (if any) the same
    seconds. Returns how many stay pending."""
    with _pending_lock:
        if not _pending:
            return 0
        items = _pending[:]
        _pending.clear()
    waiting, free = [], []
    for item in items:
        sp, device, start, end, counter = item
        if not end.query():
            waiting.append(item)
            continue
        seconds = start.elapsed_time(end) * 1e-3
        sp.attrs["device_s"] = seconds
        if counter is not None:
            counter.inc(seconds)
        free.append((device, start, end))
    with _pending_lock:
        _pending.extend(waiting)
        for device, start, end in free:
            _free_events.setdefault(device, []).extend((start, end))
    return len(waiting)


def flush() -> None:
    """Wait for every pending device-timed span, then resolve it. This
    synchronizes: exporters and tests call it, the serving path never."""
    with _pending_lock:
        ends = [item[3] for item in _pending]
    for end in ends:
        end.synchronize()
    resolve()


def spans() -> list[Span]:
    """The buffered finished spans, oldest first."""
    return list(_spans)


def reset() -> None:
    _spans.clear()
    with _pending_lock:
        _pending.clear()
        _free_events.clear()


# -- exports -----------------------------------------------------------------


def chrome_trace_events(buffered: Optional[list[Span]] = None) -> list[dict]:
    """Chrome trace-event (`ph: "X"` complete events) list. Each distinct
    trace id gets its own tid row so concurrent traces render side by
    side; `ts` is epoch microseconds, the clock of the profiler's own
    `export_chrome_trace`."""
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
            "ts": sp.start_ns * 1e-3,
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
    "Open trace file"), its device-timed spans resolved first; returns the
    event count."""
    flush()
    events = chrome_trace_events()
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)
