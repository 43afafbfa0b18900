"""The process-wide observability switch.

Every obs instrument (metrics, spans, device timers) checks one module
flag before doing any work, so a process that never calls `enable()` pays
nothing beyond a single attribute read per instrumented call — the
"zero-cost-when-disabled" contract `benchmarks/obs_bench.py` gates.

Disabled is the default. Serving deployments, benches, and tests that
want telemetry opt in explicitly:

    from repro_torch import obs
    obs.enable()       # counters count, spans record, timers observe
    ...
    obs.disable()      # back to the free path

The flag is deliberately global (not per-registry / per-tracer): the
instrumented call sites read `config._enabled` directly, which keeps the
disabled branch to one dict-free attribute lookup.
"""

from __future__ import annotations

import contextlib

_enabled = False


def enable() -> None:
    """Turn on metrics recording, span collection, and timer observation."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Return to the zero-cost path (instruments become no-ops)."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def scope(on: bool = True):
    """Temporarily force the switch (tests, benches): restores on exit."""
    global _enabled
    prev = _enabled
    _enabled = on
    try:
        yield
    finally:
        _enabled = prev
