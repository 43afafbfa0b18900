"""Metric `service_idle_ms_per_request.prod`: the time the device waited on
the service. It is the device's idle time in the traced window that falls
inside a `service.refine` span of the program (a host operation of the
trace, on the profiler's clock), in milliseconds, over the window's
requests. None on an untraced run, or where the trace holds no such span
(a program without it)."""

from typing import Optional

from vbench.readers import Context, _traced

SPAN = "service.refine"


def _union(intervals) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _overlap_ns(xs, ys) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx: Context) -> Optional[float]:
    if not _traced(ctx) or not ctx.requests:
        return None
    lo, hi = ctx.trace.window
    spans = _union((max(a, lo), min(b, hi)) for n, a, b in ctx.trace.host_ops
                   if n == SPAN and min(b, hi) > max(a, lo))
    if not spans:
        return None
    gaps, edge = [], lo
    for a, b in ctx.trace.busy_intervals() + [(hi, hi)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    return _overlap_ns(gaps, spans) * 1e-6 / len(ctx.requests)
