"""What the profiler saw in the traced window.

`read` takes a finished `torch.profiler.profile` and keeps, inside the
window that the harness marks with the `WINDOW` annotation, each device
operation (kernels, copies, sets: every event the profiler puts on the
card) and each host operation, as (name, start ns, end ns). The readers of
`vbench.readers` take the device's busy time, its idle gaps, and kernel
time by name from it.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

ANNOTATION = "vbench."  # the harness's host ranges: the window, each request
WINDOW = ANNOTATION + "window"
TOP = 10


@dataclasses.dataclass
class TraceView:
    window: tuple[int, int]  # ns, the profiler's clock
    device_ops: list[tuple[str, int, int]]
    host_ops: list[tuple[str, int, int]]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint (start, end) pairs."""
        lo, hi = self.window
        merged: list[list[int]] = []
        for _, a, b in sorted(self.device_ops, key=lambda e: e[1]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def kernel_s(self, *names: str) -> tuple[float, int]:
        """Device seconds and launches of the operations whose name holds
        one of `names`."""
        hits = [b - a for n, a, b in self.device_ops if any(s in n for s in names)]
        return sum(hits) * 1e-9, len(hits)

    def top_device_ops(self) -> list[list]:
        by_name: dict[str, int] = defaultdict(int)
        for n, a, b in self.device_ops:
            by_name[n] += b - a
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n, ns * 1e-9] for n, ns in top]

    def idle_gaps(self) -> list[list]:
        """The device's idle time in the window by the innermost host
        operation running at each gap's middle, largest first."""
        gaps, edge = [], self.window[0]
        for a, b in self.busy_intervals() + [(self.window[1], self.window[1])]:
            if a > edge:
                gaps.append(((edge + a) // 2, a - edge))
            edge = max(edge, b)
        by_name: dict[str, int] = defaultdict(int)
        stack: list[tuple[str, int]] = []  # open host operations, innermost last
        ops, i = self.host_ops, 0
        for mid, length in gaps:  # gaps in time order; host operations by start
            while i < len(ops) and ops[i][1] <= mid:
                while stack and stack[-1][1] < ops[i][1]:
                    stack.pop()
                stack.append((ops[i][0], ops[i][2]))
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            by_name[stack[-1][0] if stack else "host (no operation)"] += length
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n, ns * 1e-9] for n, ns in top]


def _events(prof):
    """(name, start ns, end ns, work on the device) of every event. The
    profiler also puts each annotated host range on the device's timeline
    (a user annotation): that is not work."""
    for e in prof.profiler.kineto_results.events():
        start, name = e.start_ns(), e.name()
        on_card = str(e.device_type()).endswith("CUDA")
        marked = getattr(e, "is_user_annotation", None)  # not in every torch
        if on_card and (name.startswith(ANNOTATION) or (marked is not None and marked())):
            continue
        yield name, start, start + e.duration_ns(), on_card


def read(prof) -> TraceView:
    events = list(_events(prof))
    marks = [(a, b) for n, a, b, dev in events if n == WINDOW and not dev]
    if not marks:
        raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
    lo, hi = marks[0]
    device = [(n, a, b) for n, a, b, dev in events if dev and b > lo and a < hi]
    host = sorted(((n, a, b) for n, a, b, dev in events
                   if not dev and n != WINDOW and b > lo and a < hi), key=lambda e: (e[1], -e[2]))
    return TraceView(window=(lo, hi), device_ops=device, host_ops=host)
