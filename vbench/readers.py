"""The arithmetic of the metrics. Each file of `vbench/metrics/` binds one
of these to a metric's name; the harness hands it the run's `Context`.

A reader returns None where it finds nothing to read: every reader on a
run that did not use the card (no number from the CPU is a device
number), the trace readers on an untraced run, a kernel's roofline where
no launch of it ran. End-to-end readers take the host clock over all the
requests of the window: a rate is all the work completed over the whole
window, a tail is over every request.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from vbench import yardstick

#: The kernels (`__global__` names) of each family's CUDA source, every one
#: that a sweep of the family can launch; `TEST_ONLY` are the sources'
#: test entries, which no sweep launches.
GIBBS_KERNELS = ("resample_warp_kernel", "resample_token_kernel", "resample_group_kernel",
                 "log_rows_kernel", "pack_rows_kernel")
ALIAS_KERNELS = ("alias_mh_kernel", "log_tables_kernel")
TEST_ONLY = ("philox_words_kernel",)


@dataclasses.dataclass
class Context:
    device: str  # the device type the run used
    setup_s: float
    window_s: float  # host clock, first request's start to the last one's end
    requests: list  # vbench.loop.Request, every request of the window
    config: dict  # the cell's configuration file
    inputs: list  # the inputs (core.rlda.RLDACorpus), one a model that a sweep resamples
    alias_rounds: int = 0  # the alias route's MH rounds, where the tapped sweeps ran it
    trace: Optional[object] = None  # vbench.traceview.TraceView of the traced window
    counters: dict = dataclasses.field(default_factory=dict)  # window's increments

    def corpora(self) -> list:
        return [p.corpus for p in self.inputs]


def _on_card(ctx: Context) -> bool:
    return ctx.device == "cuda"


def _traced(ctx: Context) -> bool:
    return _on_card(ctx) and ctx.trace is not None and ctx.trace.window_s > 0


def _sweeps(ctx: Context) -> int:
    return sum(r.sweeps for r in ctx.requests if r.error is None)


def setup_s(ctx: Context) -> Optional[float]:
    return ctx.setup_s if _on_card(ctx) else None


def tokens_per_s(ctx: Context) -> Optional[float]:
    """Tokens resampled (sweeps x live tokens) over the window."""
    if not _on_card(ctx) or ctx.window_s <= 0:
        return None
    return sum(r.tokens for r in ctx.requests if r.error is None) / ctx.window_s


def request_p95_ms(ctx: Context) -> Optional[float]:
    """The 95th percentile of the latency of every request that ended (a
    failed request makes the run not correct)."""
    lat = [(r.end - r.start) * 1e3 for r in ctx.requests if r.error is None]
    if not _on_card(ctx) or not lat:
        return None
    return yardstick.percentile(lat, 95)


def launches_per_sweep(ctx: Context) -> Optional[float]:
    """Device operations (kernels, copies, sets) a sweep in the trace."""
    if not _traced(ctx) or not _sweeps(ctx):
        return None
    return len(ctx.trace.device_ops) / _sweeps(ctx)


def idle_share(ctx: Context) -> Optional[float]:
    """The share of the traced window in which no operation ran on the
    device, in percent."""
    if not _traced(ctx):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def sweep_mfu(ctx: Context) -> Optional[float]:
    """The dense conditional's float32 operations of the window's sweeps
    over the window's host-clock time, as a share of the card's float32
    peak. It needs no trace; in the traced run the window is the traced
    one."""
    if not _on_card(ctx) or ctx.window_s <= 0 or not _sweeps(ctx):
        return None
    live = yardstick.live_tokens(ctx.corpora())
    ops = _sweeps(ctx) * yardstick.sweep_ops(live, ctx.config["num_topics"])
    return 100.0 * ops / ctx.window_s / yardstick.PEAK_FLOPS_F32


def _roofline(ctx: Context, bound_s: Optional[float], names) -> Optional[float]:
    """The least time of the window's resamples over the device time of
    the family's kernels, in percent."""
    if bound_s is None or not _traced(ctx) or not _sweeps(ctx):
        return None
    seconds, launches = ctx.trace.kernel_s(*names)
    if not launches or seconds <= 0:
        return None
    return 100.0 * _sweeps(ctx) * bound_s / seconds


def gibbs_roofline(ctx: Context) -> Optional[float]:
    corpora = ctx.corpora()
    doc_rows, word_rows = yardstick.rows_touched(corpora)
    bound = yardstick.gibbs_kernel_bound(yardstick.live_tokens(corpora), ctx.config["num_topics"],
                                         doc_rows, word_rows, models=len(corpora))
    return _roofline(ctx, bound["bound_s"], GIBBS_KERNELS)


def alias_roofline(ctx: Context) -> Optional[float]:
    if not ctx.alias_rounds:
        return None
    bound = yardstick.alias_kernel_bound(yardstick.live_tokens(ctx.corpora()), ctx.alias_rounds)
    return _roofline(ctx, bound["bound_s"], ALIAS_KERNELS)
