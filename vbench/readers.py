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
#: The kernels of the Mamba2 scan entry (`chunk_scan_mamba2.cu`) and of the
#: decode attention (`decode_attn.cu`), every one of each source.
MAMBA2_SCAN_KERNELS = ("mamba2_prep_kernel", "mamba2_scan_kernel")
DECODE_ATTN_KERNELS = ("decode_attn_split", "merge_kernel")
ITEMSIZE = {"bfloat16": 2, "float32": 4}


@dataclasses.dataclass
class Context:
    device: str  # the device type the run used
    setup_s: float
    window_s: float  # host clock, first request's start to the last one's end
    requests: list  # vbench.loop.Request, every request of the window
    config: dict  # the cell's configuration file
    inputs: object  # the input generator's output (for RLDA: core.rlda.RLDACorpus a model)
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
    """The tokens of every completed request over the window: a fit's
    resampled tokens (sweeps x live tokens), a served wave's prompt and
    output tokens."""
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


def _kernel_share(ctx: Context, bound_s: float, names, count: int = 1) -> Optional[float]:
    """`count` launches' least time `bound_s` each (or the window's whole
    least time, `count` 1) over the profiler's time of the kernels
    `names`, in percent."""
    if not _traced(ctx) or bound_s <= 0:
        return None
    seconds, launches = ctx.trace.kernel_s(*names)
    if not launches or seconds <= 0:
        return None
    return 100.0 * count * bound_s / seconds


def _roofline(ctx: Context, bound_s: Optional[float], names) -> Optional[float]:
    """The least time of the window's resamples over the device time of
    the family's kernels, in percent."""
    if bound_s is None or not _sweeps(ctx):
        return None
    return _kernel_share(ctx, bound_s, names, _sweeps(ctx))


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


def _waves(ctx: Context) -> list:
    """The served waves (`loop.Wave`) of every completed request."""
    return [w for r in ctx.requests if r.error is None for w in r.waves]


def first_token_mean_ms(ctx: Context) -> Optional[float]:
    """The mean time to the first token over every served wave of the
    window (each wave's rows wait alike)."""
    waves = _waves(ctx)
    if not _on_card(ctx) or not waves:
        return None
    return 1e3 * sum(w.first_token_s for w in waves) / len(waves)


def serve_mfu(ctx: Context) -> Optional[float]:
    """The model operations of every completed wave (`yardstick.
    hybrid_flops`: prefill and decode) over the window's host-clock time,
    as a share of the card's dense bfloat16 peak."""
    waves = _waves(ctx)
    if not _on_card(ctx) or ctx.window_s <= 0 or not waves:
        return None
    ops = sum(sum(yardstick.hybrid_flops(ctx.config, w.rows, w.prompt, w.new)) for w in waves)
    return 100.0 * ops / ctx.window_s / yardstick.PEAK_FLOPS_BF16


def prefill_mfu(ctx: Context) -> Optional[float]:
    """The prefill operations of every completed wave over the sum of
    their times to the first token, as a share of the bfloat16 peak."""
    waves = [w for w in _waves(ctx) if w.first_token_s > 0]
    if not _on_card(ctx) or not waves:
        return None
    ops = sum(yardstick.hybrid_flops(ctx.config, w.rows, w.prompt, w.new)[0] for w in waves)
    return 100.0 * ops / sum(w.first_token_s for w in waves) / yardstick.PEAK_FLOPS_BF16


def chunk_scan_roofline(ctx: Context) -> Optional[float]:
    """The Mamba2 scans of every completed wave's prefill (one a layer,
    `yardstick.mamba2_scan_bound`) over the time of the entry's kernels."""
    if not _traced(ctx) or not _waves(ctx):
        return None
    c = ctx.config
    item = ITEMSIZE[c["weights_dtype"]]
    bound = sum(c["num_layers"] * yardstick.mamba2_scan_bound(
        w.rows, w.prompt, c["ssm_heads"], c["ssm_state"], c["ssm_head_dim"], item)["bound_s"]
        for w in _waves(ctx))
    return _kernel_share(ctx, bound, MAMBA2_SCAN_KERNELS)


def decode_attn_roofline(ctx: Context) -> Optional[float]:
    """The shared block's decode attention of every completed wave (each
    call over the positions valid at its step, `yardstick.
    decode_attn_bound`) over the time of the kernel's split and merge."""
    if not _traced(ctx) or not _waves(ctx):
        return None
    c = ctx.config
    item, groups = ITEMSIZE[c["weights_dtype"]], c["num_layers"] // c["hybrid_attn_every"]
    hkv, g = c["num_kv_heads"], c["num_heads"] // c["num_kv_heads"]
    window = c["sliding_window"]
    bound = 0.0
    for rows, plen, new, _ in _waves(ctx):
        for pos in range(plen, plen + new - 1):
            valid = min(pos + 1, window) if window else pos + 1
            bound += groups * yardstick.decode_attn_bound(rows, valid, hkv, g, c["head_dim"],
                                                          item)["bound_s"]
    return _kernel_share(ctx, bound, DECODE_ATTN_KERNELS)
