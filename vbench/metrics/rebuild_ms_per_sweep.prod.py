"""Metric `rebuild_ms_per_sweep.prod`: the device milliseconds of the
count rebuilds a sweep, over the traced window. The program's
`codec.rebuild` spans time their device work with CUDA events into
`vedalia_rebuild_device_seconds_total`; its `sweep` spans count
`vedalia_sweeps_total`. None without both counts (an untraced run, a
program without the spans)."""

from typing import Optional

from vbench.readers import Context, _on_card

SECONDS = "vedalia_rebuild_device_seconds_total"
SWEEPS = "vedalia_sweeps_total"


def read(ctx: Context) -> Optional[float]:
    seconds, sweeps = ctx.counters.get(SECONDS, 0.0), ctx.counters.get(SWEEPS, 0.0)
    if not _on_card(ctx) or seconds <= 0 or sweeps <= 0:
        return None
    return 1e3 * seconds / sweeps
