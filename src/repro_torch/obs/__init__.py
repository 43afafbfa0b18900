"""Unified observability: metrics registry, wire-propagated traces, timers.

    from repro_torch import obs
    from repro_torch.obs import metrics, trace, timers

    obs.enable()                              # default is off (zero-cost)

See `repro_torch.obs.config` for the switch contract, `.metrics` for the
registry, `.trace` for spans (on the profiler's clock, device-timed on
request) + Chrome export, and `.timers` for
`torch.cuda.synchronize`-aware timing. Metric names, types and labels are
those of the reference package, so one dashboard reads both.
"""

from repro_torch.obs import metrics, timers, trace  # noqa: F401  (re-exports)
from repro_torch.obs.config import disable, enable, enabled, scope

__all__ = [
    "enable", "disable", "enabled", "scope",
    "metrics", "trace", "timers",
]
