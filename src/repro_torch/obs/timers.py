"""Monotonic, device-aware timing helpers.

1. Timers read `time.perf_counter()`: monotonic, highest available
   resolution, meaningful only as *differences*.
2. CUDA work is asynchronous — stopping a timer before the card finished
   measures enqueue time, not compute time. `DeviceTimer.sync(value)`
   calls `torch.cuda.synchronize` on the device of every CUDA tensor in
   `value` before reading the clock, so kernel/sweep timings are honest.

`DeviceTimer` is also the bridge into the metrics registry: give it a
`Histogram` and labels and the elapsed seconds are observed on stop.
While `repro_torch.obs.config` is disabled the timer skips the sync
(preserving async launch — the zero-cost contract) and observes nothing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.obs import config
from repro_torch.obs.metrics import Histogram

__all__ = ["now", "DeviceTimer"]


def now() -> float:
    """Monotonic seconds (`perf_counter`); only differences are meaningful."""
    return time.perf_counter()


def _tensors(value):
    if isinstance(value, torch.Tensor):
        return [value]
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        value = [getattr(value, f.name) for f in dataclasses.fields(value)]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    return []  # host-only values: nothing to wait for


def _block(value) -> None:
    """Wait for the CUDA work behind `value`: a tensor, a state dataclass,
    or a sequence of them; a no-op for CPU tensors and host values."""
    for dev in {t.device for t in _tensors(value) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class DeviceTimer:
    """Measure a region, waiting out async device work before stopping.

        timer = DeviceTimer(_OP_SECONDS, op="fit", backend=name)
        timer.start()
        state = backend.run(...)
        timer.sync(state.n_wt)      # synchronize, then stop + observe

    When obs is disabled the whole object is inert: no sync (async launch
    preserved), no observation.
    """

    __slots__ = ("_hist", "_labels", "_t0", "elapsed_s")

    def __init__(self, histogram: Optional[Histogram] = None, **labels):
        self._hist = histogram
        self._labels = labels
        self._t0: Optional[float] = None
        self.elapsed_s: Optional[float] = None

    def start(self) -> "DeviceTimer":
        if config._enabled:
            self._t0 = time.perf_counter()
        return self

    def sync(self, value=None) -> Optional[float]:
        """Wait for `value`'s device work, stop, observe; returns elapsed
        seconds (None when disabled or never started). With no `value` (a
        host-side region) it stops without waiting."""
        if not config._enabled or self._t0 is None:
            return None
        _block(value)
        self.elapsed_s = time.perf_counter() - self._t0
        self._t0 = None
        if self._hist is not None:
            self._hist.observe(self.elapsed_s, **self._labels)
        return self.elapsed_s

