"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

One `MetricsRegistry` per process (`REGISTRY`), holding named instruments
with optional label dimensions:

    _REQS = metrics.counter(
        "vedalia_server_requests_total",
        "Protocol requests handled.", labels=("verb", "status"))
    _REQS.inc(verb="fit", status="ok")

Declaration is get-or-create (module-level declarations across the tiers
all resolve to the same instrument on re-import); re-declaring a name with
a different type or label set raises, so two tiers can never silently
split a metric.

Recording is a no-op while the `repro_torch.obs.config` switch is off — the
instruments exist (so the `metrics` wire verb can always answer) but their
series stay empty. Two read surfaces:

  * `snapshot()` — plain JSON-serializable dict (what the `metrics` verb
    ships and the bench artifacts store);
  * `render_prometheus()` — Prometheus text exposition (`# HELP`/`# TYPE`
    plus one line per series; histograms expose cumulative `_bucket{le=}`
    lines, `_sum`, `_count`).

Histograms use *fixed* bucket bounds chosen at declaration
(`DEFAULT_TIME_BUCKETS` spans 100µs–10s request latencies,
`BYTE_BUCKETS` spans wire payloads, `COUNT_BUCKETS` small cardinalities)
— no dynamic resizing, so observation is O(#buckets) bisect-free.
"""

from __future__ import annotations

import bisect
from typing import Optional, Sequence

from repro_torch.obs import config

#: Seconds buckets for request / op latencies (upper bounds; +Inf implicit).
DEFAULT_TIME_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: Byte-size buckets for wire payloads.
BYTE_BUCKETS = (256, 1024, 4096, 16384, 65536, 262144, 1048576, 4194304)

#: Small-cardinality buckets (models per launch, queue depths, ...).
COUNT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


class Metric:
    """Shared instrument plumbing: name, help, label resolution."""

    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: tuple[str, ...]):
        self.name = name
        self.help = help
        self.label_names = label_names
        # label-value tuple -> per-type series value
        self._series: dict[tuple, object] = {}

    def _labels_key(self, labels: dict) -> tuple:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[n]) for n in self.label_names)

    def _label_dict(self, key: tuple) -> dict:
        return dict(zip(self.label_names, key))

    def reset(self) -> None:
        self._series.clear()

    # subclasses: snapshot_series(key) -> dict, prom_lines(key) -> list[str]


class Counter(Metric):
    """Monotonically increasing count (negative increments rejected)."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if not config._enabled:
            return
        if value < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        key = self._labels_key(labels)
        self._series[key] = self._series.get(key, 0.0) + float(value)

    def value(self, **labels) -> float:
        return float(self._series.get(self._labels_key(labels), 0.0))

    def _snapshot_series(self, key) -> dict:
        return {"labels": self._label_dict(key),
                "value": self._series[key]}

    def _prom_lines(self, key) -> list[str]:
        return [f"{self.name}{_prom_labels(self._label_dict(key))} "
                f"{_prom_num(self._series[key])}"]


class Gauge(Metric):
    """Point-in-time value (set/add; may go down)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not config._enabled:
            return
        self._series[self._labels_key(labels)] = float(value)

    def add(self, value: float, **labels) -> None:
        if not config._enabled:
            return
        key = self._labels_key(labels)
        self._series[key] = self._series.get(key, 0.0) + float(value)

    def value(self, **labels) -> float:
        return float(self._series.get(self._labels_key(labels), 0.0))

    _snapshot_series = Counter._snapshot_series
    _prom_lines = Counter._prom_lines


class Histogram(Metric):
    """Fixed-bucket distribution: per-bucket counts + sum + count."""

    kind = "histogram"

    def __init__(self, name, help, label_names,
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        super().__init__(name, help, label_names)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError(f"histogram {name!r} needs at least one bucket")
        if len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram {name!r} has duplicate buckets")
        self.buckets = bounds

    def observe(self, value: float, **labels) -> None:
        if not config._enabled:
            return
        key = self._labels_key(labels)
        series = self._series.get(key)
        if series is None:
            # counts has one extra slot for the +Inf overflow bucket
            series = self._series[key] = {
                "counts": [0] * (len(self.buckets) + 1),
                "sum": 0.0, "count": 0}
        v = float(value)
        series["counts"][bisect.bisect_left(self.buckets, v)] += 1
        series["sum"] += v
        series["count"] += 1

    def count(self, **labels) -> int:
        s = self._series.get(self._labels_key(labels))
        return int(s["count"]) if s else 0

    def _snapshot_series(self, key) -> dict:
        s = self._series[key]
        return {
            "labels": self._label_dict(key),
            "buckets": list(self.buckets),
            "counts": list(s["counts"]),
            "sum": s["sum"],
            "count": s["count"],
        }

    def _prom_lines(self, key) -> list[str]:
        s = self._series[key]
        base = self._label_dict(key)
        lines, cum = [], 0
        for bound, n in zip(self.buckets, s["counts"]):
            cum += n
            lines.append(
                f"{self.name}_bucket"
                f"{_prom_labels({**base, 'le': _prom_num(bound)})} {cum}")
        lines.append(
            f"{self.name}_bucket{_prom_labels({**base, 'le': '+Inf'})} "
            f"{s['count']}")
        lines.append(
            f"{self.name}_sum{_prom_labels(base)} {_prom_num(s['sum'])}")
        lines.append(f"{self.name}_count{_prom_labels(base)} {s['count']}")
        return lines


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(str(v))}"' for k, v in labels.items())
    return "{" + inner + "}"


def _prom_num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class MetricsRegistry:
    """Name -> instrument; declarations are get-or-create."""

    def __init__(self):
        self._metrics: dict[str, Metric] = {}

    def _declare(self, cls, name, help, labels, **kw) -> Metric:
        existing = self._metrics.get(name)
        if existing is not None:
            if type(existing) is not cls \
                    or existing.label_names != tuple(labels) \
                    or kw.get("buckets") is not None and \
                    tuple(sorted(float(b) for b in kw["buckets"])) \
                    != getattr(existing, "buckets", None):
                raise ValueError(
                    f"metric {name!r} already declared as "
                    f"{existing.kind}{existing.label_names}; conflicting "
                    f"re-declaration")
            return existing
        metric = cls(name, help, tuple(labels), **{
            k: v for k, v in kw.items() if v is not None})
        self._metrics[name] = metric
        return metric

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._declare(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._declare(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._declare(Histogram, name, help, labels, buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def snapshot(self) -> dict:
        """All instruments with at least one recorded series, as one
        JSON-serializable dict (the `metrics` wire verb's payload)."""
        out = {}
        for name, m in sorted(self._metrics.items()):
            if not m._series:
                continue
            out[name] = {
                "type": m.kind,
                "help": m.help,
                "label_names": list(m.label_names),
                "series": [m._snapshot_series(k)
                           for k in sorted(m._series)],
            }
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition of every non-empty instrument."""
        lines = []
        for name, m in sorted(self._metrics.items()):
            if not m._series:
                continue
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key in sorted(m._series):
                lines.extend(m._prom_lines(key))
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Clear every series; instruments stay declared (tests/benches)."""
        for m in self._metrics.values():
            m.reset()


#: The process-wide registry every tier declares into.
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return REGISTRY.histogram(name, help, labels, buckets=buckets)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()


def reset() -> None:
    REGISTRY.reset()
