"""The readers of the program's own spans and counters: the rebuild's and
the table build's device ms a sweep from the counters' increments, and the
device's idle time inside the service's request spans."""

import pytest

from vbench import harness, loop, readers, traceview

METRICS = harness.REPO / "vbench" / "metrics"


def _reader(name):
    return harness.load_reader(METRICS / f"{name}.py")


def _ctx(counters=None, trace=None, requests=2, device="cuda"):
    reqs = [loop.Request(i, 0.0, 1.0, 3, 300, 0) for i in range(requests)]
    return readers.Context(device, 1.0, 1.0, reqs, {"num_topics": 12}, [], trace=trace,
                           counters=counters or {})


COUNTS = {"vedalia_sweeps_total": 6.0, "vedalia_rebuild_device_seconds_total": 0.018,
          "vedalia_alias_tables_device_seconds_total": 0.12}


@pytest.mark.parametrize("name, ms", [("rebuild_ms_per_sweep.prod", 3.0),
                                      ("alias_tables_ms_per_sweep.prod", 20.0)])
def test_device_ms_a_sweep_from_the_counters(name, ms):
    assert _reader(name)(_ctx(COUNTS)) == pytest.approx(ms)


@pytest.mark.parametrize("name", ["rebuild_ms_per_sweep.prod", "alias_tables_ms_per_sweep.prod"])
@pytest.mark.parametrize("counters", [
    {},  # an untraced run, or a program without the spans
    {"vedalia_sweeps_total": 6.0},  # no rebuild or table build timed
    dict(COUNTS, vedalia_sweeps_total=0.0),
    dict(COUNTS, vedalia_rebuild_device_seconds_total=0.0,
         vedalia_alias_tables_device_seconds_total=0.0),
])
def test_device_ms_a_sweep_is_none_without_counts(name, counters):
    assert _reader(name)(_ctx(counters)) is None


def test_device_ms_a_sweep_is_none_on_the_cpu():
    for name in ("rebuild_ms_per_sweep.prod", "alias_tables_ms_per_sweep.prod"):
        assert _reader(name)(_ctx(COUNTS, device="cpu")) is None


def _view(host):
    # window 0..1000 ns; the device is busy 100-300, 350-600 and 800-900, so
    # idle 0-100, 300-350, 600-800 and 900-1000
    device = [("k", 100, 300), ("k", 350, 600), ("k", 800, 900)]
    return traceview.TraceView(window=(0, 1000), device_ops=device, host_ops=host)


def test_service_idle_counts_only_the_idle_inside_request_spans():
    read = _reader("service_idle_ms_per_request.prod")
    host = [("vbench.refine", 0, 1000),
            ("service.refine", 50, 320),  # 50 of idle 0-100 and 20 of 300-350
            ("sweep", 120, 300), ("cudaDeviceSynchronize", 320, 350),
            ("service.refine", 650, 950)]  # 150 of 600-800, 50 of 900-1000
    ns = 50 + 20 + 150 + 50
    assert read(_ctx(trace=_view(host), requests=2)) == pytest.approx(ns * 1e-6 / 2)
    # the whole idle a request is larger: the rest waited on the harness
    whole = (1000 - 550) * 1e-6 / 2
    assert read(_ctx(trace=_view(host), requests=2)) < whole


def test_service_idle_clips_spans_to_the_window_and_merges_overlaps():
    read = _reader("service_idle_ms_per_request.prod")
    host = [("service.refine", -500, 60), ("service.refine", 40, 80),
            ("service.refine", 950, 2000)]
    assert read(_ctx(trace=_view(host), requests=1)) == pytest.approx((80 + 50) * 1e-6)


def test_service_idle_is_none_without_request_spans_or_trace():
    read = _reader("service_idle_ms_per_request.prod")
    assert read(_ctx(trace=_view([("vbench.refine", 0, 1000)]))) is None
    assert read(_ctx()) is None
    assert read(_ctx(trace=_view([("service.refine", 0, 1000)]), device="cpu")) is None
    assert read(_ctx(trace=_view([("service.refine", 0, 1000)]), requests=0)) is None
