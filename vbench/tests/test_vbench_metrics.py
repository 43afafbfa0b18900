"""The metrics' arithmetic: a tail over every request, a rate over the
whole window, the idle share of a trace with overlapping kernels, the
yardstick at the production shape."""

import statistics
import types

import pytest
import torch

from vbench import loop, readers, traceview, yardstick


def _req(i, start, end, sweeps=3, tokens=300, models=0, error=None):
    return loop.Request(i, start, end, sweeps, tokens, models, error)


def _corpus(docs, words, weights):
    return types.SimpleNamespace(corpus=types.SimpleNamespace(
        docs=torch.tensor(docs), words=torch.tensor(words), weights=torch.tensor(weights)))


#: One model of 100 live tokens (and one padded), over 10 docs and 20 words.
INPUTS = [_corpus([i % 10 for i in range(101)], [i % 20 for i in range(101)],
                  [1.0] * 100 + [0.0])]


def _ctx(requests, window_s, trace=None, **kw):
    return readers.Context("cuda", 2.5, window_s, requests, {"num_topics": 12}, INPUTS,
                           trace=trace, **kw)


def test_p95_is_over_every_request():
    lat = [float(x) for x in range(1, 101)]  # ms
    reqs = [_req(i, 0.0, x / 1e3) for i, x in enumerate(lat)]
    assert readers.request_p95_ms(_ctx(reqs, 1.0)) == pytest.approx(95.05)
    assert yardstick.percentile(lat, 95) == pytest.approx(95.05)
    # not a median of chunks: one slow chunk of five moves it
    chunks = [statistics.median(lat[i:i + 20]) for i in range(0, 100, 20)]
    assert yardstick.percentile(chunks, 95) != pytest.approx(95.05)


def test_rate_is_all_work_over_the_whole_window():
    reqs = [_req(0, 0.0, 0.1, tokens=1000), _req(1, 0.1, 0.2, tokens=1000),
            _req(2, 0.2, 2.0, tokens=1000, models=5)]  # a stall counts in full
    ctx = _ctx(reqs, 2.0)
    assert readers.tokens_per_s(ctx) == pytest.approx(1500.0)
    assert readers.setup_s(ctx) == 2.5


def _view():
    # window 0..100 ns; kernels overlap (10-30, 20-40), then 50-60; a host op
    # covers 40-50 (the gap's middle) and an outer one covers everything
    device = [("k_a", 10, 30), ("k_b", 20, 40), ("resample_warp_kernel<1>", 50, 60)]
    host = [("outer", 0, 100), ("aten::index_add_", 40, 50), ("python", 60, 100)]
    return traceview.TraceView(window=(0, 100), device_ops=device, host_ops=host)


def test_idle_share_of_overlapping_kernels():
    view = _view()
    assert view.busy_intervals() == [(10, 40), (50, 60)]
    assert view.busy_s() == pytest.approx(40e-9)
    ctx = _ctx([_req(0, 0.0, 1.0, sweeps=2)], 1.0, trace=view)
    assert readers.idle_share(ctx) == pytest.approx(60.0)
    gaps = dict(view.idle_gaps())
    assert gaps == pytest.approx({"outer": 10e-9, "aten::index_add_": 10e-9, "python": 40e-9})
    assert readers.launches_per_sweep(ctx) == pytest.approx(1.5)


def test_roofline_is_bound_over_kernel_time():
    view = _view()
    ctx = _ctx([_req(0, 0.0, 1.0, sweeps=2)], 1.0, trace=view)
    assert yardstick.rows_touched([INPUTS[0].corpus]) == (10, 20)
    bound = yardstick.gibbs_kernel_bound(100, 12, 10, 20)["bound_s"]
    assert readers.gibbs_roofline(ctx) == pytest.approx(100.0 * 2 * bound / 10e-9)
    assert readers.alias_roofline(ctx) is None  # no alias sweep, no launch: nothing to read
    ctx.alias_rounds = 4
    assert readers.alias_roofline(ctx) is None
    view.device_ops.append(("void alias_mh_kernel<int, false, true, 4>", 60, 80))
    view.device_ops.append(("void log_tables_kernel<int>", 80, 90))
    bound = yardstick.alias_kernel_bound(100, 4)["bound_s"]
    assert readers.alias_roofline(ctx) == pytest.approx(100.0 * 2 * bound / 30e-9)


def test_mfu_counts_the_dense_conditional_over_the_window():
    ctx = _ctx([_req(0, 0.0, 1.0, sweeps=4)], 2.0)  # no trace needed
    ops = 4 * 100 * 12 * yardstick.SCORE_OPS
    assert readers.sweep_mfu(ctx) == pytest.approx(100.0 * ops / 2.0 / 67e12)


def test_sweep_bound_at_the_production_shape():
    b = yardstick.sweep_bound(16_777_216, 256, 200_000, 250_000)
    assert b["bytes"] == 1_257_146_368
    assert b["ops"] == 38_654_705_664
    assert b["bound_by"] == "operations"


def test_kernel_bounds():
    g = yardstick.gibbs_kernel_bound(16_777_216, 256, 200_000, 250_000)
    assert g["ops"] == 16_777_216 * 256 * 17 and g["bound_by"] == "operations"
    assert g["bound_s"] == pytest.approx(g["ops"] / 67e12)
    a = yardstick.alias_kernel_bound(16_777_216, 4)
    assert a["bytes"] == 20 * 16_777_216 and a["bound_by"] == "bytes"
