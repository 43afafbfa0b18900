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


# The serving cell's arithmetic: a served wave is a request with a shape
# (rows, prompt, new) and a time to its first token.

HYBRID = {"d_model": 2560, "num_layers": 54, "hybrid_attn_every": 6, "ssm_heads": 80,
          "ssm_head_dim": 64, "ssm_state": 64, "num_heads": 32, "num_kv_heads": 32,
          "head_dim": 80, "d_ff": 10240, "conv_width": 4, "sliding_window": 4096,
          "vocab_size": 32000, "weights_dtype": "bfloat16"}


def _wave(i, start, end, first, rows=8, plen=1000, new=8):
    """A request of one served wave."""
    return loop.Request(i, start, end, 0, rows * (plen + new), 0, None,
                        (loop.Wave(rows, plen, new, first),))


def _serve_ctx(requests, window_s, trace=None):
    return readers.Context("cuda", 2.5, window_s, requests, HYBRID, None, trace=trace)


def test_ttft_mean_is_over_every_wave_of_every_request():
    waves = tuple(loop.Wave(8, 1000 + i, 8, (i + 1) / 1e3) for i in range(8))
    cycles = [loop.Request(i, i, i + 1.0, 0, sum(8 * (w.prompt + 8) for w in waves), 0, None,
                           waves) for i in range(3)]
    ctx = _serve_ctx(cycles, 10.0)
    assert readers.first_token_mean_ms(ctx) == pytest.approx(4.5)
    assert readers.tokens_per_s(ctx) == pytest.approx(3 * 8 * (8 * 1008 + 28) / 10.0)
    failed = loop.Request(3, 3.0, 4.0, 0, 0, 0, "RuntimeError: x", waves[:1])
    assert readers.first_token_mean_ms(_serve_ctx(cycles + [failed], 10.0)) == pytest.approx(4.5)
    assert readers.first_token_mean_ms(_ctx([_req(0, 0.0, 1.0)], 1.0)) is None  # no wave


def test_hybrid_flops_count_each_weight_twice_a_token():
    """The matmul part is 2 a weight of zamba2-2.7b's matrices (the
    port's own schema counts them) a token; the rest is the attention over
    the causal positions, the conv, the scan and the logits."""
    from repro_torch import configs
    from repro_torch.models import model as lm_model
    from repro_torch.models import params as plib

    schema = lm_model.build_schema(configs.get("zamba2-2.7b"))
    shared = plib.count_params(schema["shared"]["attn"]) + plib.count_params(
        schema["shared"]["mlp"])
    matrices = (sum(plib.count_params(schema["blk"][k]) for k in ("in_proj", "out_proj"))
                + 9 * shared)  # the shared block runs in each of the 9 groups
    prefill, decode = yardstick.hybrid_flops(HYBRID, 1, 1, 2)
    other = 54 * (2 * 4 * (5120 + 128) + 5 * 64 * 5120) + 9 * 4 * 2560 * 1
    assert prefill == 2 * matrices + other + 2 * 2560 * 32000
    assert decode == 2 * matrices + 54 * (2 * 4 * (5120 + 128) + 5 * 64 * 5120) \
        + 9 * 4 * 2560 * 2 + 2 * 2560 * 32000
    p8, d8 = yardstick.hybrid_flops(HYBRID, 8, 1000, 8)
    assert p8 == pytest.approx(8 * (1000 * (2 * matrices + other - 9 * 4 * 2560)
                                    + 9 * 4 * 2560 * 1000 * 1001 / 2 + 2 * 2560 * 32000))
    assert d8 > 7 * 8 * 2 * matrices


def test_serve_mfu_is_all_waves_over_the_window():
    waves = [_wave(0, 0.0, 1.0, 0.4), _wave(1, 1.0, 2.0, 0.5, plen=2000)]
    ctx = _serve_ctx(waves, 4.0)
    ops = sum(sum(yardstick.hybrid_flops(HYBRID, *w.waves[0][:3])) for w in waves)
    assert readers.serve_mfu(ctx) == pytest.approx(100.0 * ops / 4.0 / 989.4e12)
    pre = sum(yardstick.hybrid_flops(HYBRID, *w.waves[0][:3])[0] for w in waves)
    assert readers.prefill_mfu(ctx) == pytest.approx(100.0 * pre / 0.9 / 989.4e12)


def test_mamba2_scan_bound_at_the_prefill_row():
    """The Mamba2 entry's row at the Zamba2 prefill shape (B 2 x 4096, H 80,
    64 x 64, bf16): 175.1 MB and 12.47 G float32 operations, 0.1861 ms."""
    b = yardstick.mamba2_scan_bound(2, 4096, 80, 64, 64, 2)
    assert b["bytes"] == pytest.approx(175.1e6, rel=1e-3)
    assert b["ops"] == pytest.approx(12.47e9, rel=1e-3)
    assert b["bound_by"] == "operations" and b["bound_s"] * 1e3 == pytest.approx(0.1861, rel=1e-3)


def test_serving_rooflines_read_their_kernels_only():
    waves = [_wave(0, 0.0, 1.0, 0.4, plen=1000, new=3)]
    view = traceview.TraceView(window=(0, 10**9), device_ops=[
        ("void mamba2_scan_kernel<__nv_bfloat16, 32>", 0, 3000),
        ("void mamba2_prep_kernel<__nv_bfloat16, 32>", 3000, 4000),
        ("void scan_kernel<__nv_bfloat16>", 4000, 9000),  # the general entry's: not read
        ("void decode_attn_split<__nv_bfloat16, 64, true, 3>", 9000, 9500),
        ("void merge_kernel<__nv_bfloat16>", 9500, 9600)], host_ops=[])
    ctx = _serve_ctx(waves, 1.0, trace=view)
    scan = 54 * yardstick.mamba2_scan_bound(8, 1000, 80, 64, 64, 2)["bound_s"]
    assert readers.chunk_scan_roofline(ctx) == pytest.approx(100.0 * scan / 4000e-9)
    attn = sum(9 * yardstick.decode_attn_bound(8, pos + 1, 32, 1, 80, 2)["bound_s"]
               for pos in (1000, 1001))
    assert readers.decode_attn_roofline(ctx) == pytest.approx(100.0 * attn / 600e-9)
    view.device_ops[:] = view.device_ops[2:3]  # no launch of either: nothing to read
    assert readers.chunk_scan_roofline(ctx) is None and readers.decode_attn_roofline(ctx) is None
    assert readers.chunk_scan_roofline(_serve_ctx(waves, 1.0)) is None  # untraced
