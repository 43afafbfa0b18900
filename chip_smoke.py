#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one CUDA card and check it.

    python3 chip_smoke.py

Phases:
  0. setup       the card (nvidia-smi name and power limit), torch/CUDA/nvcc
                 versions; builds every kernel from `src/repro_torch/**/csrc`
                 (one nvcc per source, all started together)
  1. kernels     each kernel against its plain PyTorch version on the card,
                 over a grid of shapes and count formats (and, for alias_mh,
                 MH round counts); near-ties are exempt and counted
  2. main path   the §5 case study (`examples/quickstart.py`'s config) over the
                 wire through an in-process `VedaliaClient(device="cuda")`:
                 fit 30, refine 70, two view syncs, top reviews, perplexity,
                 once on the exact `torch` backend and once on `alias`;
                 kernel launch counters are zeroed just before each run and
                 read just after, and each perplexity must land within 5% of
                 the same run of the port on the CPU; after each run, that
                 path's kernel against its plain version at the path's own
                 shape (one 4096-token block; all tokens with one sweep's
                 alias tables and draws)
  3. scale       a popular product (10,000 reviews, V = 10,000) fit with the
                 single-launch `cuda` backend: sweep time, tokens/s, the
                 kernel's time against its byte bound and its plain version
  4. large_fit   the same popular product over the wire with `backend="auto"`,
                 which must route to `alias` (>= 100k tokens): fit 100 sweeps
                 (one alias_mh launch each), a view sync, the count
                 invariants, perplexity within 0.3 in log of phase 3's exact
                 fit; then sweep time, a per-stage breakdown, the profiler's
                 top device ops and the kernel against its bound and plain
                 version

Prints one JSON line per phase, then the kernels line, then
`{"ok": true, "device": {...}}` as the last line. Any failure raises and
exits non-zero; without CUDA it exits 2 before doing anything.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and float32 outside the
# tensor cores; the kernel's bound is the larger of bytes/rate and ops/rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
NEAR_TIE = 1e-5  # margin below which an ulp of `log` may flip a decision
PPX_BAND = 0.05
LOG_PPX_BAND = 0.3  # alias at 100 sweeps vs the exact sweep at 30 (the reference's band)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def run_text(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds of `fn()` on the card, by CUDA events over `reps`."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# -- phase 0 ---------------------------------------------------------------


def phase_setup():
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.alias_mh import kernel as alias_kernel
    from repro_torch.kernels.lda_gibbs import kernel as lda_kernel

    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    print(smi, flush=True)
    builds = {"lda_gibbs.resample": lda_kernel.build, "alias_mh.resample": alias_kernel.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        futures = {name: pool.submit(b) for name, b in builds.items()}
        reports = {name: f.result() for name, f in futures.items()}
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in rep.splitlines() if "registers" in ln or "spill" in ln]
             for name, (_, rep) in reports.items()}
    emit({
        "phase": "setup",
        "gpu": smi,
        "driver": run_text(["nvidia-smi", "--query-gpu=driver_version",
                            "--format=csv,noheader"]).splitlines()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": run_text([_build.nvcc(), "--version"]).splitlines()[-1],
        "python": sys.version.split()[0],
        "build_s": round(build_s, 3),
        "ptxas": ptxas,
    })
    return smi


# -- phase 1 ---------------------------------------------------------------


def _random_inputs(n, k, w_bits, d=2000, v=10000, seed=0):
    """Token ids, assignments, weights (10% zero), count tables of plausible
    magnitude (float32 or int32 fixed point) and Gumbel noise, on the card."""
    import torch

    from repro_torch.kernels.lda_gibbs import ops

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    docs = torch.randint(0, d, (n,), generator=gen, device=dev, dtype=torch.int32)
    words = torch.randint(0, v, (n,), generator=gen, device=dev, dtype=torch.int32)
    z = torch.randint(0, k, (n,), generator=gen, device=dev, dtype=torch.int32)
    weights = torch.rand(n, generator=gen, device=dev)
    weights = torch.where(torch.rand(n, generator=gen, device=dev) < 0.1, 0.0, weights)
    n_dt = torch.rand(d, k, generator=gen, device=dev) * 6.0
    n_wt = torch.rand(v, k, generator=gen, device=dev) * 3.0
    n_t = n_wt.sum(0)
    if w_bits is not None:
        s = float(1 << (w_bits + 1))
        n_dt, n_wt, n_t = (torch.round(x * s).to(torch.int32) for x in (n_dt, n_wt, n_t))
    noise = ops.gumbel((n, k), gen, dev)
    return (docs, words, z, weights, n_dt, n_wt, n_t, noise)


def compare(args, *, alpha, beta, beta_bar, w_bits):
    """Kernel vs plain on identical inputs: (mismatches outside near-ties,
    near-tie mismatches, tokens with a near-tie top-2, max score gap)."""
    import torch

    from repro_torch.kernels.lda_gibbs import ops

    hp = dict(alpha=alpha, beta=beta, beta_bar=beta_bar, w_bits=w_bits)
    z_k = ops.resample(*args, **hp)
    torch.cuda.synchronize()
    z_p = ops.resample_plain(*args, **hp)
    scores = ops.perturbed_scores(*args, **hp)
    weights = args[3]
    live = weights > 0
    top2 = torch.topk(scores, min(2, scores.shape[1]), dim=1).values
    near = live & (top2[:, 0] - top2[:, -1] < NEAR_TIE)
    best = scores.gather(1, z_p.long()[:, None])[:, 0]
    got = scores.gather(1, z_k.long()[:, None])[:, 0]
    gap = torch.where(live, best - got, 0.0)
    differ = z_k != z_p
    bad = differ & (gap >= NEAR_TIE)
    frozen_bad = (~live) & (z_k != args[2])
    return (int(bad.sum()) + int(frozen_bad.sum()), int((differ & ~bad).sum()),
            int(near.sum()), float(gap.abs().max()))


def phase_kernels():
    hp = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * 10000)
    cases = []
    for k in (12, 128, 1000):
        for n in (65536, 40009):
            for w_bits in (None, 8):
                args = _random_inputs(n, k, w_bits, seed=k * 7 + n)
                bad, near_flip, near, gap = compare(args, w_bits=w_bits, **hp)
                cases.append({"k": k, "n": n, "w_bits": w_bits, "mismatch": bad,
                              "near_tie_flips": near_flip, "near_ties": near,
                              "max_abs_err": gap})
    out = {
        "phase": "kernels",
        "kernels": ["lda_gibbs.resample"],
        "mismatches": sum(c["mismatch"] for c in cases),
        "near_tie_flips": sum(c["near_tie_flips"] for c in cases),
        "near_ties": sum(c["near_ties"] for c in cases),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "cases": cases,
    }
    emit(out)
    if out["mismatches"]:
        raise SystemExit(f"kernel disagrees with its plain version: {out['mismatches']} tokens")
    return out


def _alias_inputs(n, k, w_bits, mh_steps, d=2000, v=10000, seed=0):
    """The alias_mh kernel's arguments on the card: token ids, assignments,
    weights (10% zero), stored count tables (float32, or int32 fixed point
    with real counts on its grid), the stale alias tables built from the
    real counts, and one sweep's (S, N) draws."""
    import torch

    from repro_torch.core import alias, codec
    from repro_torch.core.types import LDAConfig

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    cfg = LDAConfig(num_topics=k, vocab_size=v, num_docs=d, w_bits=w_bits)
    sc = codec.codec_for(cfg)
    docs = torch.randint(0, d, (n,), generator=gen, device=dev, dtype=torch.int32)
    words = torch.randint(0, v, (n,), generator=gen, device=dev, dtype=torch.int32)
    z = torch.randint(0, k, (n,), generator=gen, device=dev, dtype=torch.int32)
    weights = torch.rand(n, generator=gen, device=dev)
    weights = torch.where(torch.rand(n, generator=gen, device=dev) < 0.1, 0.0, weights)
    n_dt = sc.decode_array(sc.encode_array(torch.rand(d, k, generator=gen, device=dev) * 6.0))
    n_wt = sc.decode_array(sc.encode_array(torch.rand(v, k, generator=gen, device=dev) * 3.0))
    tables = alias.sweep_tables(cfg, n_dt, n_wt)
    counts = tuple(sc.encode_array(x) for x in (n_dt, n_wt, n_wt.sum(0)))
    draws = alias.sweep_draws(gen, n, k, mh_steps, dev)
    return (docs, words, z, weights, *counts, *tables, *draws)


def compare_alias(args, *, alpha, beta, beta_bar, w_bits):
    """alias_mh kernel vs plain on identical inputs: (mismatches outside
    near-ties plus frozen tokens that moved, near-tie mismatches, tokens with
    a near-tie in some round, the largest smallest-margin among mismatched
    tokens — 0 when the two agree everywhere, tokens the kernel moved)."""
    import torch

    from repro_torch.kernels.alias_mh import ops

    hp = dict(alpha=alpha, beta=beta, beta_bar=beta_bar, w_bits=w_bits)
    z_k = ops.mh_resample(*args, **hp)
    torch.cuda.synchronize()
    z_p = ops.mh_resample_plain(*args, **hp)
    acc, prop = ops.margins(*args, **hp)
    live = args[3] > 0
    near = live & ((acc < NEAR_TIE) | (prop < NEAR_TIE))
    differ = z_k != z_p
    bad = differ & ~near
    frozen_bad = (~live) & (z_k != args[2])
    gap = torch.where(differ & live, torch.minimum(acc, prop), 0.0)
    return (int(bad.sum()) + int(frozen_bad.sum()), int((differ & near).sum()),
            int(near.sum()), float(gap.max()), int((z_k != args[2]).sum()))


def phase_alias_kernel():
    hp = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * 10000)
    cases = []
    for k in (12, 128, 1000):
        for n in (65536, 40009):
            for w_bits in (None, 8):
                for mh_steps in (2, 4):
                    args = _alias_inputs(n, k, w_bits, mh_steps, seed=k * 7 + n + mh_steps)
                    bad, near_flip, near, gap, moved = compare_alias(args, w_bits=w_bits, **hp)
                    cases.append({"k": k, "n": n, "w_bits": w_bits, "mh_steps": mh_steps,
                                  "mismatch": bad, "near_tie_flips": near_flip,
                                  "near_ties": near, "max_abs_err": gap, "moved": moved})
    out = {
        "phase": "kernels",
        "kernels": ["alias_mh.resample"],
        "mismatches": sum(c["mismatch"] for c in cases),
        "near_tie_flips": sum(c["near_tie_flips"] for c in cases),
        "near_ties": sum(c["near_ties"] for c in cases),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "cases": cases,
    }
    emit(out)
    if out["mismatches"]:
        raise SystemExit(f"alias_mh kernel disagrees with its plain version: "
                         f"{out['mismatches']} tokens")
    if any(c["moved"] == 0 for c in cases):
        raise SystemExit("alias_mh kernel moved no token in some case")
    return out


# -- phase 2 ---------------------------------------------------------------

QUICKSTART = dict(num_reviews=487, vocab_size=800, num_topics=8, mean_tokens=60, seed=42)


def _quickstart_run(device, corp_reviews, backend):
    import torch

    from repro_torch.api import VedaliaClient

    if device == "cpu":
        # One thread: the CPU reference runs small (4096, 12) blocks, where
        # a thread pool costs more than it gains.
        torch.set_num_threads(1)
    client = VedaliaClient(device=device, backend=backend)
    t0 = time.perf_counter()
    fit = client.fit(corp_reviews, num_topics=12, base_vocab=QUICKSTART["vocab_size"],
                     w_bits=8, num_sweeps=30, seed=0)
    fit_s = time.perf_counter() - t0
    fit = client.refine(fit.handle_id, num_sweeps=70, seed=1)
    total_s = time.perf_counter() - t0
    sync = client.sync_view(fit.handle_id, top_n=8, mass_coverage=0.9, max_topics=6)
    resync = client.sync_view(fit.handle_id, top_n=8, mass_coverage=0.9, max_topics=6)
    tops = {t: client.top_reviews(fit.handle_id, t, n=3).review_ids for t in sync.topic_ids}
    ppx = client.perplexity(fit.handle_id)
    return client, fit, sync, resync, tops, ppx, fit_s, total_s


def _check_invariants(service, handle_id):
    """n_t sums to the total weight; the counts rebuild from z."""
    import torch

    from repro_torch.core import codec

    h = service.handles[handle_id]
    cfg, corpus, state = h.cfg, h.model.corpus, h.model.state
    n_t = codec.decode_array(cfg, state.n_t)
    total_w = float(corpus.weights.double().sum())
    # fixed point rounds each of the K totals by at most half a unit
    tol = 1e-4 * total_w + cfg.num_topics / (1 << ((cfg.w_bits or 0) + 1))
    if abs(float(n_t.double().sum()) - total_w) > tol:
        raise SystemExit(f"n_t sums to {float(n_t.sum())}, weights to {total_w}")
    rebuilt = codec.rebuild_state(cfg, corpus, state.z)
    for name in ("n_dt", "n_wt", "n_t"):
        dev = float((getattr(rebuilt, name).double() - getattr(state, name).double()).abs().max())
        if dev > 2.0:  # float scatter-add order on the card may move a rounding
            raise SystemExit(f"{name} does not rebuild from z (max deviation {dev})")
    tensors = (state.z, state.n_dt, state.n_wt, state.n_t, corpus.docs)
    if not all(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        raise SystemExit("served state is not on the card")


def phase_main_path(backend):
    """The case study on `backend`: "jnp" (the reference's name for the
    exact blocked `torch` sweep, ⌈N/4096⌉ lda_gibbs launches a sweep) or
    "alias" (one alias_mh launch a sweep)."""
    import torch

    from repro_torch.data import reviews
    from repro_torch.kernels.alias_mh import ops as alias_ops
    from repro_torch.kernels.lda_gibbs import ops

    corp = reviews.generate(reviews.SyntheticSpec(**QUICKSTART))
    ops.resample.launches = 0
    alias_ops.mh_resample.launches = 0
    client, fit, sync, resync, tops, ppx, fit_s, total_s = _quickstart_run(
        "cuda", corp.reviews, backend)
    torch.cuda.synchronize()
    launches = {"lda_gibbs.resample": ops.resample.launches,
                "alias_mh.resample": alias_ops.mh_resample.launches}
    service = client.server.service
    _check_invariants(service, fit.handle_id)
    handle = service.handles[fit.handle_id]
    n = handle.model.corpus.num_tokens
    expected = {"jnp": {"lda_gibbs.resample": 100 * math.ceil(n / 4096), "alias_mh.resample": 0},
                "alias": {"lda_gibbs.resample": 0, "alias_mh.resample": 100}}[backend]
    if backend == "jnp" and launches["lda_gibbs.resample"] == 0:
        raise SystemExit("the main path launched no lda_gibbs kernel")
    if backend == "alias" and launches != expected:
        raise SystemExit(f"the alias main path launched {launches}, expected {expected}")
    if not sync.valid or len(resync.topics) != 0 or not resync.delta:
        raise SystemExit(f"view sync failed: valid={sync.valid}, re-sent {len(resync.topics)}")
    cpu = _quickstart_run("cpu", corp.reviews, backend)
    ppx_cpu = cpu[5]
    rel = abs(ppx - ppx_cpu) / ppx_cpu
    out = {
        "phase": "main_path" if backend == "jnp" else f"main_path_{backend}",
        "tokens": n, "num_topics": fit.num_topics,
        "vocab": handle.cfg.vocab_size, "backend": fit.backend,
        "launches": launches, "expected_launches": expected,
        "fit_30_s": round(fit_s, 4), "fit_plus_refine_100_s": round(total_s, 4),
        "core_topics": sync.topic_ids, "view_bytes": sync.payload_bytes,
        "delta_bytes": resync.payload_bytes, "top_reviews": {str(k): v for k, v in tops.items()},
        "perplexity": ppx, "perplexity_cpu": ppx_cpu, "perplexity_rel_diff": rel,
    }
    emit(out)
    if not math.isfinite(ppx) or rel > PPX_BAND:
        raise SystemExit(f"card perplexity {ppx} vs CPU {ppx_cpu}: {rel:.2%} > {PPX_BAND:.0%}")
    return out, handle


# -- phase 3 ---------------------------------------------------------------

POPULAR = dict(num_reviews=10_000, vocab_size=2_000, num_topics=8, mean_tokens=60, seed=42)


def kernel_timing(cfg, corpus, state, reps=50):
    """The wrapper vs its plain version on one sweep's inputs: agreement,
    mean ms of each, and the kernel's bound from these inputs' bytes."""
    import torch

    from repro_torch.core import codec
    from repro_torch.kernels.lda_gibbs import ops

    n, k = corpus.num_tokens, cfg.num_topics
    gen = torch.Generator(device="cuda").manual_seed(123)
    noise = ops.gumbel((n, k), gen, "cuda")
    args = (corpus.docs, corpus.words, state.z, corpus.weights,
            state.n_dt, state.n_wt, state.n_t, noise)
    hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar,
              w_bits=codec.codec_for(cfg).spec.w_bits)
    bad, near_flip, near, gap = compare(args, **hp)
    ms = cuda_ms(lambda: ops.resample(*args, **hp), reps)
    plain_ms = cuda_ms(lambda: ops.resample_plain(*args, **hp), max(3, reps // 10))
    table_bytes = sum(t.numel() * t.element_size() for t in (state.n_dt, state.n_wt, state.n_t))
    moved = n * (4 * 4 + 4 * k + 4) + table_bytes  # ids/z/weight + noise + out; tables once
    ops_count = n * k * 12  # 3 logs (~4 ops each) per token-topic; adds and max are fewer
    bound_ms = max(moved / HBM_BYTES_PER_S, ops_count / F32_OPS_PER_S) * 1e3
    return {
        "n": n, "k": k, "d": state.n_dt.shape[0], "v": state.n_wt.shape[0],
        "w_bits": hp["w_bits"], "mismatch": bad, "near_tie_flips": near_flip,
        "near_ties": near, "max_abs_err": gap, "ms": ms, "plain_ms": plain_ms,
        "bytes": moved, "bound_ms": bound_ms,
        "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops_count / F32_OPS_PER_S
        else "operations",
        "gathered_bytes": n * (4 * 4 + 4 * k + 4 + 2 * 4 * k),
    }


def sweep_breakdown(cfg, corpus, state, reps=20):
    """Mean ms of each stage of one `cuda`-backend sweep, by CUDA events:
    the noise draw, the kernel, and the count rebuild."""
    import torch

    from repro_torch.core import codec
    from repro_torch.kernels.lda_gibbs import ops

    gen = torch.Generator(device="cuda").manual_seed(11)
    shape = (corpus.num_tokens, cfg.num_topics)
    noise = ops.gumbel(shape, gen, "cuda")
    z_new = ops.sweep_resample(cfg, state, corpus, gen, noise)
    return {
        "noise": cuda_ms(lambda: ops.gumbel(shape, gen, "cuda"), reps),
        "resample": cuda_ms(lambda: ops.sweep_resample(cfg, state, corpus, gen, noise), reps),
        "rebuild": cuda_ms(lambda: codec.rebuild_state(cfg, corpus, z_new), reps),
    }


def profile_sweeps(sampler, cfg, corpus, state, sweeps=5, top=8):
    """Device time by kernel name over a few sweeps (`torch.profiler`);
    an empty list means the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(13)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(sweeps):
            state = sampler.sweep(cfg, state, corpus, gen)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    return [{"name": k[:80], "ms_per_sweep": us / 1e3 / sweeps, "calls": c}
            for us, k, c in rows[:top]]


def phase_scale():
    import torch

    from repro_torch.api import VedaliaClient
    from repro_torch.api.backends import get_backend
    from repro_torch.data import reviews
    from repro_torch.kernels.lda_gibbs import ops

    t0 = time.perf_counter()
    corp = reviews.generate(reviews.SyntheticSpec(**POPULAR))
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.resample.launches = 0
    client = VedaliaClient(device="cuda", backend="cuda")
    t0 = time.perf_counter()
    fit = client.fit(corp.reviews, num_topics=12, base_vocab=POPULAR["vocab_size"],
                     w_bits=8, num_sweeps=30, seed=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = ops.resample.launches
    service = client.server.service
    _check_invariants(service, fit.handle_id)
    handle = service.handles[fit.handle_id]
    cfg, corpus = handle.cfg, handle.model.corpus
    n = corpus.num_tokens

    sampler = get_backend("cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    state = handle.model.state
    sweep_ms = []
    for _ in range(30):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = sampler.sweep(cfg, state, corpus, gen)
        torch.cuda.synchronize()
        sweep_ms.append((time.perf_counter() - t) * 1e3)
    med = statistics.median(sweep_ms)
    timing = kernel_timing(cfg, corpus, state)
    breakdown = sweep_breakdown(cfg, corpus, state)
    out = {
        "phase": "scale", "tokens": n, "docs": cfg.num_docs, "vocab": cfg.vocab_size,
        "num_topics": cfg.num_topics, "generate_s": round(gen_s, 3),
        "fit_30_s": round(fit_s, 4), "fit_launches": launches,
        "sweep_ms_median": med, "sweep_ms_min": min(sweep_ms), "sweep_ms_max": max(sweep_ms),
        "tokens_per_s": n / (med / 1e3), "perplexity": fit.perplexity,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "kernel": timing,
        "sweep_breakdown_ms": breakdown,
        "profile_top_device_ms": profile_sweeps(sampler, cfg, corpus, state),
    }
    emit(out)
    if launches != 30 or timing["mismatch"] or not math.isfinite(fit.perplexity):
        raise SystemExit(f"scale phase failed: launches={launches}, "
                         f"mismatch={timing['mismatch']}, ppx={fit.perplexity}")
    return out


# -- phase 4 ---------------------------------------------------------------


def alias_kernel_timing(cfg, corpus, state, mh_steps, reps=50):
    """The alias_mh wrapper vs its plain version on one sweep's inputs:
    agreement, mean ms of each, and the kernel's bound from these inputs."""
    import torch

    from repro_torch.core import alias, codec
    from repro_torch.kernels.alias_mh import kernel, ops

    n, k = corpus.num_tokens, cfg.num_topics
    sc = codec.codec_for(cfg)
    tables = alias.sweep_tables(cfg, sc.decode_array(state.n_dt), sc.decode_array(state.n_wt))
    draws = alias.sweep_draws(torch.Generator(device="cuda").manual_seed(123), n, k,
                              mh_steps, "cuda")
    args = (corpus.docs, corpus.words, state.z, corpus.weights,
            state.n_dt, state.n_wt, state.n_t, *tables, *draws)
    hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar, w_bits=sc.spec.w_bits)
    bad, near_flip, near, gap, moved = compare_alias(args, **hp)
    # The kernel alone: launches on validated inputs into one output, so the
    # wrapper's host work (checks, allocation) does not pace the card; the
    # wrapper's own time per call is what a sweep pays.
    z_out = torch.empty_like(state.z)
    scale = 1.0 if hp["w_bits"] is None else 2.0 ** -(hp["w_bits"] + 1)
    ms = cuda_ms(lambda: kernel.launch(*args, z_out, alpha=cfg.alpha, beta=cfg.beta,
                                       beta_bar=cfg.beta_bar, scale=scale), reps * 4)
    wrapper_ms = cuda_ms(lambda: ops.mh_resample(*args, **hp), reps)
    plain_ms = cuda_ms(lambda: ops.mh_resample_plain(*args, **hp), max(3, reps // 10))
    table_bytes = sum(t.numel() * t.element_size()
                      for t in (state.n_dt, state.n_wt, state.n_t, *tables))
    # ids/z/weight 16 B + three draws a round + the output, per token; every
    # count and alias table read once
    moved_bytes = n * (4 * 4 + 12 * mh_steps + 4) + table_bytes
    ops_count = n * mh_steps * (9 * 4 + 20)  # 9 logs (~4 ops each) + ~20 others a round
    bound_ms = max(moved_bytes / HBM_BYTES_PER_S, ops_count / F32_OPS_PER_S) * 1e3
    return {
        "n": n, "k": k, "d": state.n_dt.shape[0], "v": state.n_wt.shape[0],
        "w_bits": hp["w_bits"], "mh_steps": mh_steps, "mismatch": bad,
        "near_tie_flips": near_flip, "near_ties": near, "max_abs_err": gap, "moved": moved,
        "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "bytes": moved_bytes,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if moved_bytes / HBM_BYTES_PER_S >= ops_count / F32_OPS_PER_S
        else "operations",
    }


def alias_sweep_breakdown(cfg, corpus, state, mh_steps, reps=20):
    """Mean ms of each stage of one `alias`-backend sweep, by CUDA events:
    the table build, the draws, the kernel, and the count rebuild."""
    import torch

    from repro_torch.core import alias, codec
    from repro_torch.kernels.alias_mh import ops

    n, k = corpus.num_tokens, cfg.num_topics
    sc = codec.codec_for(cfg)
    gen = torch.Generator(device="cuda").manual_seed(17)

    def tables():
        return alias.sweep_tables(cfg, sc.decode_array(state.n_dt), sc.decode_array(state.n_wt))

    tabs = tables()
    draws = alias.sweep_draws(gen, n, k, mh_steps, "cuda")
    hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar, w_bits=sc.spec.w_bits)

    def resample():
        return ops.mh_resample(corpus.docs, corpus.words, state.z, corpus.weights, state.n_dt,
                               state.n_wt, state.n_t, *tabs, *draws, **hp)

    z_new = resample()
    return {
        "tables": cuda_ms(tables, reps),
        "draws": cuda_ms(lambda: alias.sweep_draws(gen, n, k, mh_steps, "cuda"), reps),
        "kernel": cuda_ms(resample, reps),
        "rebuild": cuda_ms(lambda: codec.rebuild_state(cfg, corpus, z_new), reps),
    }


def phase_large_fit(exact_ppx):
    """The popular product over the wire with `backend="auto"`: it must
    resolve to `alias` and launch the alias_mh kernel once a sweep."""
    import torch

    from repro_torch.api import VedaliaClient
    from repro_torch.data import reviews
    from repro_torch.kernels.alias_mh import ops as alias_ops
    from repro_torch.kernels.lda_gibbs import ops

    corp = reviews.generate(reviews.SyntheticSpec(**POPULAR))
    torch.cuda.reset_peak_memory_stats()
    client = VedaliaClient(device="cuda", backend="auto")
    ops.resample.launches = 0
    alias_ops.mh_resample.launches = 0
    t0 = time.perf_counter()
    fit = client.fit(corp.reviews, num_topics=12, base_vocab=POPULAR["vocab_size"],
                     w_bits=8, num_sweeps=100, seed=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"lda_gibbs.resample": ops.resample.launches,
                "alias_mh.resample": alias_ops.mh_resample.launches}
    sync = client.sync_view(fit.handle_id, top_n=8, mass_coverage=0.9, max_topics=6)
    resync = client.sync_view(fit.handle_id, top_n=8, mass_coverage=0.9, max_topics=6)
    service = client.server.service
    _check_invariants(service, fit.handle_id)
    handle = service.handles[fit.handle_id]
    cfg, corpus = handle.cfg, handle.model.corpus
    n = corpus.num_tokens
    sampler = service.sampler("alias")
    mh_steps = sampler.mh_steps
    log_gap = abs(math.log(fit.perplexity) - math.log(exact_ppx))

    gen = torch.Generator(device="cuda").manual_seed(7)
    state = handle.model.state
    sweep_ms = []
    for _ in range(30):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = sampler.sweep(cfg, state, corpus, gen)
        torch.cuda.synchronize()
        sweep_ms.append((time.perf_counter() - t) * 1e3)
    med = statistics.median(sweep_ms)
    timing = alias_kernel_timing(cfg, corpus, state, mh_steps)
    out = {
        "phase": "large_fit", "tokens": n, "docs": cfg.num_docs, "vocab": cfg.vocab_size,
        "num_topics": cfg.num_topics, "mh_steps": mh_steps, "backend": fit.backend,
        "fit_100_s": round(fit_s, 4), "launches": launches,
        "perplexity": fit.perplexity, "perplexity_exact_cuda_30": exact_ppx,
        "log_perplexity_gap": log_gap, "core_topics": sync.topic_ids,
        "view_bytes": sync.payload_bytes, "delta_bytes": resync.payload_bytes,
        "sweep_ms_median": med, "sweep_ms_min": min(sweep_ms), "sweep_ms_max": max(sweep_ms),
        "tokens_per_s": n / (med / 1e3),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "kernel": timing,
        "sweep_breakdown_ms": alias_sweep_breakdown(cfg, corpus, state, mh_steps),
        "profile_top_device_ms": profile_sweeps(sampler, cfg, corpus, state),
    }
    emit(out)
    want = {"lda_gibbs.resample": 0, "alias_mh.resample": 100}
    if fit.backend != "alias" or launches != want:
        raise SystemExit(f"auto resolved to {fit.backend!r} with launches {launches}; "
                         f"expected 'alias' with {want}")
    if not sync.valid or len(resync.topics) != 0 or not resync.delta:
        raise SystemExit(f"view sync failed: valid={sync.valid}, re-sent {len(resync.topics)}")
    if not math.isfinite(fit.perplexity) or log_gap > LOG_PPX_BAND:
        raise SystemExit(f"alias perplexity {fit.perplexity} vs exact {exact_ppx}: "
                         f"log gap {log_gap:.3f} > {LOG_PPX_BAND}")
    if timing["mismatch"]:
        raise SystemExit(f"alias_mh kernel disagrees with its plain version at the "
                         f"large-fit shape: {timing['mismatch']} tokens")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_setup()
    kern = phase_kernels()
    alias_kern = phase_alias_kernel()
    main_out, handle = phase_main_path("jnp")
    # The main path's own shape: one 4096-token block against its tables.
    # The torch backend hands the kernel real-unit (decoded) float32 tables.
    from repro_torch.core import codec
    from repro_torch.core.types import Corpus, LDAState

    cfg, corpus, state = handle.cfg, handle.model.corpus, handle.model.state
    block = Corpus(*(t[:4096].contiguous() for t in (corpus.docs, corpus.words, corpus.weights)))
    block_state = LDAState(state.z[:4096].contiguous(), *codec.decode_counts(cfg, state))
    block_timing = kernel_timing(dataclasses.replace(cfg, w_bits=None), block, block_state,
                                 reps=200)
    emit({"phase": "main_path_kernel", "kernel": block_timing})
    _, alias_handle = phase_main_path("alias")
    # The alias path's own shape: all of the case study's tokens, one sweep's
    # tables and draws from its fitted state.
    from repro_torch.api.backends import get_backend

    ah = alias_handle
    alias_block = alias_kernel_timing(ah.cfg, ah.model.corpus, ah.model.state,
                                      get_backend("alias").mh_steps, reps=200)
    emit({"phase": "main_path_alias_kernel", "kernel": alias_block})
    if alias_block["mismatch"]:
        raise SystemExit(f"alias_mh kernel disagrees with its plain version at the alias "
                         f"main-path shape: {alias_block['mismatch']} tokens")
    scale = phase_scale()
    large = phase_large_fit(scale["perplexity"])
    t = scale["kernel"]
    errs = [kern["max_abs_err"], block_timing["max_abs_err"], t["max_abs_err"]]
    if block_timing["mismatch"]:
        raise SystemExit("kernel disagrees with its plain version at the main-path shape")
    a = large["kernel"]
    emit({"kernels": [{
        "name": "lda_gibbs.resample",
        "route": "cuda",
        "source": "src/repro_torch/kernels/lda_gibbs/csrc/lda_gibbs.cu",
        "replaces": "src/repro/kernels/lda_gibbs/kernel.py:233",
        "launches": main_out["launches"]["lda_gibbs.resample"],
        "max_abs_err": max(errs),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "shape": f"N={t['n']} K={t['k']} D={t['d']} V={t['v']} w_bits={t['w_bits']}",
    }, {
        "name": "alias_mh.resample",
        "route": "cuda",
        "source": "src/repro_torch/kernels/alias_mh/csrc/alias_mh.cu",
        "replaces": "src/repro/kernels/alias_mh/kernel.py:206",
        "launches": large["launches"]["alias_mh.resample"],
        "max_abs_err": max(alias_kern["max_abs_err"], alias_block["max_abs_err"],
                           a["max_abs_err"]),
        "ms": a["ms"],
        "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"],
        "library_ms": None,
        "shape": f"N={a['n']} K={a['k']} D={a['d']} V={a['v']} w_bits={a['w_bits']} "
                 f"S={a['mh_steps']}",
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
