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
  5. zoo         the batched slice's main path: 64 products at the case
                 study's widths (300 or 600 reviews, base vocab 800, K = 12)
                 through `TopicEngine.fit_many` — one `fit_batch` request,
                 `auto` -> `batched`, two buckets (32 x 32,768 and 32 x 65,536
                 token slots) — 30 sweeps, a `refine_batch` of all 64 handles
                 (20 sweeps) and a view sync of each: one batched lda_gibbs
                 launch per bucket and sweep (100), none single-model; the
                 count invariants of every model; four products fit one at a
                 time on `cuda` from the same seeds within 5% perplexity; one
                 batched sweep against 64 single-model launches on the same
                 noise; zoo sweep time, tokens/s and models/s against 64
                 sequential sweeps, stages, and the kernel at the larger
                 bucket against its bound and plain version
  6. zoo_alias   the same 64 products through `fit_batch(backend="alias")`,
                 50 sweeps: 100 batched alias_mh launches, invariants, four
                 sequential `alias` fits within 5%, the kernel at the larger
                 bucket against its plain version, bound and time
Phase 1 also holds both batched kernels against their plain versions over
M in {1, 5, 64} ragged models x K in {12, 128, 1000} x f32/`w_bits` 8 (x S
in {2, 4} for alias_mh).

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


def compare(args, *, alpha, beta, beta_bar, w_bits, many=False):
    """Kernel vs plain on identical inputs — one model, or with `many` a
    stack of M models through the batched kernel: (mismatches outside
    near-ties, near-tie mismatches, tokens with a near-tie top-2, max score
    gap)."""
    import torch

    from repro_torch.kernels.lda_gibbs import ops

    hp = dict(alpha=alpha, beta=beta, beta_bar=beta_bar, w_bits=w_bits)
    kernel, plain = ((ops.resample_many, ops.resample_many_plain) if many
                     else (ops.resample, ops.resample_plain))
    z_k = kernel(*args, **hp).flatten()
    torch.cuda.synchronize()
    z_p = plain(*args, **hp).flatten()
    scores = ops.perturbed_scores(*args, **hp)
    scores = scores.reshape(-1, scores.shape[-1])
    live = args[3].flatten() > 0
    top2 = torch.topk(scores, min(2, scores.shape[1]), dim=1).values
    near = live & (top2[:, 0] - top2[:, -1] < NEAR_TIE)
    best = scores.gather(1, z_p.long()[:, None])[:, 0]
    got = scores.gather(1, z_k.long()[:, None])[:, 0]
    gap = torch.where(live, best - got, 0.0)
    differ = z_k != z_p
    bad = differ & (gap >= NEAR_TIE)
    frozen_bad = (~live) & (z_k != args[2].flatten())
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


def compare_alias(args, *, alpha, beta, beta_bar, w_bits, many=False):
    """alias_mh kernel vs plain on identical inputs — one model, or with
    `many` a stack of M models through the batched kernel: (mismatches
    outside near-ties plus frozen tokens that moved, near-tie mismatches,
    tokens with a near-tie in some round, the largest smallest-margin among
    mismatched tokens — 0 when the two agree everywhere, tokens the kernel
    moved)."""
    import torch

    from repro_torch.kernels.alias_mh import ops

    hp = dict(alpha=alpha, beta=beta, beta_bar=beta_bar, w_bits=w_bits)
    kernel, plain = ((ops.mh_resample_many, ops.mh_resample_many_plain) if many
                     else (ops.mh_resample, ops.mh_resample_plain))
    z_k = kernel(*args, **hp)
    torch.cuda.synchronize()
    z_p = plain(*args, **hp)
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


def _stack_random_inputs(m, n, k, w_bits, d, v, seed, mh_steps=None):
    """A ragged stack of m models on the card (each model's tokens past its
    own length, between n/2 and n, are weight-0 padding; 10% of its real
    tokens weigh 0 too), with the stored count tables of plausible
    magnitude, then the (m, n, k) Gumbel noise or, with `mh_steps`, the
    stale alias tables and one sweep's (m, S, n) draws."""
    import torch

    from repro_torch.core import alias, codec
    from repro_torch.core.types import LDAConfig
    from repro_torch.kernels.lda_gibbs import ops

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    cfg = LDAConfig(num_topics=k, vocab_size=v, num_docs=d, w_bits=w_bits)
    sc = codec.codec_for(cfg)
    lengths = torch.randint(n // 2, n + 1, (m,), generator=gen, device=dev)
    lengths[0] = n
    lengths[-1] = n - 37 if m > 1 else n
    docs = torch.randint(0, d, (m, n), generator=gen, device=dev, dtype=torch.int32)
    words = torch.randint(0, v, (m, n), generator=gen, device=dev, dtype=torch.int32)
    z = torch.randint(0, k, (m, n), generator=gen, device=dev, dtype=torch.int32)
    weights = torch.rand((m, n), generator=gen, device=dev)
    weights = torch.where(torch.rand((m, n), generator=gen, device=dev) < 0.1, 0.0, weights)
    weights = torch.where(torch.arange(n, device=dev)[None, :] < lengths[:, None], weights, 0.0)
    n_dt = sc.decode_array(sc.encode_array(torch.rand((m, d, k), generator=gen, device=dev) * 6))
    n_wt = sc.decode_array(sc.encode_array(torch.rand((m, v, k), generator=gen, device=dev) * 3))
    counts = tuple(sc.encode_array(x) for x in (n_dt, n_wt, n_wt.sum(1)))
    if mh_steps is None:
        return (docs, words, z, weights, *counts, ops.gumbel((m, n, k), gen, dev))
    tables = alias.sweep_tables(cfg, n_dt, n_wt)
    draws = (torch.randint(0, k, (m, mh_steps, n), generator=gen, device=dev,
                           dtype=torch.int32),
             torch.rand((m, mh_steps, n), generator=gen, device=dev),
             torch.rand((m, mh_steps, n), generator=gen, device=dev))
    return (docs, words, z, weights, *counts, *tables, *draws)


def _grid_width(m, k):
    """Token slots per model of a grid case: up to 16,384, fewer where the
    (m, n, k) noise would pass about 0.5 GB."""
    return min(16384, max(256, (2 ** 27 // (m * k)) // 256 * 256))


def phase_batched_kernels():
    """Both batched kernels against their plain versions over M x ragged N
    x K x count format (x S for alias_mh)."""
    hp = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * 4000)
    out = {}
    for name in ("lda_gibbs.resample_many", "alias_mh.resample_many"):
        cases = []
        for m in (1, 5, 64):
            for k in (12, 128, 1000):
                n = _grid_width(m, k)
                d, v = (256, 4000) if k < 1000 else (64, 500)
                for w_bits in (None, 8):
                    seed = m * 1009 + k * 7 + (w_bits or 0)
                    if name == "lda_gibbs.resample_many":
                        args = _stack_random_inputs(m, n, k, w_bits, d, v, seed)
                        bad, near_flip, near, gap = compare(args, w_bits=w_bits, many=True,
                                                            **hp)
                        cases.append({"m": m, "k": k, "n": n, "w_bits": w_bits,
                                      "mismatch": bad, "near_tie_flips": near_flip,
                                      "near_ties": near, "max_abs_err": gap})
                        continue
                    for mh_steps in (2, 4):
                        args = _stack_random_inputs(m, n, k, w_bits, d, v, seed + mh_steps,
                                                    mh_steps=mh_steps)
                        bad, near_flip, near, gap, moved = compare_alias(
                            args, w_bits=w_bits, many=True, **hp)
                        cases.append({"m": m, "k": k, "n": n, "w_bits": w_bits,
                                      "mh_steps": mh_steps, "mismatch": bad,
                                      "near_tie_flips": near_flip, "near_ties": near,
                                      "max_abs_err": gap, "moved": moved})
        res = {
            "phase": "kernels",
            "kernels": [name],
            "mismatches": sum(c["mismatch"] for c in cases),
            "near_tie_flips": sum(c["near_tie_flips"] for c in cases),
            "near_ties": sum(c["near_ties"] for c in cases),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "cases": cases,
        }
        emit(res)
        if res["mismatches"]:
            raise SystemExit(f"{name} disagrees with its plain version: "
                             f"{res['mismatches']} tokens")
        if any(c.get("moved", 1) == 0 for c in cases):
            raise SystemExit(f"{name} moved no token in some case")
        out[name] = res
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


def profile_device(step, reps=5, top=8):
    """Device time over `reps` calls of `step` (`torch.profiler`): the top
    ops and kernels by device time a call, and the device's busy ms a call
    (the kernels' and copies' own time summed; 0 when the profiler saw no
    device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    rows, busy_us = [], 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
            if str(ev.device_type).endswith("CUDA"):
                busy_us += dev_us
    rows.sort(reverse=True)
    return ([{"name": k[:80], "ms_per_sweep": us / 1e3 / reps, "calls": c}
             for us, k, c in rows[:top]], busy_us / 1e3 / reps)


def profile_sweeps(sampler, cfg, corpus, state, sweeps=5):
    """`profile_device` over single-model sweeps of `sampler`."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(13)
    box = [state]

    def step():
        box[0] = sampler.sweep(cfg, box[0], corpus, gen)

    return profile_device(step, sweeps)


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
    }
    out["profile_top_device_ms"], out["device_busy_ms_per_sweep"] = profile_sweeps(
        sampler, cfg, corpus, state)
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
    }
    out["profile_top_device_ms"], out["device_busy_ms_per_sweep"] = profile_sweeps(
        sampler, cfg, corpus, state)
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


# -- phases 5 and 6: the product zoo -------------------------------------------

ZOO_PRODUCTS = 64
ZOO_FIT_SWEEPS, ZOO_REFINE_SWEEPS, ZOO_ALIAS_SWEEPS = 30, 20, 50
ZOO_REFINE_SEED, ZOO_ALIAS_SEED = 500, 2000
ZOO_FIT = dict(num_topics=12, base_vocab=800, w_bits=8)
ZOO_SEQUENTIAL = (0, 2, 1, 3)  # the first two products of each bucket


def zoo_review_sets():
    """64 products at the case study's widths: 300 or 600 reviews each
    (about 18k or 36k tokens), base vocab 800, seeds 1000 + i."""
    from repro_torch.data import reviews

    return [reviews.generate(reviews.SyntheticSpec(
        num_reviews=300 if i % 2 == 0 else 600, vocab_size=800, num_topics=8,
        mean_tokens=60, seed=1000 + i)).reviews for i in range(ZOO_PRODUCTS)]


def zoo_buckets(service, handle_ids):
    """The served models restacked as the batch engine stacks them: per
    bucket its shared config, stacked corpora and states, handles and real
    token counts."""
    from repro_torch.core import batch
    from repro_torch.serving import batch_engine

    handles = [service.handles[h] for h in handle_ids]
    out = []
    for idxs in batch_engine.plan_buckets([(h.cfg, h.model.corpus) for h in handles]):
        hs = [handles[i] for i in idxs]
        lengths = [h.model.corpus.num_tokens for h in hs]
        n_pad = batch_engine.length_bucket(max(lengths))
        cfg = batch.batch_cfg([h.cfg for h in hs],
                              batch_engine.doc_bucket(max(h.cfg.num_docs for h in hs)))
        out.append(dict(cfg=cfg, corpora=batch.stack_corpora([h.model.corpus for h in hs], n_pad),
                        states=batch.stack_states(cfg, [h.state for h in hs], n_pad),
                        handles=hs, lengths=lengths))
    return out


def _bucket_shape(b):
    m, n = b["corpora"].docs.shape
    return (f"M={m} N={n} K={b['cfg'].num_topics} D={b['cfg'].num_docs} "
            f"V={b['cfg'].vocab_size} w_bits={b['cfg'].w_bits}")


def batched_kernel_timing(b, reps=50):
    """The batched Gibbs kernel at one bucket's shape, on one sweep's noise:
    agreement with its plain version, ms by raw launches (validated inputs,
    one output), through its wrapper, of the plain version, and the bound
    from these inputs: every live token's ids/z/weight, noise and output,
    every padding slot's z/weight/output, and the tables once."""
    import torch

    from repro_torch.core import codec
    from repro_torch.kernels.lda_gibbs import kernel, ops

    cfg, corpora, states = b["cfg"], b["corpora"], b["states"]
    m, n = corpora.docs.shape
    k = cfg.num_topics
    noise = ops.gumbel((m, n, k), torch.Generator(device="cuda").manual_seed(123), "cuda")
    args = (corpora.docs, corpora.words, states.z, corpora.weights,
            states.n_dt, states.n_wt, states.n_t, noise)
    w_bits = codec.codec_for(cfg).spec.w_bits
    hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar, w_bits=w_bits)
    bad, near_flip, near, gap = compare(args, many=True, **hp)
    z_out = torch.empty_like(states.z)
    scale = 1.0 if w_bits is None else 2.0 ** -(w_bits + 1)
    ms = cuda_ms(lambda: kernel.launch_many(*args, z_out, alpha=cfg.alpha, beta=cfg.beta,
                                            beta_bar=cfg.beta_bar, scale=scale), reps * 4)
    wrapper_ms = cuda_ms(lambda: ops.resample_many(*args, **hp), reps)
    plain_ms = cuda_ms(lambda: ops.resample_many_plain(*args, **hp), max(3, reps // 10))
    live = int((corpora.weights > 0).sum())
    table_bytes = sum(t.numel() * t.element_size() for t in (states.n_dt, states.n_wt, states.n_t))
    moved = live * (4 * 4 + 4 * k + 4) + (m * n - live) * 12 + table_bytes
    ops_count = live * k * 12
    return {
        "shape": _bucket_shape(b), "live_tokens": live, "mismatch": bad,
        "near_tie_flips": near_flip, "near_ties": near, "max_abs_err": gap,
        "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "bytes": moved,
        "bound_ms": max(moved / HBM_BYTES_PER_S, ops_count / F32_OPS_PER_S) * 1e3,
        "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops_count / F32_OPS_PER_S
        else "operations",
    }


def batched_alias_kernel_timing(b, mh_steps, reps=50):
    """The batched alias_mh kernel at one bucket's shape, with one sweep's
    tables and draws: agreement, ms (raw launches, wrapper, plain) and the
    bound from these inputs (live tokens' ids/z/weight, draws and output,
    padding slots' z/weight/output, every count and alias table once)."""
    import torch

    from repro_torch.core import alias, codec
    from repro_torch.kernels.alias_mh import kernel, ops

    cfg, corpora, states = b["cfg"], b["corpora"], b["states"]
    m, n = corpora.docs.shape
    k = cfg.num_topics
    sc = codec.codec_for(cfg)
    tables = alias.sweep_tables(cfg, sc.decode_array(states.n_dt), sc.decode_array(states.n_wt))
    gens = [torch.Generator(device="cuda").manual_seed(123 + i) for i in range(m)]
    draws = (torch.zeros((m, mh_steps, n), dtype=torch.int32, device="cuda"),
             torch.zeros((m, mh_steps, n), device="cuda"),
             torch.ones((m, mh_steps, n), device="cuda"))
    for i, (gen, n_i) in enumerate(zip(gens, b["lengths"])):
        for buf, draw in zip(draws, alias.sweep_draws(gen, n_i, k, mh_steps, "cuda")):
            buf[i, :, :n_i] = draw
    args = (corpora.docs, corpora.words, states.z, corpora.weights,
            states.n_dt, states.n_wt, states.n_t, *tables, *draws)
    hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar, w_bits=sc.spec.w_bits)
    bad, near_flip, near, gap, moved_tokens = compare_alias(args, many=True, **hp)
    z_out = torch.empty_like(states.z)
    scale = 1.0 if hp["w_bits"] is None else 2.0 ** -(hp["w_bits"] + 1)
    ms = cuda_ms(lambda: kernel.launch_many(*args, z_out, alpha=cfg.alpha, beta=cfg.beta,
                                            beta_bar=cfg.beta_bar, scale=scale), reps * 4)
    wrapper_ms = cuda_ms(lambda: ops.mh_resample_many(*args, **hp), reps)
    plain_ms = cuda_ms(lambda: ops.mh_resample_many_plain(*args, **hp), max(3, reps // 10))
    live = int((corpora.weights > 0).sum())
    table_bytes = sum(t.numel() * t.element_size()
                      for t in (states.n_dt, states.n_wt, states.n_t, *tables))
    moved = live * (4 * 4 + 12 * mh_steps + 4) + (m * n - live) * 12 + table_bytes
    ops_count = live * mh_steps * (9 * 4 + 20)
    return {
        "shape": _bucket_shape(b) + f" S={mh_steps}", "live_tokens": live, "mismatch": bad,
        "near_tie_flips": near_flip, "near_ties": near, "max_abs_err": gap,
        "moved": moved_tokens, "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
        "bytes": moved,
        "bound_ms": max(moved / HBM_BYTES_PER_S, ops_count / F32_OPS_PER_S) * 1e3,
        "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops_count / F32_OPS_PER_S
        else "operations",
    }


def _zoo_seed_check(sets, batched_ppx, seeds, backend, sweeps, refine_seed=None):
    """Fit `ZOO_SEQUENTIAL`'s products one at a time on `backend` from the
    seeds their batched chains had (and refine as the zoo did): the
    relative perplexity gap to each batched model."""
    from repro_torch.api import VedaliaClient

    client = VedaliaClient(device="cuda", backend=backend)
    gaps = {}
    for i in ZOO_SEQUENTIAL:
        fit = client.fit(sets[i], num_sweeps=sweeps[0], seed=seeds[i], **ZOO_FIT)
        if refine_seed is not None:
            fit = client.refine(fit.handle_id, num_sweeps=sweeps[1], seed=refine_seed + i)
        gaps[str(i)] = {"sequential": fit.perplexity, "batched": batched_ppx[i],
                        "rel_gap": abs(fit.perplexity - batched_ppx[i]) / batched_ppx[i]}
    return gaps


def _median_ms(fn, reps):
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times), min(times), max(times)


def phase_zoo(sets):
    """The slice's main path: 64 products through `TopicEngine.fit_many`
    (one `fit_batch` request, `auto` -> `batched`), a `refine_batch` of all
    64 handles and a view sync of each, over the wire on the card."""
    import torch

    from repro_torch.api import VedaliaClient
    from repro_torch.api.backends import get_backend
    from repro_torch.api.service import FitRequest
    from repro_torch.core import batch, codec
    from repro_torch.kernels.alias_mh import ops as alias_ops
    from repro_torch.kernels.lda_gibbs import ops
    from repro_torch.serving import TopicEngine

    client = VedaliaClient(device="cuda", backend="auto")
    engine = TopicEngine(client=client, max_batch=ZOO_PRODUCTS, backend="auto")
    service = client.server.service
    op0 = service._op
    counters = (ops.resample, ops.resample_many, alias_ops.mh_resample,
                alias_ops.mh_resample_many)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = engine.fit_many([FitRequest(uid=i, reviews=rs, num_sweeps=ZOO_FIT_SWEEPS,
                                          **ZOO_FIT) for i, rs in enumerate(sets)])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    ids = [r.handle_id for r in results]
    t0 = time.perf_counter()
    refined = client.refine_batch(ids, ZOO_REFINE_SWEEPS, seed=ZOO_REFINE_SEED)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    syncs = [client.sync_view(h, top_n=8) for h in ids]
    launches = {"lda_gibbs.resample": ops.resample.launches,
                "lda_gibbs.resample_many": ops.resample_many.launches,
                "alias_mh.resample": alias_ops.mh_resample.launches,
                "alias_mh.resample_many": alias_ops.mh_resample_many.launches}
    peak = torch.cuda.max_memory_allocated()
    want = {"lda_gibbs.resample": 0,
            "lda_gibbs.resample_many": 2 * (ZOO_FIT_SWEEPS + ZOO_REFINE_SWEEPS),
            "alias_mh.resample": 0, "alias_mh.resample_many": 0}
    for h in ids:
        _check_invariants(service, h)
    backends = sorted({r.fit.backend for r in results} | {r.backend for r in refined})
    ppx = [r.perplexity for r in refined]
    seeds = [service._seed * 1_000_003 + op0 + 1 + i for i in range(ZOO_PRODUCTS)]
    gaps = _zoo_seed_check(sets, ppx, seeds, "cuda", (ZOO_FIT_SWEEPS, ZOO_REFINE_SWEEPS),
                           ZOO_REFINE_SEED)

    buckets = zoo_buckets(service, ids)
    # One batched sweep from the fitted stack against the single-model
    # kernel on each model's rows of the same noise.
    stack_vs_single = {"mismatch": 0, "near_tie_flips": 0}
    for b in buckets:
        cfg, corpora, states = b["cfg"], b["corpora"], b["states"]
        m, n = corpora.docs.shape
        noise = ops.gumbel((m, n, cfg.num_topics),
                           torch.Generator(device="cuda").manual_seed(77), "cuda")
        z_many = ops.sweep_many(cfg, states, corpora, noise).z
        for i, (h, n_i) in enumerate(zip(b["handles"], b["lengths"])):
            g = noise[i, :n_i].contiguous()
            z_one = ops.sweep_resample(h.cfg, h.state, h.model.corpus, None, noise=g)
            differ = z_one != z_many[i, :n_i]
            if bool(differ.any()):
                real = codec.decode_state(h.cfg, h.state)
                c = h.model.corpus
                sc = ops.perturbed_scores(c.docs, c.words, h.state.z, c.weights, real.n_dt,
                                          real.n_wt, real.n_t, g, alpha=h.cfg.alpha,
                                          beta=h.cfg.beta, beta_bar=h.cfg.beta_bar)
                top2 = sc.topk(2, dim=1).values
                near = (top2[:, 0] - top2[:, 1]) < NEAR_TIE
                stack_vs_single["mismatch"] += int((differ & ~near).sum())
                stack_vs_single["near_tie_flips"] += int((differ & near).sum())

    # Time: the zoo sweep (both buckets, as `run_many` sweeps them), the same
    # 64 products as 64 single-model `cuda` sweeps, stages, the kernel.
    real_tokens = sum(sum(b["lengths"]) for b in buckets)
    runs = []
    for b in buckets:
        m, n = b["corpora"].docs.shape
        runs.append(dict(b, gens=[torch.Generator(device="cuda").manual_seed(41 + i)
                                  for i in range(m)],
                         noise=torch.zeros((m, n, b["cfg"].num_topics), device="cuda")))

    def zoo_sweep():
        for r in runs:
            r["states"] = ops.sweep_many(r["cfg"], r["states"], r["corpora"],
                                         batch.draw_noise(r["noise"], r["gens"], r["lengths"]))

    zoo_sweep()
    med, lo, hi = _median_ms(zoo_sweep, 20)
    top, busy = profile_device(zoo_sweep)
    cuda = get_backend("cuda")
    singles = [(h, torch.Generator(device="cuda").manual_seed(h.handle_id))
               for b in buckets for h in b["handles"]]

    def sequential_sweeps():
        for h, gen in singles:
            cuda.sweep(h.cfg, h.state, h.model.corpus, gen)

    sequential_sweeps()
    seq_med, seq_lo, seq_hi = _median_ms(sequential_sweeps, 5)
    breakdown = []
    for r in runs:
        z_new = ops.resample_many(r["corpora"].docs, r["corpora"].words, r["states"].z,
                                  r["corpora"].weights, r["states"].n_dt, r["states"].n_wt,
                                  r["states"].n_t, r["noise"], alpha=r["cfg"].alpha,
                                  beta=r["cfg"].beta, beta_bar=r["cfg"].beta_bar,
                                  w_bits=r["cfg"].w_bits)

        def kernel_call(r=r):
            return ops.resample_many(r["corpora"].docs, r["corpora"].words, r["states"].z,
                                     r["corpora"].weights, r["states"].n_dt,
                                     r["states"].n_wt, r["states"].n_t, r["noise"],
                                     alpha=r["cfg"].alpha, beta=r["cfg"].beta,
                                     beta_bar=r["cfg"].beta_bar, w_bits=r["cfg"].w_bits)

        breakdown.append({
            "shape": _bucket_shape(r),
            "draws": cuda_ms(lambda r=r: batch.draw_noise(r["noise"], r["gens"], r["lengths"]),
                             20),
            "kernel": cuda_ms(kernel_call, 20),
            "rebuild": cuda_ms(lambda r=r, z=z_new: codec.rebuild_state(r["cfg"], r["corpora"], z),
                               20),
        })
    larger = max(buckets, key=lambda b: b["corpora"].docs.shape[1])
    timing = batched_kernel_timing(larger)
    out = {
        "phase": "zoo", "products": ZOO_PRODUCTS, "real_tokens": real_tokens,
        "buckets": [_bucket_shape(b) for b in buckets], "backends": backends,
        "launches": launches, "expected_launches": want,
        "fit_many_30_s": round(fit_s, 4), "refine_batch_20_s": round(refine_s, 4),
        "views_valid": all(s.valid for s in syncs),
        "perplexity_min": min(ppx), "perplexity_max": max(ppx),
        "sequential_cuda_check": gaps,
        "max_rel_gap": max(g["rel_gap"] for g in gaps.values()),
        "stack_vs_single": stack_vs_single,
        "zoo_sweep_ms_median": med, "zoo_sweep_ms_min": lo, "zoo_sweep_ms_max": hi,
        "real_tokens_per_s": real_tokens / (med / 1e3),
        "models_per_s": ZOO_PRODUCTS / (med / 1e3),
        "sequential_64_sweeps_ms_median": seq_med, "sequential_64_sweeps_ms_min": seq_lo,
        "sequential_64_sweeps_ms_max": seq_hi, "amortization": seq_med / med,
        "sweep_breakdown_ms": breakdown, "profile_top_device_ms": top,
        "device_busy_ms_per_sweep": busy, "device_idle_share": 1.0 - busy / med,
        "peak_mem_bytes": peak, "kernel": timing,
    }
    emit(out)
    if launches != want:
        raise SystemExit(f"the zoo launched {launches}, expected {want}")
    if backends != ["batched"]:
        raise SystemExit(f"the zoo resolved to {backends}, expected ['batched']")
    if not out["views_valid"] or not all(math.isfinite(p) for p in ppx):
        raise SystemExit("zoo views invalid or perplexity not finite")
    if out["max_rel_gap"] > PPX_BAND:
        raise SystemExit(f"batched vs sequential cuda perplexity gap {out['max_rel_gap']:.2%}")
    if stack_vs_single["mismatch"] or timing["mismatch"]:
        raise SystemExit(f"batched kernel disagrees: {stack_vs_single}, "
                         f"plain at the larger bucket {timing['mismatch']}")
    return out


def phase_zoo_alias(sets):
    """The same 64 products through `fit_batch(backend="alias")`: one
    batched MH launch per bucket and sweep."""
    import torch

    from repro_torch.api import VedaliaClient
    from repro_torch.core import alias
    from repro_torch.kernels.alias_mh import ops as alias_ops
    from repro_torch.kernels.lda_gibbs import ops

    client = VedaliaClient(device="cuda", backend="auto")
    service = client.server.service
    counters = (ops.resample, ops.resample_many, alias_ops.mh_resample,
                alias_ops.mh_resample_many)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    fits = client.fit_batch(sets, backend="alias", num_sweeps=ZOO_ALIAS_SWEEPS,
                            seed=ZOO_ALIAS_SEED, **ZOO_FIT)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"lda_gibbs.resample": ops.resample.launches,
                "lda_gibbs.resample_many": ops.resample_many.launches,
                "alias_mh.resample": alias_ops.mh_resample.launches,
                "alias_mh.resample_many": alias_ops.mh_resample_many.launches}
    want = {"lda_gibbs.resample": 0, "lda_gibbs.resample_many": 0, "alias_mh.resample": 0,
            "alias_mh.resample_many": 2 * ZOO_ALIAS_SWEEPS}
    ids = [f.handle_id for f in fits]
    for h in ids:
        _check_invariants(service, h)
    ppx = [f.perplexity for f in fits]
    seeds = [ZOO_ALIAS_SEED + i for i in range(ZOO_PRODUCTS)]
    gaps = _zoo_seed_check(sets, ppx, seeds, "alias", (ZOO_ALIAS_SWEEPS,))
    mh_steps = service.sampler("alias").mh_steps
    buckets = zoo_buckets(service, ids)
    runs = [dict(b, gens=[torch.Generator(device="cuda").manual_seed(51 + i)
                          for i in range(len(b["handles"]))]) for b in buckets]

    def zoo_sweep():
        for r in runs:
            r["states"] = alias.run_many(r["cfg"], r["states"], r["corpora"], r["gens"], 1,
                                         mh_steps, r["lengths"])

    zoo_sweep()
    med, lo, hi = _median_ms(zoo_sweep, 20)
    top, busy = profile_device(zoo_sweep)
    larger = max(buckets, key=lambda b: b["corpora"].docs.shape[1])
    timing = batched_alias_kernel_timing(larger, mh_steps)
    real_tokens = sum(sum(b["lengths"]) for b in buckets)
    out = {
        "phase": "zoo_alias", "products": ZOO_PRODUCTS, "mh_steps": mh_steps,
        "backends": sorted({f.backend for f in fits}), "launches": launches,
        "expected_launches": want, "fit_batch_50_s": round(fit_s, 4),
        "perplexity_min": min(ppx), "perplexity_max": max(ppx),
        "sequential_alias_check": gaps,
        "max_rel_gap": max(g["rel_gap"] for g in gaps.values()),
        "zoo_sweep_ms_median": med, "zoo_sweep_ms_min": lo, "zoo_sweep_ms_max": hi,
        "real_tokens_per_s": real_tokens / (med / 1e3),
        "models_per_s": ZOO_PRODUCTS / (med / 1e3), "profile_top_device_ms": top,
        "device_busy_ms_per_sweep": busy, "device_idle_share": 1.0 - busy / med,
        "kernel": timing,
    }
    emit(out)
    if launches != want or out["backends"] != ["alias"]:
        raise SystemExit(f"the alias zoo launched {launches} on {out['backends']}, "
                         f"expected {want} on ['alias']")
    if not all(math.isfinite(p) for p in ppx) or out["max_rel_gap"] > PPX_BAND:
        raise SystemExit(f"batched vs sequential alias perplexity gap {out['max_rel_gap']:.2%}")
    if timing["mismatch"]:
        raise SystemExit(f"batched alias_mh kernel disagrees with its plain version at the "
                         f"larger bucket: {timing['mismatch']} tokens")
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
    batched_kern = phase_batched_kernels()
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
    t0 = time.perf_counter()
    sets = zoo_review_sets()
    emit({"phase": "zoo_data", "products": len(sets),
          "reviews": sum(len(rs) for rs in sets), "generate_s": round(time.perf_counter() - t0, 3)})
    zoo = phase_zoo(sets)
    zoo_alias = phase_zoo_alias(sets)
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
    }] + [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": phase["launches"][name],
        "max_abs_err": max(batched_kern[name]["max_abs_err"], phase["kernel"]["max_abs_err"]),
        "ms": phase["kernel"]["ms"],
        "plain_ms": phase["kernel"]["plain_ms"],
        "bound_ms": phase["kernel"]["bound_ms"],
        "bound_by": phase["kernel"]["bound_by"],
        "library_ms": None,
        "shape": phase["kernel"]["shape"],
    } for name, source, replaces, phase in (
        ("lda_gibbs.resample_many", "src/repro_torch/kernels/lda_gibbs/csrc/lda_gibbs.cu",
         "src/repro/kernels/lda_gibbs/kernel.py:276", zoo),
        ("alias_mh.resample_many", "src/repro_torch/kernels/alias_mh/csrc/alias_mh.cu",
         "src/repro/kernels/alias_mh/kernel.py:269", zoo_alias))]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
