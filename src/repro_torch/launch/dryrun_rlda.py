"""The paper's own workload at production scale: a distributed RLDA sweep.

The reference's `repro.launch.dryrun_rlda` lowers one Gibbs sweep of a
SNAP-scale slice onto TPU pods (250k augmented vocab: 50k base x 5 tiers,
200k reviews in flight, K = 256 topics, 16M tokens a sweep step) and reads
XLA's analyses. One H100 holds that state whole (about 1 GB), so here the
sweep is not a dry run: it runs.

`run_one` makes a seeded corpus of the production shape on the device,
initializes the state, runs one timed sweep after one warm-up (median of
three), checks the count invariants and writes a record to
experiments/dryrun_torch/rlda-amazon__sweep_16m__<mesh>.json:

  token-parallel  `core.gibbs.sweep` in blocks of `block` tokens: each block
                  one launch of the Gibbs kernel (`kernels/lda_gibbs`, its
                  K > 32 body) with injected Gumbel noise, against the
                  sweep-stale counts decoded to real units
  client-server   `core.distributed.make_client_server_sweep` with W
                  stacked workers (16, or 32 with `multi_pod`: the pod
                  mesh's data axes), one server sync every `sync_every`
                  sweeps; its sync moves the replicated (V, K) float32 table
                  through the `pserver.comm` seam's `psum`

The corpus is synthetic (no SNAP data is in the repository), each piece
drawn on the device from `seed`:

  docs     200,000 reviews laid out contiguously, as `core.rlda.prepare`
           lays them: each token's review drawn uniformly, then sorted, so
           a review's length is Binomial(N, 1/D), about 83.9 tokens
  words    base words from a Zipf law of exponent `ZIPF_EXPONENT` over
           50,000 ids (inverse CDF), put in the review's rating tier
           (`core.rlda.augment_word`: base * 5 + tier), the tier uniform
           over the 5 a review
  weights  psi * c, one a review, uniform in (0, 1]

The record holds the sweep's ms, the kernel launches a sweep, the peak
memory (`max_memory_allocated` on the card), the sweep's byte bound and
roofline terms (the card's constants, `launch.mesh`), the per-device
static bytes of state and corpus under the reference's specs on the named
pod mesh (tokens over the data axes; `n_dt` rows over 'model' with
`shard_docs`, `n_wt` rows with `shard_vocab`), the largest counts beside
the int32 fixed-point limit, and, client-server, the sync's bytes.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_rlda [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun_rlda --client-server --sync-every 2
  PYTHONPATH=src python -m repro_torch.launch.dryrun_rlda --device cpu --tokens 4096
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import sys
import time
from typing import Optional

import torch

from repro_torch.core import codec, distributed, fractional, gibbs
from repro_torch.core.rlda import NUM_TIERS
from repro_torch.core.types import Corpus, LDAConfig, LDAState, build_counts, init_state
from repro_torch.device import resolve_device
from repro_torch.kernels.lda_gibbs import ops as lda_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.pserver import comm as comm_lib
from repro_torch.pserver.sync import replicated_sync_bytes_per_device
from repro_torch.sharding.specs import batch_spec, shard_shape

BASE_VOCAB = 50_000
ZIPF_EXPONENT = 1.0
OUTDIR = "experiments/dryrun_torch"
INT32_MAX = (1 << 31) - 1
# Float32 operations a token and topic of the score: the two count sums, a
# product, a quotient, its log and the noise added (the log counted as 4).
SCORE_OPS = 9


def production_lda_config(w_bits=8) -> LDAConfig:
    return LDAConfig(
        num_topics=256,
        vocab_size=BASE_VOCAB * NUM_TIERS,  # rating-augmented base vocab (paper §4.3)
        num_docs=200_000,
        w_bits=w_bits,
    )


def abstract_corpus(_cfg: LDAConfig, num_tokens: int) -> Corpus:
    """The corpus as `meta` tensors (the reference's shapes and dtypes)."""
    def meta(dtype):
        return torch.empty((num_tokens,), dtype=dtype, device="meta")

    return Corpus(docs=meta(torch.int32), words=meta(torch.int32), weights=meta(torch.float32))


def abstract_state(cfg: LDAConfig, num_tokens: int) -> LDAState:
    """The state as `meta` tensors: int32 counts when the config stores
    fixed point (`quant_spec.live_fixed`), else float32."""
    cdt = torch.int32 if cfg.quant_spec.live_fixed else torch.float32

    def meta(shape, dtype=cdt):
        return torch.empty(shape, dtype=dtype, device="meta")

    return LDAState(z=meta((num_tokens,), torch.int32),
                    n_dt=meta((cfg.num_docs, cfg.num_topics)),
                    n_wt=meta((cfg.vocab_size, cfg.num_topics)),
                    n_t=meta((cfg.num_topics,)))


def synthetic_corpus(cfg: LDAConfig, num_tokens: int, gen: torch.Generator) -> Corpus:
    """A seeded corpus of the production layout, drawn on `gen`'s device
    (see the module docstring)."""
    dev = gen.device
    base_vocab = cfg.vocab_size // NUM_TIERS
    docs = torch.randint(0, cfg.num_docs, (num_tokens,), generator=gen, device=dev,
                         dtype=torch.int32).sort().values
    ranks = torch.arange(1, base_vocab + 1, device=dev, dtype=torch.float64)
    cdf = torch.cumsum(ranks ** -ZIPF_EXPONENT, 0)
    u = torch.rand(num_tokens, generator=gen, device=dev, dtype=torch.float64) * cdf[-1]
    base = torch.searchsorted(cdf, u).clamp_max_(base_vocab - 1)
    tier = torch.randint(0, NUM_TIERS, (cfg.num_docs,), generator=gen, device=dev)
    words = (base * NUM_TIERS + tier[docs.long()]).to(torch.int32)
    per_review = 1.0 - torch.rand(cfg.num_docs, generator=gen, device=dev)  # (0, 1]
    return Corpus(docs=docs, words=words, weights=per_review[docs.long()].contiguous())


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def static_per_device(cfg: LDAConfig, num_tokens: int, mesh, *, shard_docs: bool,
                      shard_vocab: bool) -> dict:
    """Per-device bytes of the corpus and state under the reference's specs
    on `mesh`: tokens over the data axes, `n_dt` rows over 'model' when
    `shard_docs`, `n_wt` rows when `shard_vocab`, `n_t` replicated."""
    tok = (batch_spec(mesh),)
    specs = {"docs": tok, "words": tok, "weights": tok, "z": tok,
             "n_dt": ("model", None) if shard_docs else (None, None),
             "n_wt": ("model", None) if shard_vocab else (None, None), "n_t": (None,)}
    corpus, state = abstract_corpus(cfg, num_tokens), abstract_state(cfg, num_tokens)
    tensors = {**vars(corpus), **vars(state)}
    out = {f"{k}_bytes": math.prod(shard_shape(t.shape, specs[k], mesh)) * t.element_size()
           for k, t in tensors.items()}
    out["total_bytes"] = sum(out.values())
    return out


def sweep_bound(cfg: LDAConfig, corpus: Corpus, state: LDAState, *,
                noise_bytes: int = 0) -> dict:
    """The least time of one sweep on the card: the bytes it must move (the
    corpus and the stored state read once, the new state written once) over
    the HBM rate, and its float32 operations (`SCORE_OPS` a token and
    topic) over the float32 rate; `noise_bytes` adds traffic a route
    materializes (the token-parallel route's Gumbel noise: written, then
    read)."""
    state_bytes = sum(_bytes(t) for t in dataclasses.astuple(state))
    moved = sum(_bytes(t) for t in dataclasses.astuple(corpus)) + 2 * state_bytes + noise_bytes
    ops_count = corpus.num_tokens * cfg.num_topics * SCORE_OPS
    memory_s, compute_s = moved / mesh_lib.HBM_BW, ops_count / mesh_lib.PEAK_FLOPS_F32
    return {"bytes": moved, "ops": ops_count, "memory_s": memory_s, "compute_s": compute_s,
            "bound_ms": max(memory_s, compute_s) * 1e3,
            "bottleneck": "memory_s" if memory_s >= compute_s else "compute_s"}


def check_counts(cfg: LDAConfig, corpus: Corpus, z: torch.Tensor, n_dt, n_wt, n_t) -> dict:
    """The count invariants of a sweep's result in real units: `n_t` sums
    to the corpus's weight (in fixed point each of the K totals rounds by
    at most half a stored unit), and `n_dt`, `n_wt` equal a rebuild from z
    within a stored unit (fixed point) plus the float32 sums' own error in
    two orders (the card's scatter adds in no fixed order): 2 n 2^-24 of
    the entry, n the tokens summed into it. Returns the deviations and
    `ok`."""
    spec = cfg.quant_spec
    unit = 1.0 / fractional.scale(spec.w_bits) if spec.live_fixed else 0.0
    total = float(corpus.weights.double().sum())
    n_t_err = abs(float(n_t.double().sum()) - total)
    n_t_tol = 1e-4 * total + cfg.num_topics * unit / 2
    real = dataclasses.replace(cfg, w_bits=None, quant=None)
    rebuilt = build_counts(real, corpus, z)
    terms = build_counts(real, Corpus(corpus.docs, corpus.words,
                                      torch.ones_like(corpus.weights)), z)
    out = {"total_weight": total, "n_t_sum_err": n_t_err, "n_t_sum_tol": n_t_tol}
    ok = n_t_err <= n_t_tol
    for name in ("n_dt", "n_wt"):
        got, want, n = (locals()[name], getattr(rebuilt, name), getattr(terms, name))
        dev = (got.double() - want.double()).abs()
        excess = float((dev - unit - 2.0 * n.double() * 2.0 ** -24 * want.double().abs()).max())
        out[f"{name}_max_dev"] = float(dev.max())
        ok = ok and excess <= 0
    out["ok"] = bool(ok)
    return out


def count_headroom(cfg: LDAConfig, n_wt, n_t) -> dict:
    """The largest `n_t` and `n_wt` entries in real units and, with `w_bits`,
    in stored int32 units beside 2^31 - 1 (the fixed point's limit: one
    entry overflows past (2^31 - 1) / 2^(w_bits + 1) real counts)."""
    out = {"max_n_t": float(n_t.max()), "max_n_wt": float(n_wt.max())}
    spec = cfg.quant_spec
    if spec.live_fixed:
        scale = fractional.scale(spec.w_bits)
        out.update(fixed_scale=scale, fixed_limit_real=INT32_MAX / scale,
                   max_n_t_stored=out["max_n_t"] * scale,
                   max_n_wt_stored=out["max_n_wt"] * scale,
                   n_t_headroom=INT32_MAX / (out["max_n_t"] * scale))
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev, sweeps: int = 3) -> tuple[list, object]:
    """One warm-up call, then `sweeps` timed ones (host clock around a
    synchronize): (ms of each, the last result)."""
    out = fn()
    _sync(dev)
    times = []
    for _ in range(sweeps):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return times, out


def _launches() -> int:
    return lda_ops.resample.launches


def run_one(multi_pod: bool = False, num_tokens: int = 16_777_216, block: int = 8192,
            shard_docs: bool = True, shard_vocab: bool = False, client_server: bool = False,
            sync_every: int = 1, device=None, seed: int = 0, *,
            cfg: Optional[LDAConfig] = None, workers: Optional[int] = None,
            outdir: Optional[str] = OUTDIR, tag: str = "") -> dict:
    """Make the corpus, initialize, run three timed sweeps after one
    warm-up and check the invariants; write and return the record, with
    beside it (not written) the last state (`"result"`: an `LDAState`, or
    client-server (z, n_dt, n_wt, n_t) in the corpus's order), the corpus
    (`"corpus"`) and `"step"`, a thunk that runs one more sweep from it.
    `cfg` replaces the production config and `workers` the client-server
    mode's W (the pod mesh's data axes: 16, or 32 with `multi_pod`)."""
    dev = resolve_device(device)
    cfg = cfg or production_lda_config()
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    sizes = mesh.sizes
    n_workers = workers or math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    mode = f"client_server_x{sync_every}" if client_server else "token_parallel"
    print(f"[dryrun-rlda] K={cfg.num_topics} V={cfg.vocab_size} D={cfg.num_docs} "
          f"tokens={num_tokens} {mode} ({mesh.name}) on {where} ...", flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    corpus = synthetic_corpus(cfg, num_tokens, gen)
    state = codec.encode_state(cfg, init_state(cfg, corpus, gen))
    _sync(dev)
    setup_s = time.perf_counter() - t0
    rec = {"arch": "rlda-amazon", "shape": f"sweep_{num_tokens // 2**20}m", "mesh": mesh.name,
           "chips": mesh_lib.mesh_chips(mesh), "kind": "gibbs_sweep", "mode": mode,
           "device": where, "num_tokens": num_tokens, "block": block,
           "config": {"num_topics": cfg.num_topics, "vocab_size": cfg.vocab_size,
                      "num_docs": cfg.num_docs, "w_bits": cfg.w_bits, "alpha": cfg.alpha,
                      "beta": cfg.beta},
           "corpus": {"zipf_exponent": ZIPF_EXPONENT, "base_vocab": cfg.vocab_size // NUM_TIERS,
                      "seed": seed},
           "shard_docs": shard_docs, "shard_vocab": shard_vocab, "setup_s": setup_s,
           "collectives": None,
           "collectives_reason": "a pod's collectives cannot be measured on one card"}
    if client_server:
        out = _client_server(cfg, corpus, state, gen, n_workers, block, sync_every, dev)
    else:
        out = _token_parallel(cfg, corpus, state, gen, block, dev)
    live = {k: out.pop(k) for k in ("result", "step")}
    live["corpus"] = corpus
    rec.update(out)
    rec["static_per_device"] = (
        _client_server_static(cfg, num_tokens, n_workers) if client_server else
        static_per_device(cfg, num_tokens, mesh, shard_docs=shard_docs,
                          shard_vocab=shard_vocab))
    rec["static_card_bytes"] = sum(_bytes(t) for t in dataclasses.astuple(corpus)
                                   + dataclasses.astuple(state))
    if dev.type == "cuda":
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    rec["wall_s"] = time.perf_counter() - t0
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        name = f"{rec['arch']}__{rec['shape']}__{mesh.name}" + (f"__{tag}" if tag else "")
        with open(os.path.join(outdir, name + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    print(f"[dryrun-rlda]   sweep {rec['sweep_ms']:.3f} ms (median of 3), "
          f"{rec['launches_per_sweep']} launches a sweep, bound {rec['bound']['bound_ms']:.3f} "
          f"ms [{rec['bound']['bottleneck']}], invariants "
          f"{'ok' if rec['invariants']['ok'] else 'FAILED'}", flush=True)
    return dict(rec, **live)


def _token_parallel(cfg, corpus, state, gen, block, dev) -> dict:
    box = [state]

    def sweep():
        box[0] = gibbs.sweep(cfg, box[0], corpus, gen, block)
        return box[0]

    before = _launches()
    times, new = _timed(sweep, dev)
    launches = (_launches() - before) // (len(times) + 1)
    n_dt, n_wt, n_t = codec.decode_counts(cfg, new)
    noise_bytes = 2 * corpus.num_tokens * cfg.num_topics * 4  # written, then read
    return {"sweep_ms": statistics.median(times), "sweep_ms_all": times,
            "launches_per_sweep": launches, "bound": sweep_bound(cfg, corpus, state),
            "bound_with_noise": sweep_bound(cfg, corpus, state, noise_bytes=noise_bytes),
            "invariants": check_counts(cfg, corpus, new.z, n_dt, n_wt, n_t),
            "counts": count_headroom(cfg, n_wt, n_t), "result": new, "step": sweep}


def _client_server(cfg, corpus, state, gen, n_workers, block, sync_every, dev) -> dict:
    """W stacked workers: the corpus sharded by document (`shard_corpus`),
    float32 real-unit counts, one server sync per `sync_every` sweeps."""
    n_dt, n_wt, _ = codec.decode_counts(cfg, state)
    comm = comm_lib.make(n_workers)
    docs_l, words, z, wts, n_dt_sh, inv = distributed.shard_corpus(
        cfg, corpus, state.z, n_dt, comm.n_workers)
    step = distributed.make_client_server_sweep(cfg, comm, block=block, sync_every=sync_every)
    box = [(z, n_dt_sh, n_wt)]

    def sweep():
        z_, n_dt_, n_wt_ = box[0]
        z_, n_dt_, n_wt_, n_t_ = step(docs_l, words, z_, wts, n_dt_, n_wt_, gen)
        box[0] = (z_, n_dt_, n_wt_)
        return z_, n_dt_, n_wt_, n_t_

    before = _launches()
    times, (z_sh, n_dt_sh, n_wt_new, n_t_new) = _timed(sweep, dev)
    launches = (_launches() - before) // (len(times) + 1)
    z_new = z_sh[inv]
    sync = replicated_sync_bytes_per_device(comm.n_workers, cfg.vocab_size, cfg.num_topics)
    real = dataclasses.replace(cfg, w_bits=None, quant=None)
    return {"sweep_ms": statistics.median(times) / sync_every, "sweep_ms_all": times,
            "step_sweeps": sync_every, "workers": comm.n_workers,
            "launches_per_sweep": launches // sync_every,
            "bound": sweep_bound(real, corpus, LDAState(z_new, n_dt, n_wt, n_t_new)),
            "sync_bytes_per_device": sync, "sync_bytes_all_workers": sync * comm.n_workers,
            "invariants": check_counts(cfg, corpus, z_new, n_dt_sh[:cfg.num_docs],
                                       n_wt_new, n_t_new),
            "counts": count_headroom(real, n_wt_new, n_t_new),
            "result": (z_new, n_dt_sh[:cfg.num_docs], n_wt_new, n_t_new), "step": sweep}


def _client_server_static(cfg, num_tokens, n_workers) -> dict:
    """Per-worker bytes of the client-server layout: its token shard (ids,
    z, weight), its documents' rows of `n_dt`, and a replicated float32
    (V, K) `n_wt` and (K,) `n_t`."""
    tokens = -(-num_tokens // n_workers) * 4 * 4
    n_dt = -(-cfg.num_docs // n_workers) * cfg.num_topics * 4
    model = (cfg.vocab_size + 1) * cfg.num_topics * 4
    return {"tokens_bytes": tokens, "n_dt_bytes": n_dt, "model_bytes": model,
            "total_bytes": tokens + n_dt + model}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--tokens", type=int, default=16_777_216)
    ap.add_argument("--block", type=int, default=8192)
    ap.add_argument("--replicate-docs", action="store_true")
    ap.add_argument("--shard-vocab", action="store_true")
    ap.add_argument("--client-server", action="store_true")
    ap.add_argument("--sync-every", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--outdir", default=OUTDIR)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    ok = True
    for mp in ([False, True] if args.both_meshes else [args.multi_pod]):
        rec = run_one(mp, num_tokens=args.tokens, block=args.block,
                      shard_docs=not args.replicate_docs, shard_vocab=args.shard_vocab,
                      client_server=args.client_server, sync_every=args.sync_every,
                      device=args.device, outdir=args.outdir, tag=args.tag)
        ok = ok and rec["invariants"]["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
