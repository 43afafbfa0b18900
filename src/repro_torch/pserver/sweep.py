"""Program factory for the parameter-server fit tier.

One program = `num_sweeps` sweeps on a (data, model) worker grid where
every worker owns a contiguous doc slab. Per worker the carry is tiny and
support-local; every tensor carries the seam's leading worker axis
(W_local,) — all W workers with `comm.Stacked`, one with
`comm.ProcessGroup`:

  z (t_local,)            assignments of the worker's token slab
  n_dt (d_local, K)       the worker's doc-topic rows
  cache_s (cap, K)        support cache as of the last sync
  own_s (cap, K)          the worker's own contribution at the last sync
  nt_s (K,)               global topic totals as of the last sync

Within a `staleness`-sweep window every sweep scores against

  cur_cache = cache_s + (own(z) - own_s)       # own deltas fresh,
  cur_t     = nt_s    + (own(z) - own_s).sum   # remote deltas stale

on (cap, K) support rows instead of the full (V, K) table. Every
`staleness` sweeps the workers exchange delta rows
(`sync.exchange_deltas`); at the program boundary the authoritative
word-topic table is rebuilt exactly by scatter + `psum_scatter` across the
model axis, then a sum over the data axis (vocab-sharded assembly).

Three local engines:

  gibbs  `core.distributed.local_sweep` a worker: blocks of `block`
         tokens, one row-1 launch (`lda_gibbs.resample`) a block on the card
  cuda   the reference's "pallas" (still accepted as a name): one launch a
         sweep over all local workers' tokens against their gathered
         (cap, K) rows — `lda_gibbs.resample` (row 1) for one worker,
         `lda_gibbs.resample_many` (row 2) with the worker as the model axis
         for several; on the card the noise is drawn in the kernel under
         one Philox key a worker, on the CPU each worker draws (t_local, K)
         Gumbel noise from its generator
  mh     AliasLDA proposals: word tables from the bounded-staleness cache
         + β and doc tables from n_dt + α (`core.alias.sweep_tables`), then
         `mh_steps` MH rounds against that cache — `alias_mh.mh_resample`
         (row 4) for one worker, `mh_resample_many` (row 5) for several;
         Philox draws on the card, `core.alias.sweep_draws` on the CPU

Bit-exactness: with one worker the token permutation is the identity, the
worker keeps the caller's generator, and the "gibbs" engine is
`local_sweep` — the schedule of `core.gibbs.sweep` — so a float32 run
from one generator state reproduces `core.gibbs.run` bit for bit at unit
weights (any `staleness`: a worker is never stale w.r.t. itself); the
"cuda" engine likewise reproduces the `cuda` backend's sweeps.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.alias import sweep_draws, sweep_tables
from repro_torch.core.distributed import local_sweep
from repro_torch.core.types import LDAConfig, _scatter_rows
from repro_torch.kernels.alias_mh import ops as alias_ops
from repro_torch.kernels.lda_gibbs import ops
from repro_torch.pserver import sync
from repro_torch.pserver.topology import PServerPlan

#: Local engines, and the reference's names that mean one of them.
ENGINES = ("gibbs", "cuda", "mh")
ENGINE_ALIASES = {"pallas": "cuda"}


def engine_name(local: str) -> str:
    """A local engine's name (or the reference's alias of one) -> the
    engine; raises on anything else."""
    name = ENGINE_ALIASES.get(local, local)
    if name not in ENGINES:
        raise ValueError(f"unknown pserver local engine {local!r}")
    return name


def make_pserver_program(
    cfg: LDAConfig,
    comm,
    plan: PServerPlan,
    *,
    num_sweeps: int,
    staleness: int = 1,
    block: int = 4096,
    local: str = "gibbs",
    mh_steps: int = 4,
):
    """Build the program for one (seam, plan) pair.

    Returns fn(docs_l, words_l, z, wts, support, n_dt, cache0, n_t0, gens,
    noise=None) -> (z, n_dt, n_wt, n_t) with every tensor on the seam's
    local workers: tokens (W_local, t_local), support (W_local, cap),
    n_dt (W_local, d_local, K), cache0 (W_local, cap, K), n_t0
    (W_local, K); `gens` one generator a local worker. `n_wt` is each
    worker's (v_shard, K) vocab shard of the assembled table, `n_t` the
    (W_local, K) totals. All counts are real-valued float32; the sampler
    handles the stored-unit boundary. `noise[s]`, when given, replaces
    sweep s's draw: (W_local, nblocks, block, K) for "gibbs",
    (W_local, t_local, K) for "cuda".
    """
    local = engine_name(local)
    if (plan.n_data, plan.n_model) != (comm.n_data, comm.n_model):
        raise ValueError(f"plan for a ({plan.n_data}, {plan.n_model}) grid, seam {comm}")
    k = cfg.num_topics
    cap, d_local, v_pad = plan.cap, plan.d_local, plan.v_pad
    n_full, tail = divmod(num_sweeps, staleness)
    hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar)

    def _local_gibbs(z, docs, words, wts, n_dt, cache, n_t, gens, noise):
        return torch.stack([
            local_sweep(cfg, docs[i], words[i], z[i], wts[i], n_dt[i], cache[i], n_t[i],
                        gens[i], block, None if noise is None else noise[i])
            for i in range(z.shape[0])])

    def _local_cuda(z, docs, words, wts, n_dt, cache, n_t, gens, noise):
        w, n = z.shape
        philox = None
        if noise is None and z.is_cuda:
            philox = (ops.philox_key(gens[0]) if w == 1
                      else ops.philox_keys(gens, z.device))
        elif noise is None:
            noise = torch.stack([ops.gumbel((n, k), g, z.device) for g in gens])
        if w == 1:
            return ops.resample(docs[0], words[0], z[0], wts[0], n_dt[0], cache[0], n_t[0],
                                None if noise is None else noise[0], philox=philox, **hp)[None]
        return ops.resample_many(docs, words, z, wts, n_dt, cache, n_t, noise,
                                 philox=philox, **hp)

    def _local_mh(z, docs, words, wts, n_dt, cache, n_t, gens, noise):
        # AliasLDA word/doc cycle proposals from the bounded-staleness
        # support cache, accept/reject against the same target — the MH
        # correction is what absorbs the staleness.
        w, n = z.shape
        tables = sweep_tables(cfg, n_dt, cache)
        draws, key = (), {}
        if z.is_cuda:
            key = dict(mh_steps=mh_steps,
                       philox=(ops.philox_key(gens[0]) if w == 1
                               else ops.philox_keys(gens, z.device)))
        else:
            per = [sweep_draws(g, n, k, mh_steps, z.device) for g in gens]
            draws = tuple(torch.stack(d) for d in zip(*per))
        if w == 1:
            return alias_ops.mh_resample(
                docs[0], words[0], z[0], wts[0], n_dt[0], cache[0], n_t[0],
                *(t[0] for t in tables), *(d[0] for d in draws), **hp, **key)[None]
        return alias_ops.mh_resample_many(docs, words, z, wts, n_dt, cache, n_t, *tables,
                                          *draws, **hp, **key)

    local_fn = {"gibbs": _local_gibbs, "cuda": _local_cuda, "mh": _local_mh}[local]

    def program(docs, words, z, wts, support, n_dt, cache, n_t,
                gens: Sequence[Optional[torch.Generator]],
                noise: Optional[Sequence[torch.Tensor]] = None):
        def own(zz):
            return sync.own_rows(words, zz, wts, cap, k)

        def one_sweep(z, n_dt, cache_s, own_s, nt_s, s):
            delta_now = own(z) - own_s
            cur_cache = cache_s + delta_now
            cur_t = nt_s + delta_now.sum(1)
            z = local_fn(z, docs, words, wts, n_dt, cur_cache, cur_t, gens,
                         None if noise is None else noise[s])
            return z, _scatter_rows(docs, z, wts, d_local, k)

        cache_s, own_s, nt_s = cache, own(z), n_t
        s = 0
        for _ in range(n_full):
            for _ in range(staleness):
                z, n_dt = one_sweep(z, n_dt, cache_s, own_s, nt_s, s)
                s += 1
            own_z = own(z)
            cache_s, nt_s = sync.exchange_deltas(comm, support, own_z - own_s, cache_s, nt_s)
            own_s = own_z
        # Tail sweeps (num_sweeps % staleness) need no trailing sync — the
        # boundary rebuild below is exact regardless of cache state.
        for _ in range(tail):
            z, n_dt = one_sweep(z, n_dt, cache_s, own_s, nt_s, s)
            s += 1

        # Exact boundary rebuild of the authoritative vocab-sharded table:
        # scatter each worker's tokens into (v_pad, K), reduce-scatter
        # across the model axis (each worker keeps only its vocab shard),
        # then sum the data replicas.
        g = support.gather(1, words.long())  # global word ids (pads carry wt 0)
        contrib = _scatter_rows(g, z, wts, v_pad, k)
        n_t_out = comm.psum(contrib.sum(1))
        nwt_out = comm.psum(comm.psum_scatter(contrib), axis="data")
        return z, n_dt, nwt_out, n_t_out

    return program
