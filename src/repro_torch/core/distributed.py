"""Client/server distributed Gibbs — the Chital topology on a worker grid.

The paper's network: each client holds *its own documents* and samples
them against a locally cached copy of the shared word-topic model; the
server aggregates model updates. Here every client is a worker of a
`pserver.comm` seam (W workers on a leading axis in one process, or one a
rank of a `torch.distributed` group):

  data shards  = client cohorts: token arrays and doc-topic counts are
                 partitioned by document across the workers;
  n_wt, n_t    = the model cache: replicated, rebuilt by a sum over
                 workers — the paper's "central model cache and updating
                 server";
  staleness    = `sync_every`: clients run several local sweeps against
                 their stale model copy (plus their OWN running deltas)
                 before the next server sync.

This module keeps the *fully replicated* model: every worker holds the
whole (V, K) table and each sync sums it whole, so it is the small-grid
oracle. The scale-out path — vocab-sharded state and sparse delta-row
exchange — is `repro_torch.pserver`, which reuses `local_sweep` and
`partition_by_doc` from here.

Caller contract: documents are partitioned contiguously across the
workers in blocks of `sweep.d_local` (= ceil(num_docs / W)); `docs` holds
WORKER-LOCAL doc ids in [0, d_local). Any corpus fits any grid: the last
worker's tail is padding (zero-weight tokens, empty n_dt rows) and
`shard_corpus` builds the padded layout from a flat corpus.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.gibbs import resample_block
from repro_torch.core.types import Corpus, LDAConfig, _scatter_rows
from repro_torch.kernels.lda_gibbs import ops


def local_sweep(cfg: LDAConfig, docs, words, z, wts, n_dt, n_wt, n_t,
                gen: Optional[torch.Generator], block: int,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One full resampling pass over one worker's tokens (pure local).

    The schedule and generator discipline of `core.gibbs.sweep`: blocks of
    `block` tokens, each one `resample_block` (row 1's kernel on CUDA
    tensors) with its own Gumbel draw from `gen` for the block's tokens,
    so a one-worker run is bit for bit the oracle's. `noise`, when given,
    is (nblocks, block, K), block b taking the first rows of `noise[b]`.
    `n_dt` and `n_wt` may be worker-local tables: `docs`/`words` just
    index their rows."""
    n, k = docs.shape[0], cfg.num_topics
    z_new = torch.empty_like(z)
    for b, lo in enumerate(range(0, n, block)):
        hi = min(n, lo + block)
        g = (ops.gumbel((hi - lo, k), gen, docs.device) if noise is None
             else noise[b, : hi - lo])
        z_new[lo:hi] = resample_block(cfg, docs[lo:hi], words[lo:hi], z[lo:hi], wts[lo:hi],
                                      n_dt, n_wt, n_t, g)
    return z_new


def partition_by_doc(num_docs: int, docs: np.ndarray, n_shards: int):
    """Host-side contiguous doc partition of a flat token stream.

    Shard `w` owns docs `[w*d_local, (w+1)*d_local)` with
    `d_local = ceil(num_docs / n_shards)`; each shard's tokens are padded
    to the max per-shard token count `t_local`. Returns
    ``(d_local, t_local, perm, inv)`` where `perm` is the
    `(n_shards * t_local,)` map from padded slot to original token index
    (sentinel `len(docs)` marks padding) and `inv` is the `(len(docs),)`
    inverse (slot of each original token). With one shard `perm` is the
    identity, which is what keeps single-shard runs bit-exact vs the
    unsharded oracle.
    """
    docs = np.asarray(docs)
    n = docs.shape[0]
    d_local = -(-num_docs // n_shards)
    shard = np.minimum(docs // d_local, n_shards - 1).astype(np.int64)
    order = np.argsort(shard, kind="stable")
    counts = np.bincount(shard, minlength=n_shards)
    t_local = max(1, int(counts.max()))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(n, dtype=np.int64) - starts[shard[order]]
    slots = shard[order] * t_local + within
    perm = np.full(n_shards * t_local, n, np.int64)
    perm[slots] = order
    inv = np.empty(n, np.int64)
    inv[order] = slots
    return d_local, t_local, perm, inv


def take_padded(x: torch.Tensor, perm: torch.Tensor, fill) -> torch.Tensor:
    """`x[perm]` with `fill` where `perm` is the padding sentinel `len(x)`."""
    return torch.cat([x, x.new_full((1, *x.shape[1:]), fill)])[perm]


def shard_corpus(cfg: LDAConfig, corpus: Corpus, z, n_dt, n_shards: int):
    """Pad + partition a flat corpus for an `n_shards` client/server sweep.

    Returns ``(docs_l, words, z_sh, wts, n_dt_sh, inv)`` on the corpus's
    device: token arrays of length `n_shards * t_local` (pad tokens carry
    weight 0 and doc/word 0, so they keep their assignment and contribute
    nothing), `docs_l` in shard-local ids, and `n_dt_sh` with rows padded
    to `n_shards * d_local`. Recover original-order assignments with
    ``z_sh[inv]`` and the true doc-topic table with
    ``n_dt_sh[:cfg.num_docs]``.
    """
    dev = corpus.device
    d_local, t_local, perm, inv = partition_by_doc(
        cfg.num_docs, corpus.docs.cpu().numpy(), n_shards)
    perm_t = torch.as_tensor(perm, device=dev)
    shard_of = torch.as_tensor((np.arange(n_shards * t_local) // t_local) * d_local,
                               dtype=torch.int32, device=dev)
    docs_l = take_padded(corpus.docs, perm_t, 0) - torch.where(
        perm_t < corpus.num_tokens, shard_of, 0)
    pad_rows = n_shards * d_local - cfg.num_docs
    n_dt_sh = torch.cat([n_dt, n_dt.new_zeros((pad_rows, n_dt.shape[1]))])
    return (docs_l.to(torch.int32), take_padded(corpus.words, perm_t, 0),
            take_padded(z, perm_t, 0), take_padded(corpus.weights, perm_t, 0.0), n_dt_sh,
            torch.as_tensor(inv, device=dev))


def make_client_server_sweep(cfg: LDAConfig, comm=None, *, block: int = 8192,
                             sync_every: int = 1):
    """Returns fn(docs, words, z, wts, n_dt_local, n_wt, gen, noise=None)
    -> (z, n_dt_local, n_wt, n_t), running `sync_every` client-local
    sweeps per server sync on the workers of `comm` (a `pserver.comm`
    seam, a worker count, or None for one worker). Counts are real-valued
    float32 (callers on the w_bits path convert at the boundary).

    Token arrays are this process's workers' slabs in order, each
    `t_local` long (`shard_corpus` builds the whole layout; a
    `ProcessGroup` rank passes its own slab), and `n_dt_local` has
    `sweep.d_local` rows a worker; `n_wt` is the replicated (V, K) table.
    Each worker draws from its own generator (`comm.generators`; one
    worker draws from `gen`). `noise[s]`, when given, is sweep s's
    (W_local, nblocks, block, K) noise.
    """
    from repro_torch.pserver import comm as comm_lib

    comm = comm_lib.make(1 if comm is None else comm)
    n_shards = comm.n_workers
    k, v = cfg.num_topics, cfg.vocab_size
    d_local = -(-cfg.num_docs // n_shards)

    def sweep(docs, words, z, wts, n_dt_local, n_wt, gen, noise=None):
        w = comm.w_local
        docs, words, z, wts = (x.reshape(w, -1) for x in (docs, words, z, wts))
        n_dt = n_dt_local.reshape(w, d_local, k)
        gens = comm.generators(gen, docs.device)

        # The model cache minus this client's own contribution: local
        # deltas stay fresh while other clients' updates stay stale.
        def own_contrib(zz):
            return _scatter_rows(words, zz, wts.to(n_wt.dtype), v, k)

        n_wt_others = n_wt[None] - own_contrib(z)
        for s in range(sync_every):
            cur_wt = n_wt_others + own_contrib(z)
            cur_t = cur_wt.sum(1)
            z = torch.stack([
                local_sweep(cfg, docs[i], words[i], z[i], wts[i], n_dt[i], cur_wt[i],
                            cur_t[i], gens[i], block,
                            None if noise is None else noise[s][i])
                for i in range(w)])
            n_dt = _scatter_rows(docs, z, wts.to(n_dt.dtype), d_local, k)

        # Server sync: aggregate every client's contribution (the paper's
        # "model cache and updating server", one sum per M sweeps).
        n_wt_new = comm.psum(own_contrib(z))[0]
        return z.reshape(-1), n_dt.reshape(-1, k), n_wt_new, n_wt_new.sum(0)

    sweep.d_local = d_local
    sweep.n_shards = n_shards
    sweep.comm = comm
    return sweep
