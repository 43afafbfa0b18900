"""Stale-synchronous delta exchange for the parameter-server fit tier.

One sync moves only *delta rows*: each worker broadcasts the change its
local sweeps made to its (cap, K) support cache since the last sync,
tagged with global word ids, and every worker folds the rows that
intersect its own support back into its cache. That is one `all_gather`
of the seam (`pserver.comm`) plus a searchsorted + scatter-add — no (V, K)
tensor ever crosses between workers, which is the bytes advantage over
`core.distributed`'s whole-model sum (see the accounting helpers below).

Every tensor carries the seam's leading worker axis (W_local,); the
searchsorted runs batched over the local workers' (W_local, cap) supports.
Sentinel support slots (id `v_pad`) carry zero deltas by construction
(no token maps to them), so they may alias each other across workers
without affecting the applied update.
"""

from __future__ import annotations

import torch

from repro_torch.core.types import _scatter_rows


def own_rows(words_l, z, wts, cap: int, num_topics: int) -> torch.Tensor:
    """Each local worker's contribution to its support rows: (W_local, cap,
    K) from (W_local, t_local) ids, one `index_add_` on the flat
    (worker, row, topic) index (pad tokens carry weight 0). On the CPU it
    adds in token order, so the rows are deterministic."""
    return _scatter_rows(words_l, z, wts, cap, num_topics)


def exchange_deltas(comm, support, delta, cache, n_t):
    """One stale-synchronous sync step.

    `support` (W_local, cap) sorted global ids (sentinels last), `delta`
    (W_local, cap, K) each worker's count change since the last sync,
    `cache` (W_local, cap, K) the synced support caches, `n_t` (W_local, K)
    the synced global topic totals. Returns the post-sync (cache, n_t):
    every worker's delta rows applied wherever they intersect a worker's
    support (a worker's own delta is part of the gather, so self-sync is
    the exact local update), in gathered-row order.
    """
    w, cap = support.shape
    k = delta.shape[-1]
    all_idx = comm.all_gather(support).reshape(1, -1).expand(w, -1).contiguous()
    all_dlt = comm.all_gather(delta).reshape(-1, k)  # (W*cap, K)
    pos = torch.searchsorted(support, all_idx)
    hit = (pos < cap) & (support.gather(1, pos.clamp_max(cap - 1)) == all_idx)
    # Misses land on a spare row past each worker's cap, then drop.
    rows = torch.where(hit, pos, cap) + torch.arange(w, device=pos.device)[:, None] * (cap + 1)
    padded = torch.cat([cache, cache.new_zeros((w, 1, k))], dim=1).reshape(-1, k)
    padded.index_add_(0, rows.reshape(-1), all_dlt.repeat(w, 1))
    cache = padded.view(w, cap + 1, k)[:, :cap]
    return cache, n_t + comm.psum(delta.sum(1))


# -- communication accounting (analytic) ------------------------------------
#
# Both models assume bidirectional-ring collectives, the standard cost
# model: an all-gather of per-device payload B delivers (W-1)*B received
# bytes per device; an all-reduce of a replicated tensor of B bytes costs
# ~2*(W-1)/W*B per device (reduce-scatter + all-gather).


def sync_bytes_per_device(n_workers: int, cap: int, num_topics: int) -> int:
    """Per-device bytes received per pserver sync: (W-1) workers' (cap, K)
    float32 delta rows + their int32 global ids, plus the (K,) psum."""
    if n_workers <= 1:
        return 0
    row_bytes = (num_topics + 1) * 4
    psum = int(2 * (n_workers - 1) / n_workers * num_topics * 4)
    return (n_workers - 1) * cap * row_bytes + psum


def replicated_sync_bytes_per_device(
        n_shards: int, vocab_size: int, num_topics: int) -> int:
    """Per-device bytes of `core.distributed`'s whole-model psum of the
    replicated (V, K) float32 table per server sync."""
    if n_shards <= 1:
        return 0
    return int(2 * (n_shards - 1) / n_shards * vocab_size * num_topics * 4)
