"""Shared corpus of the port's mesh-tier tests."""

import numpy as np


def planted(n, d, v, k, seed):
    """The reference's planted corpus (`tests/test_distributed.py`, the
    bench's claim 4): 90% of each topic's mass on its own vocab block, so
    held-out perplexity is a stable quality probe. -> (docs, words)."""
    rng = np.random.default_rng(seed)
    blk = v // k
    phi = np.full((k, v), 0.1 / v)
    for t in range(k):
        phi[t, t * blk:(t + 1) * blk] += 0.9 * rng.dirichlet(np.full(blk, 0.5))
    phi /= phi.sum(1, keepdims=True)
    theta = rng.dirichlet(np.full(k, 0.3), size=d)
    docs = rng.integers(0, d, n).astype(np.int32)
    zt = (rng.random(n)[:, None] > theta.cumsum(1)[docs]).sum(1)
    words = np.empty(n, np.int64)
    for t in range(k):
        m = zt == t
        words[m] = np.searchsorted(phi[t].cumsum(), rng.random(m.sum()))
    return docs, np.minimum(words, v - 1).astype(np.int32)


def exchange_inputs(n_workers, cap, k, v, seed):
    """The (W, ...) inputs of one delta exchange: each worker's sorted
    support ids (the sentinel `v` past its live ones), integer-valued deltas
    on its live rows (zero on sentinels, as no token maps there), caches
    and totals. Integers keep every float32 sum exact in any order.
    -> (support, delta, cache, n_t)."""
    rng = np.random.default_rng(seed)
    support = np.full((n_workers, cap), v, np.int32)
    delta = np.zeros((n_workers, cap, k), np.float32)
    for w in range(n_workers):
        live = int(rng.integers(cap // 2, cap + 1))
        support[w, :live] = np.sort(rng.choice(v, live, replace=False))
        delta[w, :live] = rng.integers(-3, 4, (live, k))
    cache = rng.integers(0, 20, (n_workers, cap, k)).astype(np.float32)
    n_t = np.repeat(rng.integers(0, 500, (1, k)).astype(np.float32), n_workers, 0)
    return support, delta, cache, n_t
