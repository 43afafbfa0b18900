"""The port's replicated client/server tier (`repro_torch.core.distributed`)
and the `distributed` backend, against the reference.

`partition_by_doc` and `shard_corpus` equal the reference's array for
array (the reference's are numpy and jnp, with no mesh); one worker's
`local_sweep` is `core.gibbs.sweep` bit for bit; and the sweep keeps the
counts exact invariants after every server sync at one and at two stacked
workers (unit weights: exact equality, where the reference's own test
allows 1e-3), with staleness 3 within 2% held-out perplexity of staleness
1 on the reference's planted corpus. The reference's own replicated sweep
runs on one CPU device under `jax.vmap` with a named data axis in place
of its device mesh (`_vmap_mesh`); fed its per-worker noise from its
sharded layout, the port's sweep ends on its state exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import distributed as ref_distributed  # noqa: E402
from repro.core import types as ref_types  # noqa: E402
from repro_torch.api.backends import get_backend  # noqa: E402
from repro_torch.core import distributed, gibbs, perplexity  # noqa: E402
from repro_torch.core.types import Corpus, LDAConfig, LDAState, build_counts, init_state  # noqa: E402
from _torch_mesh import planted  # noqa: E402
from _vmap_mesh import VmapMesh, vmap_shard_map  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setup(n=4096, v=120, d=40, k=12, seed=0):
    rng = np.random.default_rng(seed)
    cfg = LDAConfig(num_topics=k, vocab_size=v, num_docs=d)
    corpus = Corpus(torch.tensor(rng.integers(0, d, n), dtype=torch.int32),
                    torch.tensor(rng.integers(0, v, n), dtype=torch.int32),
                    torch.ones(n, dtype=torch.float32))
    return cfg, corpus


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("num_docs,n_shards", [(61, 2), (7, 4), (40, 1), (41, 3)])
def test_partition_by_doc_equals_reference(num_docs, n_shards):
    rng = np.random.default_rng(3)
    docs = rng.integers(0, num_docs, 900).astype(np.int32)
    got = distributed.partition_by_doc(num_docs, docs, n_shards)
    want = ref_distributed.partition_by_doc(num_docs, docs, n_shards)
    assert got[:2] == want[:2]
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    d_local, t_local, perm, inv = got
    assert np.array_equal(perm[inv], np.arange(len(docs)))


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_shard_corpus_equals_reference(n_shards):
    cfg, corpus = _setup(n=1000, d=37)
    st = init_state(cfg, corpus, _gen(0))
    got = distributed.shard_corpus(cfg, corpus, st.z, st.n_dt, n_shards)
    ref_cfg = ref_types.LDAConfig(num_topics=12, vocab_size=120, num_docs=37)
    ref_corpus = ref_types.Corpus(*(jnp.asarray(t.numpy()) for t in
                                    (corpus.docs, corpus.words, corpus.weights)))
    want = ref_distributed.shard_corpus(ref_cfg, ref_corpus, jnp.asarray(st.z.numpy()),
                                        jnp.asarray(st.n_dt.numpy()), n_shards)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and np.array_equal(g, w)
        assert g.dtype.kind == w.dtype.kind


def test_local_sweep_is_the_oracle_sweep():
    """One worker's pass over the whole corpus draws and resamples what
    `core.gibbs.sweep` does from the same generator (tolerance: none)."""
    cfg, corpus = _setup()
    st = init_state(cfg, corpus, _gen(1))
    z = distributed.local_sweep(cfg, corpus.docs, corpus.words, st.z, corpus.weights,
                                st.n_dt, st.n_wt, st.n_t, _gen(2), 1000)
    assert torch.equal(z, gibbs.sweep(cfg, st, corpus, _gen(2), 1000).z)


@pytest.mark.parametrize("sync_every", [1, 3])
def test_counts_stay_consistent(sync_every):
    cfg, corpus = _setup()
    sweep = distributed.make_client_server_sweep(cfg, block=1024, sync_every=sync_every)
    st = init_state(cfg, corpus, _gen(0))
    z, n_dt, n_wt = st.z, st.n_dt, st.n_wt
    gen = _gen(1)
    for _ in range(4):
        z, n_dt, n_wt, n_t = sweep(corpus.docs, corpus.words, z, corpus.weights, n_dt, n_wt, gen)
        rebuilt = build_counts(cfg, corpus, z)
        assert torch.equal(n_wt, rebuilt.n_wt) and torch.equal(n_dt, rebuilt.n_dt)
        assert torch.equal(n_t, rebuilt.n_t)


@pytest.mark.parametrize("n_shards,sync_every", [(2, 1), (2, 3), (3, 2)])
def test_sweep_replays_the_reference_under_vmap(n_shards, sync_every, monkeypatch):
    """W workers on the reference's sharded layout, fed the Gumbel tiles its
    replicated sweep draws (each worker's key folded with its index, split
    once a local sweep) end on the state its sweep reaches with its server
    sync, two syncs in a row. Tolerance: none — z and the counts (integers:
    unit weights) equal exactly."""
    monkeypatch.setattr(ref_distributed, "make_shard_map", vmap_shard_map)
    cfg, corpus = _setup(n=2000, d=37, k=6)
    block = 512
    ref_cfg = ref_types.LDAConfig(num_topics=6, vocab_size=120, num_docs=37)
    ref_corpus = ref_types.Corpus(*(jnp.asarray(t.numpy()) for t in
                                    (corpus.docs, corpus.words, corpus.weights)))
    st = init_state(cfg, corpus, _gen(0))
    docs_l, words, z, wts, n_dt, _ = ref_distributed.shard_corpus(
        ref_cfg, ref_corpus, jnp.asarray(st.z.numpy()), jnp.asarray(st.n_dt.numpy()), n_shards)
    ref_sweep = ref_distributed.make_client_server_sweep(
        ref_cfg, VmapMesh((n_shards,), ("data",)), block=block, sync_every=sync_every)
    sweep = distributed.make_client_server_sweep(cfg, n_shards, block=block,
                                                 sync_every=sync_every)
    t_local = z.shape[0] // n_shards
    want = (z, n_dt, jnp.asarray(st.n_wt.numpy()))
    got = tuple(torch.tensor(np.asarray(x)) for x in want)
    layout = tuple(torch.tensor(np.asarray(x)) for x in (docs_l, words, wts))
    for key in jax.random.split(jax.random.PRNGKey(5), 2):  # two server syncs
        keys, noise = [jax.random.fold_in(key, w) for w in range(n_shards)], []
        for _ in range(sync_every):
            pairs = [jax.random.split(kw) for kw in keys]
            keys = [kw for kw, _ in pairs]
            noise.append(torch.tensor(np.stack([
                _reference_block_noise(sub, t_local, block, 6) for _, sub in pairs])))
        want = ref_sweep(docs_l, words, want[0], wts, want[1], want[2], key)
        got = sweep(layout[0], layout[1], got[0], layout[2], got[1], got[2], None, noise=noise)
        for f, g, w in zip(("z", "n_dt", "n_wt", "n_t"), got, want):
            g, w = g.numpy(), np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(g, w), f


def _reference_block_noise(key, n, block, k):
    nblocks = -(-n // block)
    keys = jax.random.split(key, nblocks)
    return np.stack([np.asarray(jax.random.gumbel(kb, (block, k), jnp.float32))
                     for kb in keys])


def test_matches_plain_sweep_quality():
    cfg, corpus = _setup()
    sweep = distributed.make_client_server_sweep(cfg, block=1024, sync_every=2)
    st = init_state(cfg, corpus, _gen(0))
    z, n_dt, n_wt = st.z, st.n_dt, st.n_wt
    gen = _gen(1)
    for _ in range(10):  # 20 effective sweeps
        z, n_dt, n_wt, n_t = sweep(corpus.docs, corpus.words, z, corpus.weights, n_dt, n_wt, gen)
    p_cs = perplexity.perplexity(cfg, LDAState(z=z, n_dt=n_dt, n_wt=n_wt, n_t=n_t), corpus)
    p_ref = perplexity.perplexity(cfg, gibbs.run(cfg, corpus, _gen(5), 20), corpus)
    assert abs(np.log(p_cs) - np.log(p_ref)) < 0.2, (p_cs, p_ref)


def test_distributed_backend_one_worker_is_the_oracle():
    """The `distributed` backend at one worker and unit weights: the cache
    minus and plus the worker's own rows is exact in float32, so the chain
    is `core.gibbs.run`'s from the same generator, bit for bit."""
    cfg, corpus = _setup()
    st = get_backend("distributed", block=1024).run(cfg, corpus, _gen(4), 3)
    want = get_backend("torch", block=1024).run(cfg, corpus, _gen(4), 3)
    for f in ("z", "n_dt", "n_wt", "n_t"):
        assert torch.equal(getattr(st, f), getattr(want, f)), f
    assert get_backend("distributed").capabilities.device_kind == "pod"


def test_multi_shard_staleness_and_padding():
    """Two stacked workers through the `distributed` backend (prime
    num_docs = 61, so the last worker's slab is padded): the counts stay
    exact invariants of the assignments after EVERY server sync, and
    sync_every = 3 lands within 2% held-out perplexity of sync_every = 1,
    both forked from one warm start (the reference's test, its corpus and
    its band)."""
    n, d, v, k = 6000, 61, 100, 4
    docs, words = planted(n, d, v, k, 0)
    cfg = LDAConfig(num_topics=k, vocab_size=v, num_docs=d)

    def mk(s):
        return Corpus(torch.tensor(docs[s]), torch.tensor(words[s]),
                      torch.ones(len(docs[s]), dtype=torch.float32))

    tr, sc = mk(slice(n // 5, n)), mk(slice(0, n // 5))
    backends = {s: get_backend("distributed", workers=2, block=1024, sync_every=s)
                for s in (1, 3)}
    st = init_state(cfg, tr, _gen(0))
    dl, w, z0, wt, ndt0, inv = distributed.shard_corpus(cfg, tr, st.z, st.n_dt, 2)
    layout = Corpus(dl, w, wt)

    def check(s):
        reb = build_counts(cfg, tr, s.z[inv])
        assert torch.equal(s.n_wt, reb.n_wt) and torch.equal(s.n_dt[:d], reb.n_dt)
        assert torch.equal(s.n_t, reb.n_t)

    state = LDAState(z0, ndt0, st.n_wt, st.n_t)
    gen = _gen(1)
    for _ in range(72):  # shared warm start
        state = backends[1].sweep(cfg, state, layout, gen)
    warm = state

    def branch(sync_every, seed):
        s, ppxs, g = warm, [], _gen(seed)
        for i in range(36 // sync_every):
            s = backends[sync_every].sweep(cfg, s, layout, g)
            check(s)  # exact invariants after EVERY sync
            done = (i + 1) * sync_every
            if done >= 18 and done % 6 == 0:
                ppxs.append(perplexity.perplexity(
                    cfg, LDAState(s.z[inv], s.n_dt[:d], s.n_wt, s.n_t), sc))
        return float(np.mean(ppxs))

    p1, p3 = branch(1, 1000), branch(3, 2000)
    assert abs(p3 - p1) / p1 < 0.02, (p1, p3)
