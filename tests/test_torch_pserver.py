"""The port's parameter-server fit tier (`repro_torch.pserver`) vs the reference.

A live `repro.pserver` program does not run in this container (its
multi-device `shard_map` needs a newer jax), so the tier is held against
the reference without one:

  * the host-side plan (`build_plan`) and the analytic byte counters are
    numpy and equal the reference's array for array, integer for integer;
  * one worker on `gibbs` is bit-exact to the port's `core.gibbs.run` from
    one generator state (the reference's mesh-1 claim), and fed the noise
    the reference draws from a JAX key it equals the reference's
    `core.gibbs.run` — the reference's own mesh-1 anchor;
  * W = 4 stacked workers at staleness 2 keep the counts exact invariants
    of the assignments after every sync (unit weights: exact equality),
    the delta exchange leaves every support cache equal to the global
    table's rows, and held-out perplexity lands within 2% of the oracle
    on a planted corpus;
  * the `cuda` and `mh` engines (their plain versions on CPU tensors) keep
    the invariants and land in the reference's 0.25 log-perplexity band;
  * two gloo processes (`comm.ProcessGroup`) give the z and counts of the
    `Stacked` grid from the same per-worker seeds, exactly;
  * several workers against the reference's own sync and program, run on
    one CPU device under `jax.vmap` with named axes in place of the device
    mesh: its `exchange_deltas` on the same inputs, and its whole `gibbs`
    program (exchanges, windows, the vocab-sharded assembly) replayed from
    its per-worker noise, equal on `Stacked` and on `ProcessGroup`, exactly.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import gibbs as ref_gibbs  # noqa: E402
from repro.core import types as ref_types  # noqa: E402
from repro.pserver import sync as ref_sync  # noqa: E402
from repro.pserver import topology as ref_topology  # noqa: E402
from repro_torch.api.backends import get_backend  # noqa: E402
from repro_torch.core import gibbs, perplexity  # noqa: E402
from repro_torch.core.types import Corpus, LDAConfig, LDAState, build_counts, init_state  # noqa: E402
from repro_torch.pserver import PServerFit, build_plan, comm, sync  # noqa: E402
from _torch_mesh import planted  # noqa: E402
from _vmap_mesh import VmapMesh, on_grid, vmap_shard_map, vmappable_all_gather  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
PLAN_FIELDS = ("n_data", "n_model", "d_local", "t_local", "cap", "v_pad",
               "perm", "inv", "support", "docs_l", "words_l")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _arrays(n=3000, v=120, d=41, seed=0, unit=True):
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, d, n).astype(np.int32)
    words = rng.integers(0, v, n).astype(np.int32)
    wts = np.ones(n, np.float32) if unit else rng.random(n).astype(np.float32)
    return docs, words, wts


def _setup(n=3000, v=120, d=41, k=8, seed=0, unit=True, w_bits=None):
    docs, words, wts = _arrays(n, v, d, seed, unit)
    cfg = LDAConfig(num_topics=k, vocab_size=v, num_docs=d, w_bits=w_bits)
    return cfg, Corpus(torch.tensor(docs), torch.tensor(words), torch.tensor(wts))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _states_equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("z", "n_dt", "n_wt", "n_t"))


def _invariant(cfg, corpus, st):
    """Counts equal the rebuild from z, exactly (unit weights: integers)."""
    reb = build_counts(cfg, corpus, st.z)
    return all(torch.equal(getattr(st, f), getattr(reb, f)) for f in ("n_dt", "n_wt", "n_t"))


# -- host-side plan and accounting, equal to the reference ------------------


@pytest.mark.parametrize("n_data,n_model,num_docs",
                         [(1, 1, 37), (2, 1, 37), (2, 2, 37), (3, 2, 37), (2, 2, 61), (4, 1, 7)])
def test_plan_equals_reference(n_data, n_model, num_docs):
    docs, words, _ = _arrays(n=2500, v=90, d=num_docs, seed=n_data * 10 + n_model)
    cfg = LDAConfig(num_topics=8, vocab_size=90, num_docs=num_docs)
    ref_cfg = ref_types.LDAConfig(num_topics=8, vocab_size=90, num_docs=num_docs)
    got = build_plan(cfg, docs, words, n_data, n_model)
    want = ref_topology.build_plan(ref_cfg, docs, words, n_data, n_model)
    for f in PLAN_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), f
        else:
            assert g == w, f
    assert got.n_workers == want.n_workers and got.v_shard == want.v_shard
    if n_data * n_model == 1:
        assert np.array_equal(got.perm, np.arange(len(docs)))


def test_plan_cap_override_raises_as_reference():
    docs, words, _ = _arrays(n=500, v=60, d=10)
    cfg = LDAConfig(num_topics=4, vocab_size=60, num_docs=10)
    ref_cfg = ref_types.LDAConfig(num_topics=4, vocab_size=60, num_docs=10)
    with pytest.raises(ValueError, match="cap") as got:
        build_plan(cfg, docs, words, 1, 1, cap=4)
    with pytest.raises(ValueError, match="cap") as want:
        ref_topology.build_plan(ref_cfg, docs, words, 1, 1, cap=4)
    assert str(got.value) == str(want.value)
    # A cap that covers the densest worker is kept as given.
    assert build_plan(cfg, docs, words, 2, 1, cap=64).cap == 64


@pytest.mark.parametrize("n_workers", [1, 2, 4, 8])
def test_sync_bytes_equal_reference(n_workers):
    for cap, k, v in ((100, 16, 1000), (3, 12, 10_000), (4096, 1000, 20_000)):
        assert sync.sync_bytes_per_device(n_workers, cap, k) \
            == ref_sync.sync_bytes_per_device(n_workers, cap, k)
        assert sync.replicated_sync_bytes_per_device(n_workers, v, k) \
            == ref_sync.replicated_sync_bytes_per_device(n_workers, v, k)
    if n_workers > 1:
        assert 0 < sync.sync_bytes_per_device(n_workers, 100, 16) \
            < sync.replicated_sync_bytes_per_device(n_workers, 1000, 16)


# -- one worker: bit-exact to the oracle -------------------------------------


@pytest.mark.parametrize("staleness", [1, 3])
def test_run_bitexact_vs_oracle(staleness):
    """A 1-worker run IS the oracle chain at any staleness (a worker is never
    stale w.r.t. itself; unit weights keep the cache-delta arithmetic exact
    in float32). Tolerance: none, every tensor bit for bit."""
    cfg, corpus = _setup()
    st = PServerFit(staleness=staleness, local="gibbs").run(cfg, corpus, _gen(7), 5)
    assert _states_equal(st, gibbs.run(cfg, corpus, _gen(7), 5))


def test_single_sweep_bitexact_fractional_weights():
    """One sweep is bit-exact with fractional (RLDA) weights: it scores
    straight off the input state, so no cache-delta arithmetic is involved."""
    cfg, corpus = _setup(unit=False)
    st0 = init_state(cfg, corpus, _gen(1))
    a = PServerFit(local="gibbs").sweep(cfg, st0, corpus, _gen(2))
    b = gibbs.sweep(cfg, st0, corpus, _gen(2))
    assert _states_equal(a, b)


def test_wbits_run_bitexact_vs_oracle():
    """The fixed-point path loops single-sweep programs, so the per-sweep
    quantization round-trip matches the oracle chain exactly."""
    cfg, corpus = _setup(unit=False, w_bits=8)
    st = PServerFit(local="gibbs").run(cfg, corpus, _gen(3), 3)
    assert st.n_wt.dtype == torch.int32
    assert _states_equal(st, gibbs.run(cfg, corpus, _gen(3), 3))


def test_warm_start_matches_oracle_continuation():
    cfg, corpus = _setup()
    ps = PServerFit(local="gibbs")
    st = ps.run(cfg, corpus, _gen(0), 3)
    assert _states_equal(ps.run(cfg, corpus, _gen(4), 2, state=st),
                         get_backend("torch").run(cfg, corpus, _gen(4), 2, state=st))


def test_cuda_engine_one_worker_is_the_cuda_backend():
    """`local="cuda"` at one worker: one resample a sweep over all tokens
    against the gathered support rows, drawing what the `cuda` backend's
    sweep draws from the same generator — equal bit for bit."""
    cfg, corpus = _setup()
    st = PServerFit(local="cuda", staleness=2).run(cfg, corpus, _gen(5), 4)
    assert _states_equal(st, get_backend("cuda").run(cfg, corpus, _gen(5), 4))
    assert _states_equal(PServerFit(local="pallas").run(cfg, corpus, _gen(5), 2),
                         get_backend("cuda").run(cfg, corpus, _gen(5), 2))


def test_mh_engine_one_worker_is_the_alias_backend():
    """`local="mh"` at one worker builds its proposal tables from the
    support rows (the alias backend's rows of the same words), draws the
    alias backend's (S, N) draws from the same generator and runs the same
    MH rounds: equal bit for bit, at staleness 1 and 3."""
    cfg, corpus = _setup()
    for staleness in (1, 3):
        st = PServerFit(local="mh", staleness=staleness).run(cfg, corpus, _gen(6), 4)
        assert _states_equal(st, get_backend("alias").run(cfg, corpus, _gen(6), 4))


def _reference_block_noise(key, n, block, k):
    nblocks = -(-n // block)
    keys = jax.random.split(key, nblocks)
    return np.stack([np.asarray(jax.random.gumbel(kb, (block, k), jnp.float32))
                     for kb in keys])


@pytest.mark.parametrize("w_bits,staleness", [(None, 2), (8, 1)])
def test_one_worker_replays_the_reference_gibbs_run(w_bits, staleness):
    """The reference's mesh-1 anchor, across packages: `PServerFit` at one
    worker, fed the Gumbel tiles the reference's `core.gibbs.run` draws
    from its key (one per block of each sweep) and started from the
    reference's own init state, ends on the reference's state. Tolerance:
    none — z, and the counts (integers: unit weights in float32, fixed
    point with fractional weights), equal exactly."""
    docs, words, wts = _arrays(n=2100, v=150, d=33, seed=4, unit=w_bits is None)
    fields = dict(num_topics=8, vocab_size=150, num_docs=33, w_bits=w_bits)
    block, sweeps = 512, 3
    ref_cfg = ref_types.LDAConfig(**fields)
    ref_corpus = ref_types.Corpus(jnp.asarray(docs), jnp.asarray(words), jnp.asarray(wts))
    key = jax.random.PRNGKey(11)
    want = ref_gibbs.run(ref_cfg, ref_corpus, key, sweeps, block=block)
    key, sub = jax.random.split(key)
    from repro.core import codec as ref_codec

    init = ref_codec.encode_state(ref_cfg, ref_types.init_state(ref_cfg, ref_corpus, sub))
    noise = [torch.as_tensor(_reference_block_noise(ks, len(docs), block, 8))[None]
             for ks in jax.random.split(key, sweeps)]
    cfg = LDAConfig(**fields)
    corpus = Corpus(torch.tensor(docs), torch.tensor(words), torch.tensor(wts))
    state = LDAState(*(torch.tensor(np.asarray(getattr(init, f)))
                       for f in ("z", "n_dt", "n_wt", "n_t")))
    got = PServerFit(block=block, staleness=staleness, local="gibbs").run(
        cfg, corpus, None, sweeps, state=state, noise=noise)
    for f in ("z", "n_dt", "n_wt", "n_t"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f


def test_backend_registration_routes_through_registry():
    cfg, corpus = _setup()
    st = get_backend("pserver", staleness=2).run(cfg, corpus, _gen(1), 3)
    assert _invariant(cfg, corpus, st)
    assert type(get_backend("pserver", workers=(2, 2))._fit.comm).__name__ == "Stacked"


def test_worker_generators_are_distinct_and_reproducible():
    """Each worker draws from its own stream (the worker index the reference
    folds into its key): four workers' first draws all differ, the same
    caller state gives the same four streams, and one worker keeps the
    caller's generator itself."""
    seam = comm.Stacked(2, 2)
    draws = [torch.rand(8, generator=g) for g in seam.generators(_gen(5), "cpu")]
    assert len({tuple(d.tolist()) for d in draws}) == 4
    again = [torch.rand(8, generator=g) for g in seam.generators(_gen(5), "cpu")]
    assert all(torch.equal(a, b) for a, b in zip(draws, again))
    other = [torch.rand(8, generator=g) for g in seam.generators(_gen(6), "cpu")]
    assert not any(torch.equal(a, b) for a, b in zip(draws, other))
    gen = _gen(5)
    assert comm.Stacked(1, 1).generators(gen, "cpu")[0] is gen


def test_bad_options_fail_loudly():
    with pytest.raises(ValueError, match="local engine"):
        PServerFit(local="tpu")
    with pytest.raises(ValueError, match="staleness"):
        PServerFit(staleness=0)
    PServerFit(local="pallas")  # the reference's name for the kernel engine


# -- several stacked workers --------------------------------------------------


@pytest.mark.parametrize("workers", [(2, 1), (2, 2), (3, 2)])
def test_exchange_leaves_every_cache_equal_to_the_global_rows(workers):
    """After one sync each worker's support cache holds the global table's
    rows of its support exactly (unit weights), whatever every worker's
    sweeps changed; sentinel rows stay 0; n_t is the global total."""
    cfg, corpus = _setup(n=2000, v=80, d=29)
    seam = comm.Stacked(*workers)
    plan = build_plan(cfg, corpus.docs.numpy(), corpus.words.numpy(), *workers)
    w, t, k = plan.n_workers, plan.t_local, cfg.num_topics
    perm = torch.as_tensor(plan.perm)
    words_l = torch.as_tensor(plan.words_l).view(w, t)
    support = torch.as_tensor(plan.support)
    wts = torch.cat([corpus.weights, torch.zeros(1)])[perm].view(w, t)
    z0, z1 = (torch.randint(0, k, (corpus.num_tokens,), generator=_gen(s), dtype=torch.int32)
              for s in (1, 2))

    def table(z):  # the global rows of each worker's support
        n_wt = torch.cat([build_counts(cfg, corpus, z).n_wt, torch.zeros(plan.v_pad + 1 - 80, k)])
        return n_wt[support]

    def own(z):
        return sync.own_rows(words_l, torch.cat([z, z.new_zeros(1)])[perm].view(w, t), wts,
                             plan.cap, k)

    n_t0 = build_counts(cfg, corpus, z0).n_t.expand(w, k)
    cache, n_t = sync.exchange_deltas(seam, support, own(z1) - own(z0), table(z0), n_t0)
    assert torch.equal(cache, table(z1))
    assert torch.equal(n_t, build_counts(cfg, corpus, z1).n_t.expand(w, k))


# -- several workers against the reference's own program under vmap --------
#
# `_vmap_mesh` runs the reference's collectives on one CPU device, nested
# vmaps over "data" and "model" standing in for the device mesh.


@pytest.fixture
def _vmappable_all_gather(monkeypatch):
    monkeypatch.setattr(jax.lax, "all_gather", vmappable_all_gather(jax.lax.all_gather))


def _reference_program_case(monkeypatch, grid, n=3000, v=120, d=41, k=8, w_bits=None,
                            sweeps=5, staleness=2, block=512, seed=21):
    """The reference's `PServerFit` on `gibbs` over a worker grid (its
    program under nested vmap), and what replays it in the port: its init
    state (encoded, numpy) and each sweep's per-worker block noise, the
    Gumbel tiles `local_sweep` draws from the sweep's key folded with the
    worker index, (sweeps, W, nblocks, block, K). -> (want, init, noise,
    the port's cfg and corpus)."""
    from repro.core import codec as ref_codec
    from repro.pserver import PServerFit as RefPServerFit
    from repro.pserver import sweep as ref_sweep

    monkeypatch.setattr(ref_sweep, "make_shard_map", vmap_shard_map)
    docs, words, wts = _arrays(n, v, d, seed=0, unit=w_bits is None)
    fields = dict(num_topics=k, vocab_size=v, num_docs=d, w_bits=w_bits)
    ref_cfg = ref_types.LDAConfig(**fields)
    ref_corpus = ref_types.Corpus(jnp.asarray(docs), jnp.asarray(words), jnp.asarray(wts))
    ref = RefPServerFit(mesh=VmapMesh(grid), block=block, staleness=staleness, local="gibbs")
    key = jax.random.PRNGKey(seed)
    want = ref.run(ref_cfg, ref_corpus, key, sweeps)
    key, sub = jax.random.split(key)
    init = ref_codec.encode_state(ref_cfg, ref_types.init_state(ref_cfg, ref_corpus, sub))
    t_local = ref._plan(ref_cfg, ref_corpus).t_local
    noise = np.stack([
        np.stack([_reference_block_noise(jax.random.fold_in(ks, w), t_local, block, k)
                  for w in range(grid[0] * grid[1])])
        for ks in jax.random.split(key, sweeps)])
    fields_np = ("z", "n_dt", "n_wt", "n_t")
    cfg = LDAConfig(**fields)
    corpus = Corpus(torch.tensor(docs), torch.tensor(words), torch.tensor(wts))
    return ({f: np.asarray(getattr(want, f)) for f in fields_np},
            {f: np.asarray(getattr(init, f)) for f in fields_np}, noise, cfg, corpus)


@pytest.mark.parametrize("grid", [(2, 1), (4, 1), (2, 2), (3, 2)])
def test_exchange_deltas_equals_the_reference_under_vmap(grid, _vmappable_all_gather):
    """One delta exchange over a worker grid: the port's `Stacked` seam
    gives the caches and totals of the reference's `exchange_deltas` on the
    same supports, deltas, caches and totals. Tolerance: none (integer-valued
    float32, so every order of the sums is exact)."""
    from _torch_mesh import exchange_inputs

    w = grid[0] * grid[1]
    support, delta, cache, n_t = exchange_inputs(w, cap=30, k=5, v=50, seed=w)
    want = on_grid(lambda *a: ref_sync.exchange_deltas(*a, ("data", "model")),
                    grid, support, delta, cache, n_t)
    got = sync.exchange_deltas(comm.Stacked(*grid), *map(torch.as_tensor,
                                                        (support, delta, cache, n_t)))
    for g, x in zip(got, want):
        assert g.numpy().dtype == x.dtype and np.array_equal(g.numpy(), x)


@pytest.mark.parametrize("grid,w_bits", [((2, 1), None), ((2, 2), None), ((3, 2), None),
                                         ((2, 2), 8)])
def test_stacked_workers_replay_the_reference_program_under_vmap(grid, w_bits, monkeypatch,
                                                                  _vmappable_all_gather):
    """W stacked workers at staleness 2 over 5 sweeps (two windows and a
    tail; with `w_bits` the single-sweep loop), fed the Gumbel tiles the
    reference's program draws under its per-worker keys and started from
    its init state, end on the reference's state: its delta exchanges,
    window schedule and vocab-sharded boundary assembly included.
    Tolerance: none — z and the counts equal exactly."""
    want, init, noise, cfg, corpus = _reference_program_case(monkeypatch, grid, w_bits=w_bits)
    state = LDAState(*(torch.tensor(init[f]) for f in ("z", "n_dt", "n_wt", "n_t")))
    got = PServerFit(workers=grid, block=512, staleness=2, local="gibbs").run(
        cfg, corpus, None, len(noise), state=state, noise=[torch.as_tensor(x) for x in noise])
    for f, w in want.items():
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), f


@pytest.mark.parametrize("local", ["gibbs", "cuda", "mh"])
def test_multiworker_invariants_after_every_sync_and_warm_start(local):
    """W = 4 stacked workers on (2, 2) at staleness 2: after every program
    (one window, one sync) the counts equal the rebuild from z exactly (unit
    weights); a warm start continues and stays exact."""
    cfg, corpus = _setup(n=5000, v=160, d=61)
    ps = PServerFit(workers=(2, 2), staleness=2, local=local)
    st = ps.run(cfg, corpus, _gen(7), 2)
    assert _invariant(cfg, corpus, st)
    gen = _gen(8)
    for _ in range(4):
        nxt = ps.run(cfg, corpus, gen, 2, state=st)
        assert _invariant(cfg, corpus, nxt)
        assert not torch.equal(nxt.z, st.z)
        st = nxt
    assert ps.plan(cfg, corpus).n_workers == 4


@pytest.mark.parametrize("local,workers", [("cuda", (1, 1)), ("cuda", (2, 2)),
                                           ("mh", (1, 1)), ("mh", (4, 1))])
def test_alternate_local_engines_consistent(local, workers):
    """The kernel and MH engines keep exact count invariants and land in
    the oracle's band (0.25 in log perplexity, the reference's; their
    draws differ from the `gibbs` engine's, so the gate is statistical)."""
    cfg, corpus = _setup(n=4096, v=120, d=40, k=12)
    sweeps = 30 if local == "mh" else 10  # MH burns through stale proposals
    st = PServerFit(workers=workers, staleness=2, local=local).run(cfg, corpus, _gen(2), sweeps)
    assert _invariant(cfg, corpus, st)
    p = perplexity.perplexity(cfg, st, corpus)
    p_ref = perplexity.perplexity(cfg, gibbs.run(cfg, corpus, _gen(3), 10), corpus)
    assert abs(np.log(p) - np.log(p_ref)) < 0.25, (p, p_ref)


def test_heldout_within_two_percent_of_the_oracle_at_staleness_two():
    """The reference's staleness claim on its planted corpus
    (`tests/test_distributed.py`): W = 4 on (2, 2) syncing every 2nd sweep
    stays within 2% averaged held-out perplexity of `core.gibbs.run`, both
    forked from one oracle warm start (so the gap is staleness, not mode
    selection)."""
    n, d, v, k = 6000, 61, 100, 4
    docs, words = planted(n, d, v, k, 0)
    cfg = LDAConfig(num_topics=k, vocab_size=v, num_docs=d)

    def mk(s):
        return Corpus(torch.tensor(docs[s]), torch.tensor(words[s]),
                      torch.ones(len(docs[s]), dtype=torch.float32))

    hold, train = mk(slice(0, n // 5)), mk(slice(n // 5, n))
    warm = gibbs.run(cfg, train, _gen(0), 60)
    ps = PServerFit(workers=(2, 2), staleness=2, local="gibbs")

    def avg_heldout(run, seed):
        st, ppxs, gen = warm, [], _gen(seed)
        for i in range(6):  # 36 measured sweeps, checked every 6
            st = run(st, gen)
            assert _invariant(cfg, train, st)
            if i >= 2:
                ppxs.append(perplexity.perplexity(cfg, st, hold))
        return float(np.mean(ppxs))

    p_stale = avg_heldout(lambda st, g: ps.run(cfg, train, g, 6, state=st), 100)
    p_oracle = avg_heldout(lambda st, g: gibbs.run(cfg, train, g, 6, state=st), 200)
    assert abs(p_stale - p_oracle) / p_oracle <= 0.02, (p_stale, p_oracle)


def test_sync_counters_count_full_windows():
    from repro_torch import obs
    from repro_torch.obs import metrics

    cfg, corpus = _setup(n=1500, v=60, d=20)
    ps = PServerFit(workers=(2, 1), staleness=3, local="gibbs")
    syncs = metrics.REGISTRY.get("vedalia_pserver_syncs_total")
    sent = metrics.REGISTRY.get("vedalia_pserver_sync_bytes_total")
    obs.enable()
    try:
        before = (syncs.value(), sent.value())
        ps.run(cfg, corpus, _gen(0), 7)  # two full windows and one tail sweep
        cap = ps.plan(cfg, corpus).cap
        assert syncs.value() - before[0] == 2
        assert sent.value() - before[1] == 2 * sync.sync_bytes_per_device(2, cap, 8)
        assert metrics.REGISTRY.get("vedalia_pserver_staleness").value() == 3
    finally:
        obs.disable()


# -- Stacked against ProcessGroup (two gloo processes) ----------------------

_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from _torch_mesh import exchange_inputs
    from repro_torch.core import distributed
    from repro_torch.core.types import Corpus, LDAConfig, LDAState, init_state
    from repro_torch.pserver import PServerFit, comm, sync

    rank, port, out, replay = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    rng = np.random.default_rng(0)
    n, v, d, k = 3000, 120, 41, 8
    cfg = LDAConfig(num_topics=k, vocab_size=v, num_docs=d)
    corpus = Corpus(torch.tensor(rng.integers(0, d, n), dtype=torch.int32),
                    torch.tensor(rng.integers(0, v, n), dtype=torch.int32),
                    torch.ones(n))
    res = {}
    for grid in ((2, 1), (1, 2)):
        for local in ("gibbs", "mh"):
            ps = PServerFit(workers=comm.ProcessGroup(*grid), staleness=2, local=local)
            st = ps.run(cfg, corpus, torch.Generator().manual_seed(7), 5)
            res[f"{grid}-{local}"] = {f: getattr(st, f).tolist()
                                      for f in ("z", "n_dt", "n_wt", "n_t")}
    seam = comm.ProcessGroup(2, 1)
    st0 = init_state(cfg, corpus, torch.Generator().manual_seed(3))
    docs_l, words, z, wts, n_dt, inv = distributed.shard_corpus(cfg, corpus, st0.z, st0.n_dt, 2)
    fn = distributed.make_client_server_sweep(cfg, seam, block=1024, sync_every=2)
    t, dl = len(z) // 2, fn.d_local
    mine = slice(rank * t, (rank + 1) * t)
    zr, ndt, nwt, nt = fn(docs_l[mine], words[mine], z[mine], wts[mine],
                          n_dt[rank * dl:(rank + 1) * dl], st0.n_wt,
                          torch.Generator().manual_seed(9))
    res["distributed"] = {"z": zr.tolist(), "n_dt": ndt.tolist(), "n_wt": nwt.tolist(),
                          "n_t": nt.tolist()}
    mine = [torch.tensor(x[rank:rank + 1]) for x in exchange_inputs(2, 30, 5, 50, 2)]
    cache, n_t = sync.exchange_deltas(comm.ProcessGroup(2, 1), *mine)
    res["exchange"] = {"cache": cache.tolist(), "n_t": n_t.tolist()}
    cases = np.load(replay)
    for tag in ("2x1", "1x2"):
        grid = tuple(int(c) for c in tag.split("x"))
        state = LDAState(*(torch.tensor(cases[f"{tag}_{f}"]) for f in ("z", "n_dt", "n_wt", "n_t")))
        noise = cases[f"{tag}_noise"]
        ps = PServerFit(workers=comm.ProcessGroup(*grid), block=512, staleness=2, local="gibbs")
        st = ps.run(cfg, corpus, None, len(noise), state=state,
                    noise=[torch.tensor(x[rank:rank + 1]) for x in noise])
        res[f"replay-{tag}"] = {f: getattr(st, f).tolist() for f in ("z", "n_dt", "n_wt", "n_t")}
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)
""")


def test_stacked_equals_process_group_over_gloo(tmp_path, monkeypatch, _vmappable_all_gather):
    """Two gloo processes, one worker each (`comm.ProcessGroup`), against
    the same grid stacked in this process (`comm.Stacked`): identical z
    and counts (exact) from the same per-worker seeds on (2, 1) and (1, 2)
    — the latter's vocab shards assembled by `reduce_scatter_tensor` — on
    `gibbs` and `mh`, and the replicated tier's sweep over the gloo sum.
    Against the reference (its collectives under vmap): the two ranks'
    delta exchange equals its `exchange_deltas`, and on (2, 1) and (1, 2),
    fed its per-worker Gumbel tiles from its init state, they end on its
    program's state, exactly. The two processes have 180 s before they are
    killed."""
    from _torch_mesh import exchange_inputs

    replay, wants, arrays = tmp_path / "replay.npz", {}, {}
    for grid in ((2, 1), (1, 2)):
        tag = f"{grid[0]}x{grid[1]}"
        wants[tag], init, noise, _, _ = _reference_program_case(monkeypatch, grid)
        arrays.update({f"{tag}_{f}": x for f, x in init.items()})
        arrays[f"{tag}_noise"] = noise
    np.savez(replay, **arrays)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    path = os.pathsep.join([str(SRC), str(Path(__file__).parent), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, PYTHONPATH=path)
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(port), str(outs[r]),
                               str(replay)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    ranks = [json.loads(o.read_text()) for o in outs]

    from repro_torch.core import distributed

    cfg, corpus = _setup()
    for grid in ((2, 1), (1, 2)):
        for local in ("gibbs", "mh"):
            st = PServerFit(workers=grid, staleness=2, local=local).run(cfg, corpus, _gen(7), 5)
            for r in ranks:
                got = r[f"{grid}-{local}"]
                for f in ("z", "n_dt", "n_wt", "n_t"):
                    assert torch.equal(torch.tensor(got[f], dtype=getattr(st, f).dtype),
                                       getattr(st, f)), (grid, local, f)
    st0 = init_state(cfg, corpus, _gen(3))
    docs_l, words, z, wts, n_dt, inv = distributed.shard_corpus(cfg, corpus, st0.z, st0.n_dt, 2)
    fn = distributed.make_client_server_sweep(cfg, 2, block=1024, sync_every=2)
    zs, ndt, nwt, nt = fn(docs_l, words, z, wts, n_dt, st0.n_wt, _gen(9))
    t, dl = len(z) // 2, fn.d_local
    for rank, r in enumerate(ranks):
        got = r["distributed"]
        assert torch.equal(torch.tensor(got["z"], dtype=torch.int32), zs[rank * t:(rank + 1) * t])
        assert torch.equal(torch.tensor(got["n_dt"]), ndt[rank * dl:(rank + 1) * dl])
        assert torch.equal(torch.tensor(got["n_wt"]), nwt)
        assert torch.equal(torch.tensor(got["n_t"]), nt)
    want_cache, want_nt = on_grid(lambda *a: ref_sync.exchange_deltas(*a, ("data", "model")),
                                   (2, 1), *exchange_inputs(2, 30, 5, 50, 2))
    for rank, r in enumerate(ranks):
        assert np.array_equal(np.float32(r["exchange"]["cache"]), want_cache[rank:rank + 1])
        assert np.array_equal(np.float32(r["exchange"]["n_t"]), want_nt[rank:rank + 1])
        for tag, want in wants.items():
            for f, w in want.items():
                assert np.array_equal(np.asarray(r[f"replay-{tag}"][f], w.dtype), w), (tag, f)
