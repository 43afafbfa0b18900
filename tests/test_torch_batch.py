"""Batched multi-model fits in the port vs the JAX reference, on the CPU.

  * the stack helpers (`compat_key`, `batch_cfg`, pad, stack, unstack) and
    the bucket ladder (`length_bucket`, `doc_bucket`, `plan_buckets`) give
    what the reference's give on the same inputs;
  * `sweep_many` and `mh_sweep_many` replay the reference's
    `ops.sweep_many` / `ops.mh_sweep_many` from the noise, draws and tables
    the reference draws and builds (topics equal except at near-ties,
    counts exact at `w_bits` 8 and within 1e-5 relative in float32);
  * a batched run of M models equals M sequential `cuda` (or `alias`) runs
    from the same generators token for token, counts exactly: each model
    draws from its own generator at its own token count;
  * the service's `fit_batch` / `refine_many` (single-model fallback,
    empty-set rejection, dedup, the `auto` and `alias` routes) and
    `TopicEngine.fit_many` serving a wave with one `fit_batch` call.

Small sizes (M <= 4, N <= 2,000, K <= 16) and one torch thread.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import alias as ref_alias  # noqa: E402
from repro.core import batch as ref_batch  # noqa: E402
from repro.core import codec as ref_codec  # noqa: E402
from repro.core import types as ref_types  # noqa: E402
from repro.kernels.alias_mh import ops as ref_alias_ops  # noqa: E402
from repro.kernels.lda_gibbs import ops as ref_ops  # noqa: E402
from repro.serving import batch_engine as ref_engine  # noqa: E402
from repro_torch.api import VedaliaClient  # noqa: E402
from repro_torch.api.backends import get_backend  # noqa: E402
from repro_torch.api.service import FitRequest, VedaliaService  # noqa: E402
from repro_torch.core import batch, codec, rlda, types  # noqa: E402
from repro_torch.data import reviews  # noqa: E402
from repro_torch.kernels.alias_mh import ops as alias_ops  # noqa: E402
from repro_torch.kernels.lda_gibbs import ops  # noqa: E402
from repro_torch.serving import batch_engine  # noqa: E402
from repro_torch.serving.topic_engine import TopicEngine  # noqa: E402

NEAR_TIE = 1e-5
K, D_PAD, V = 6, 32, 200
LENGTHS = (420, 377, 250)
DOCS = (20, 18, 11)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg_fields(num_docs, w_bits, k=K):
    return dict(num_topics=k, vocab_size=V, num_docs=num_docs, alpha=0.1, beta=0.01,
                w_bits=w_bits)


def _corpora(seed=0):
    """Ragged per-model corpora as numpy (docs, words, weights)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, d, n).astype(np.int32), rng.integers(0, V, n).astype(np.int32),
             rng.uniform(0.1, 1.0, n).astype(np.float32)) for n, d in zip(LENGTHS, DOCS)]


def _both(arrays):
    """One corpus as (reference Corpus, port Corpus)."""
    return (ref_types.Corpus(*(jnp.asarray(a) for a in arrays)),
            types.corpus_from_numpy(*arrays, device="cpu"))


def _port_state(st) -> types.LDAState:
    return types.LDAState(*(torch.tensor(np.asarray(getattr(st, f)))
                            for f in ("z", "n_dt", "n_wt", "n_t")))


def _assert_state_equal(got, want, w_bits):
    np.testing.assert_array_equal(got.z.numpy(), np.asarray(want.z))
    for f in ("n_dt", "n_wt", "n_t"):
        if w_bits is None:
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def _review_sets(m, n=14):
    return [reviews.generate(reviews.SyntheticSpec(
        num_reviews=n + 3 * s, vocab_size=200, num_topics=4, mean_tokens=25, num_users=30,
        seed=50 + s)).reviews for s in range(m)]


def _preps(m, w_bits=8):
    return [rlda.prepare(rs, base_vocab=200, num_topics=6, w_bits=w_bits, device="cpu")
            for rs in _review_sets(m)]


# -- helpers and buckets against the reference --------------------------------


def test_compat_key_and_batch_cfg_match_reference():
    ref_cfgs = [ref_types.LDAConfig(**_cfg_fields(d, 8)) for d in DOCS]
    cfgs = [types.LDAConfig(**_cfg_fields(d, 8)) for d in DOCS]
    assert [batch.compat_key(c) for c in cfgs] == [ref_batch.compat_key(c) for c in ref_cfgs]
    got, want = batch.batch_cfg(cfgs, D_PAD), ref_batch.batch_cfg(ref_cfgs, D_PAD)
    assert {f: getattr(got, f) for f in _cfg_fields(0, 8)} == \
        {f: getattr(want, f) for f in _cfg_fields(0, 8)}
    other = types.LDAConfig(**_cfg_fields(8, 8, k=9))
    with pytest.raises(ValueError, match="incompatible"):
        batch.batch_cfg([cfgs[0], other], D_PAD)
    with pytest.raises(ValueError, match="capacity"):
        batch.batch_cfg(cfgs, 4)


@pytest.mark.parametrize("n", [1, 16, 17, 255, 256, 257, 900, 18_100, 36_500, 70_000])
def test_bucket_ladders_match_reference(n):
    assert batch_engine.length_bucket(n) == ref_engine.length_bucket(n)
    assert batch_engine.doc_bucket(n) == ref_engine.doc_bucket(n)
    for name in ("LENGTH_QUANTUM", "DOC_QUANTUM", "MAX_MODELS_PER_LAUNCH"):
        assert getattr(batch_engine, name) == getattr(ref_engine, name)


def test_plan_buckets_matches_reference():
    rng = np.random.default_rng(1)
    items, ref_items = [], []
    for i, n in enumerate([300, 600, 250, 5000, 320, 610, 299, 1200]):
        k = 9 if i == 3 else K
        d = int(rng.integers(5, 40))
        arrays = (np.zeros(n, np.int32), np.zeros(n, np.int32), np.ones(n, np.float32))
        ref_c, c = _both(arrays)
        items.append((types.LDAConfig(**_cfg_fields(d, 8, k)), c))
        ref_items.append((ref_types.LDAConfig(**_cfg_fields(d, 8, k)), ref_c))
    for max_models in (64, 2):
        assert batch_engine.plan_buckets(items, max_models) == \
            ref_engine.plan_buckets(ref_items, max_models)


def test_metrics_declared_as_the_reference_declares_them():
    for name in ("_BUCKET_MODELS", "_PADDED_TOKENS", "_REAL_TOKENS"):
        got, want = getattr(batch_engine, name), getattr(ref_engine, name)
        assert (got.name, got.kind, tuple(got.label_names)) == \
            (want.name, want.kind, tuple(want.label_names))
        assert getattr(got, "buckets", None) == getattr(want, "buckets", None)


@pytest.mark.parametrize("w_bits", [None, 8])
def test_pad_stack_unstack_match_reference(w_bits):
    rng = np.random.default_rng(2)
    n_pad = batch_engine.length_bucket(max(LENGTHS))
    both = [_both(a) for a in _corpora()]
    ref_cfgs = [ref_types.LDAConfig(**_cfg_fields(d, w_bits)) for d in DOCS]
    cfgs = [types.LDAConfig(**_cfg_fields(d, w_bits)) for d in DOCS]
    zs = [rng.integers(0, K, n).astype(np.int32) for n in LENGTHS]
    ref_states = [ref_codec.rebuild_state(c, co, jnp.asarray(z))
                  for c, (co, _), z in zip(ref_cfgs, both, zs)]
    states = [codec.rebuild_state(c, co, torch.as_tensor(z))
              for c, (_, co), z in zip(cfgs, both, zs)]
    for st, ref_st in zip(states, ref_states):
        _assert_state_equal(st, ref_st, w_bits)

    got_c = batch.stack_corpora([c for _, c in both], n_pad)
    want_c = ref_batch.stack_corpora([c for c, _ in both], n_pad)
    for f in ("docs", "words", "weights"):
        np.testing.assert_array_equal(getattr(got_c, f).numpy(), np.asarray(getattr(want_c, f)))
    got_p = batch.pad_corpus(both[1][1], n_pad)
    want_p = ref_batch.pad_corpus(both[1][0], n_pad)
    np.testing.assert_array_equal(got_p.weights.numpy(), np.asarray(want_p.weights))

    bcfg, ref_bcfg = batch.batch_cfg(cfgs, D_PAD), ref_batch.batch_cfg(ref_cfgs, D_PAD)
    got_s = batch.stack_states(bcfg, states, n_pad)
    want_s = ref_batch.stack_states(ref_bcfg, ref_cfgs, ref_states, n_pad)
    _assert_state_equal(got_s, want_s, w_bits)
    # The batched rebuild of the stack is the stack of the per-model rebuilds.
    _assert_state_equal(codec.rebuild_state(bcfg, got_c, got_s.z), want_s, w_bits)

    got_u = batch.unstack_states(cfgs, [c for _, c in both], got_s)
    want_u = ref_batch.unstack_states(ref_cfgs, [c for c, _ in both], want_s)
    for g, w in zip(got_u, want_u):
        _assert_state_equal(g, w, w_bits)
    with pytest.raises(ValueError, match="pad target"):
        batch.pad_corpus(both[0][1], 10)


# -- sweeps replay the reference's --------------------------------------------


def _ref_stack(w_bits, seed):
    """The reference's stacked cold start, the stacked corpora on both sides
    and the shared configs."""
    both = [_both(a) for a in _corpora(seed)]
    n_pad = batch_engine.length_bucket(max(LENGTHS))
    ref_cfg = ref_batch.batch_cfg([ref_types.LDAConfig(**_cfg_fields(d, w_bits))
                                   for d in DOCS], D_PAD)
    cfg = batch.batch_cfg([types.LDAConfig(**_cfg_fields(d, w_bits)) for d in DOCS], D_PAD)
    ref_c = ref_batch.stack_corpora([c for c, _ in both], n_pad)
    c = batch.stack_corpora([c for _, c in both], n_pad)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(LENGTHS))
    return cfg, ref_cfg, c, ref_c, ref_batch.init_many(ref_cfg, ref_c, keys)


@pytest.mark.parametrize("w_bits", [None, 8])
def test_sweep_many_replays_reference_sweep_many(w_bits):
    cfg, ref_cfg, corpora, ref_corpora, ref_state = _ref_stack(w_bits, seed=3)
    m, n = corpora.docs.shape
    for s in range(3):
        keys = jax.random.split(jax.random.PRNGKey(100 + s), m)
        # The noise the reference's sweep_many draws from these keys.
        kp, npad = -(-K // 128) * 128, -(-n // 256) * 256
        noise = jax.vmap(lambda kk: jax.random.gumbel(kk, (npad, kp), jnp.float32))(keys)
        noise = torch.tensor(np.asarray(noise)[:, :n, :K])
        state = _port_state(ref_state)
        got = ops.sweep_many(cfg, state, corpora, noise)
        ref_state = ref_ops.sweep_many(ref_cfg, ref_state, ref_corpora, keys)
        if not np.array_equal(got.z.numpy(), np.asarray(ref_state.z)):
            real = codec.decode_state(cfg, state)
            scores = ops.perturbed_scores(corpora.docs, corpora.words, state.z,
                                          corpora.weights, real.n_dt, real.n_wt, real.n_t,
                                          noise, alpha=cfg.alpha, beta=cfg.beta,
                                          beta_bar=cfg.beta_bar)
            top2 = scores.topk(2, dim=-1).values
            diff = got.z.numpy() != np.asarray(ref_state.z)
            assert ((top2[..., 0] - top2[..., 1]).numpy()[diff] < NEAR_TIE).all()
            return
        _assert_state_equal(got, ref_state, w_bits)


@pytest.mark.parametrize("w_bits", [None, 8])
def test_mh_sweep_many_replays_reference_mh_sweep_many(w_bits):
    cfg, ref_cfg, corpora, ref_corpora, ref_state = _ref_stack(w_bits, seed=4)
    m, n = corpora.docs.shape
    mh_steps = 4
    for s in range(3):
        keys = jax.random.split(jax.random.PRNGKey(200 + s), m)
        draws = jax.vmap(lambda kk: ref_alias_ops._draws(kk, n, K, mh_steps))(keys)
        draws = tuple(torch.tensor(np.asarray(x)) for x in draws)
        tables = (*ref_alias.build_alias_tables(
                      ref_codec.decode_array(ref_cfg, ref_state.n_wt) + ref_cfg.beta),
                  *ref_alias.build_alias_tables(
                      ref_codec.decode_array(ref_cfg, ref_state.n_dt) + ref_cfg.alpha))
        tables = tuple(torch.tensor(np.asarray(x)) for x in tables)
        state = _port_state(ref_state)
        got = alias_ops.mh_sweep_many(cfg, state, corpora, draws, tables)
        ref_state = ref_alias_ops.mh_sweep_many(ref_cfg, ref_state, ref_corpora, keys,
                                                mh_steps)
        if not np.array_equal(got.z.numpy(), np.asarray(ref_state.z)):
            acc, _ = alias_ops.margins(corpora.docs, corpora.words, state.z, corpora.weights,
                                       state.n_dt, state.n_wt, state.n_t, *tables, *draws,
                                       alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar,
                                       w_bits=w_bits)
            diff = got.z.numpy() != np.asarray(ref_state.z)
            assert (acc.numpy()[diff] < NEAR_TIE).all()
            return
        _assert_state_equal(got, ref_state, w_bits)
        assert (got.z != state.z).any()  # the chains move


# -- batched runs equal sequential runs ---------------------------------------


@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("multi,single", [("batched", "cuda"), ("alias", "alias")])
def test_run_batched_equals_sequential_runs(multi, single, w_bits):
    preps = _preps(3, w_bits)
    cfgs, corpora = [p.cfg for p in preps], [p.corpus for p in preps]

    def gens(seed):
        return [torch.Generator().manual_seed(seed + i) for i in range(len(preps))]

    states, stats = batch_engine.run_batched(get_backend(multi), cfgs, corpora, gens(7), 4)
    # 14 reviews bucket at 16 docs, 17 and 20 at 32: two stacked runs.
    assert stats.num_models == 3 and stats.num_launches == 2
    warm, _ = batch_engine.run_batched(get_backend(multi), cfgs, corpora, gens(17), 3,
                                       states=states)
    for i, p in enumerate(preps):
        want = get_backend(single).run(p.cfg, p.corpus, torch.Generator().manual_seed(7 + i), 4)
        _assert_state_equal(states[i], want, 8)  # token for token, counts exactly
        want = get_backend(single).run(p.cfg, p.corpus, torch.Generator().manual_seed(17 + i),
                                       3, state=want)
        _assert_state_equal(warm[i], want, 8)
        assert warm[i].z.shape == (p.corpus.num_tokens,)
        assert warm[i].n_dt.shape == (p.cfg.num_docs, p.cfg.num_topics)


def test_init_many_draws_each_model_at_its_own_length():
    cfg = batch.batch_cfg([types.LDAConfig(**_cfg_fields(d, 8)) for d in DOCS], D_PAD)
    corpora = [types.corpus_from_numpy(*a, device="cpu") for a in _corpora(5)]
    n_pad = batch_engine.length_bucket(max(LENGTHS))
    got = batch.init_many(cfg, batch.stack_corpora(corpora, n_pad),
                          [torch.Generator().manual_seed(i) for i in range(3)], LENGTHS)
    for i, c in enumerate(corpora):
        want = types.init_state(cfg, c, torch.Generator().manual_seed(i))
        assert torch.equal(got.z[i, :c.num_tokens], want.z)
        assert not got.z[i, c.num_tokens:].any()  # padding keeps topic 0
    assert torch.equal(got.n_dt[:, DOCS[0]:].sum(), torch.tensor(0, dtype=torch.int32))


def test_batched_backend_single_model_surface_is_the_cuda_chain():
    p = _preps(1)[0]
    a = get_backend("batched").run(p.cfg, p.corpus, torch.Generator().manual_seed(3), 3)
    b = get_backend("cuda").run(p.cfg, p.corpus, torch.Generator().manual_seed(3), 3)
    _assert_state_equal(a, b, 8)
    a = get_backend("batched").sweep(p.cfg, a, p.corpus, torch.Generator().manual_seed(4))
    b = get_backend("cuda").sweep(p.cfg, b, p.corpus, torch.Generator().manual_seed(4))
    _assert_state_equal(a, b, 8)


# -- the service ----------------------------------------------------------------


def test_fit_batch_equals_sequential_fits_from_seed_plus_i():
    sets = _review_sets(3)
    svc = VedaliaService(device="cpu", backend="auto", num_sweeps=4)
    handles = svc.fit_batch(sets, num_topics=6, base_vocab=200, seed=7)
    assert [h.backend for h in handles] == ["batched"] * 3
    assert sorted(svc.handles) == [h.handle_id for h in handles]
    seq = VedaliaService(device="cpu", backend="cuda", num_sweeps=4)
    for i, (h, rs) in enumerate(zip(handles, sets)):
        want = seq.fit(rs, num_topics=6, base_vocab=200, seed=7 + i)
        _assert_state_equal(h.state, want.state, 8)
        assert h.sweeps_run == 4 and h.state.z.device.type == "cpu"


def test_fit_batch_single_model_falls_back_to_sequential():
    svc = VedaliaService(device="cpu", backend="auto", num_sweeps=2)
    (h,) = svc.fit_batch(_review_sets(1), num_topics=4, base_vocab=200)
    assert h.backend == "torch"  # num_models=1 never routes to batched


def test_fit_batch_rejects_empty_sets():
    svc = VedaliaService(device="cpu", num_sweeps=2)
    with pytest.raises(ValueError, match="at least one"):
        svc.fit_batch([])
    with pytest.raises(ValueError, match="set 1 is empty"):
        svc.fit_batch([_review_sets(1)[0], []])
    with pytest.raises(ValueError, match="at least one"):
        svc.fit_batch_prepared([])


def test_fit_batch_without_stacked_surface_is_sequential_with_per_model_seeds():
    sets = _review_sets(2)
    svc = VedaliaService(device="cpu", num_sweeps=3)
    handles = svc.fit_batch(sets, num_topics=4, base_vocab=200, backend="jnp", seed=11)
    assert [h.backend for h in handles] == ["torch", "torch"]
    for i, (h, rs) in enumerate(zip(handles, sets)):
        want = svc.fit(rs, num_topics=4, base_vocab=200, backend="torch", seed=11 + i)
        _assert_state_equal(h.state, want.state, 8)


def test_refine_many_dedups_repeated_handles():
    svc = VedaliaService(device="cpu", backend="auto", num_sweeps=3)
    handles = svc.fit_batch(_review_sets(2), num_topics=4, base_vocab=200)
    h = handles[0]
    before = h.sweeps_run
    out = svc.refine_many([h, h, handles[1]], 2)
    assert len(out) == 3 and out[0] is out[1]  # input order and length kept
    assert h.sweeps_run == before + 2  # one model, one refit
    assert svc.refine_many([], 2) == []


def test_refine_many_on_alias_handles(monkeypatch):
    """Handles fit on `alias` keep `backend == "alias"`; `refine_many` with
    backend=None takes the service default (`auto`), which resolves the
    multi-model refit to `batched`, as the reference does. An explicit
    `alias` refit stacks too: one `run_batched` call (two buckets, of 16
    and 32 docs), not N refines."""
    launches = []
    real = batch_engine.run_batched

    def counting(sampler, *args, **kw):
        out, stats = real(sampler, *args, **kw)
        launches.append((type(sampler).__name__, stats.num_launches))
        return out, stats

    monkeypatch.setattr(batch_engine, "run_batched", counting)
    svc = VedaliaService(device="cpu", backend="auto", num_sweeps=3)
    handles = svc.fit_batch(_review_sets(3), num_topics=6, base_vocab=200,
                            backend="alias", seed=3)
    assert launches == [("AliasSampler", 2)]
    assert all(h.backend == "alias" for h in handles)
    assert not torch.equal(handles[0].state.z[:50], handles[1].state.z[:50])
    before = [h.sweeps_run for h in handles]
    svc.refine_many(handles, 2, backend="alias", seed=5)
    assert launches == [("AliasSampler", 2)] * 2
    assert all(h.backend == "alias" for h in handles)
    svc.refine_many(handles, 2)
    assert launches[-1] == ("BatchedSampler", 2)
    assert all(h.backend == "batched" for h in handles)
    assert [h.sweeps_run for h in handles] == [b + 4 for b in before]
    for h in handles:
        rebuilt = codec.rebuild_state(h.cfg, h.model.corpus, h.state.z)
        _assert_state_equal(rebuilt, h.state, 8)
        assert svc.view(h).valid


def test_refine_many_matches_sequential_refines():
    sets = _review_sets(2)
    svc = VedaliaService(device="cpu", backend="auto", num_sweeps=3)
    handles = svc.fit_batch(sets, num_topics=6, base_vocab=200, seed=1)
    starts = [dataclasses.replace(h.state) for h in handles]
    svc.refine_many(handles, 2, seed=9)
    for i, (h, st) in enumerate(zip(handles, starts)):
        want = get_backend("cuda").run(h.cfg, h.model.corpus,
                                       torch.Generator().manual_seed(9 + i), 2, state=st)
        _assert_state_equal(h.state, want, 8)
        assert h.sweeps_run == 5


def test_topic_engine_fit_many_serves_a_batched_wave(monkeypatch):
    client = VedaliaClient(device="cpu", backend="auto", num_sweeps=3)
    calls = []
    real = client.fit_batch

    def counting(*args, **kw):
        calls.append(kw.get("backend"))
        return real(*args, **kw)

    monkeypatch.setattr(client, "fit_batch", counting)
    eng = TopicEngine(client, max_batch=4)
    sets = _review_sets(4)
    results = eng.fit_many([FitRequest(uid=i, reviews=rs, num_topics=6, base_vocab=200)
                            for i, rs in enumerate(sets)])
    assert calls == ["auto"]  # the whole wave in one fit_batch request
    assert [r.uid for r in results] == [0, 1, 2, 3]
    assert all(r.fit.backend == "batched" for r in results)
    assert all(np.isfinite(r.perplexity) and r.view.valid for r in results)
    # An explicit single-model backend keeps the per-request path.
    res = TopicEngine(client, max_batch=4).fit_many(
        [FitRequest(uid=9, reviews=sets[0], num_topics=4, base_vocab=200, backend="jnp")])
    assert res[0].fit.backend == "torch" and calls == ["auto"]
    with pytest.raises(ValueError, match="empty review set"):
        eng.submit(FitRequest(uid=1, reviews=[]))
