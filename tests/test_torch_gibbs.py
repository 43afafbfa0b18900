"""The port's blocked sweep, perplexity, core set and update vs the reference.

`core.gibbs.sweep` gets the noise the reference draws — one key per block
(`split(key, nblocks)`), then a (block, K) Gumbel tile per key — and must
resample the same topics except at near-ties (top-2 margin of score + noise
below 1e-5, where XLA's and PyTorch's float32 `log` may differ by an ulp).
Counts rebuilt from the port's topics are exact in `w_bits` fixed point and
within rtol 1e-6 in float32 (summation order). Perplexity on one
carried-across state is within rtol 1e-5 (float32 sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import codec as ref_codec  # noqa: E402
from repro.core import coreset as ref_coreset  # noqa: E402
from repro.core import gibbs as ref_gibbs  # noqa: E402
from repro.core import perplexity as ref_perplexity  # noqa: E402
from repro.core import types as ref_types  # noqa: E402
from repro_torch.core import codec, coreset, gibbs, perplexity, types, update  # noqa: E402
from repro_torch.kernels.lda_gibbs import ops  # noqa: E402

NEAR_TIE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _model(w_bits, seed=0, n=2500, d=60, v=200, k=8, sweeps=3):
    """A reference model after a few jnp sweeps, and the same model in the port."""
    rng = np.random.default_rng(seed)
    # Topic-structured tokens so the counts are not uniform.
    docs = np.sort(rng.integers(0, d, n)).astype(np.int32)
    words = ((docs.astype(np.int64) * 7 + rng.integers(0, 40, n)) % v).astype(np.int32)
    weights = rng.uniform(0.2, 1.0, n).astype(np.float32)
    fields = dict(num_topics=k, vocab_size=v, num_docs=d, alpha=0.1, beta=0.01, w_bits=w_bits)
    ref_cfg = ref_types.LDAConfig(**fields)
    ref_corpus = ref_types.Corpus(jnp.asarray(docs), jnp.asarray(words), jnp.asarray(weights))
    ref_state = ref_gibbs.run(ref_cfg, ref_corpus, jax.random.PRNGKey(seed), sweeps, block=1024)
    port = types.from_reference(
        fields, {"docs": docs, "words": words, "weights": weights},
        {f: np.asarray(getattr(ref_state, f)) for f in ("z", "n_dt", "n_wt", "n_t")},
        device="cpu")
    return (ref_cfg, ref_corpus, ref_state), port


def _reference_block_noise(key, n, block, k):
    nblocks = -(-n // block)
    keys = jax.random.split(key, nblocks)
    return np.stack([np.asarray(jax.random.gumbel(kb, (block, k), jnp.float32))
                     for kb in keys])


@pytest.mark.parametrize("w_bits", [None, 8])
def test_sweep_matches_reference_with_replayed_noise(w_bits):
    (ref_cfg, ref_corpus, ref_state), (cfg, corpus, state) = _model(w_bits)
    block = 512  # several blocks, a ragged last one
    key = jax.random.PRNGKey(42)
    want = ref_gibbs.sweep(ref_cfg, ref_state, ref_corpus, key, block)
    noise = _reference_block_noise(key, corpus.num_tokens, block, cfg.num_topics)
    got = gibbs.sweep(cfg, state, corpus, None, block, noise=torch.as_tensor(noise))

    n = corpus.num_tokens
    real = codec.decode_state(cfg, state)
    flat = torch.as_tensor(noise.reshape(-1, cfg.num_topics)[:n])
    scores = ops.perturbed_scores(corpus.docs, corpus.words, state.z, corpus.weights,
                                  real.n_dt, real.n_wt, real.n_t, flat, alpha=cfg.alpha,
                                  beta=cfg.beta, beta_bar=cfg.beta_bar).numpy()
    top2 = np.sort(scores, axis=1)[:, -2:]
    diff = np.flatnonzero(got.z.numpy() != np.asarray(want.z))
    assert all(top2[i, 1] - top2[i, 0] < NEAR_TIE for i in diff), diff
    assert np.mean(got.z.numpy() != np.asarray(state.z)) > 0.05  # the sweep moved topics

    ref_rebuilt = ref_codec.rebuild_state(ref_cfg, ref_corpus, jnp.asarray(got.z.numpy()))
    for f in ("n_dt", "n_wt", "n_t"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(ref_rebuilt, f))
        assert g.dtype == w.dtype
        if w_bits is None:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("w_bits", [None, 8])
def test_run_replays_noise_and_keeps_count_invariants(w_bits):
    _, (cfg, corpus, state) = _model(w_bits, seed=1)
    block, sweeps = 1024, 3
    rng = np.random.default_rng(9)
    nblocks = -(-corpus.num_tokens // block)
    noise = [torch.as_tensor(rng.gumbel(size=(nblocks, block, cfg.num_topics)).astype(np.float32))
             for _ in range(sweeps)]
    a = gibbs.run(cfg, corpus, None, sweeps, state=state, block=block, noise=noise)
    b = state
    for s in range(sweeps):
        b = gibbs.sweep(cfg, b, corpus, None, block, noise=noise[s])
    assert torch.equal(a.z, b.z) and torch.equal(a.n_wt, b.n_wt)
    real = codec.decode_state(cfg, a)
    np.testing.assert_allclose(float(real.n_t.sum()), float(corpus.weights.sum()), rtol=1e-4)
    rebuilt = codec.rebuild_state(cfg, corpus, a.z)
    for f in ("n_dt", "n_wt", "n_t"):
        assert torch.equal(getattr(rebuilt, f), getattr(a, f)), f
    # From scratch, seeded by the generator alone.
    c = gibbs.run(cfg, corpus, torch.Generator().manual_seed(0), 2)
    d = gibbs.run(cfg, corpus, torch.Generator().manual_seed(0), 2)
    assert torch.equal(c.z, d.z)


@pytest.mark.parametrize("w_bits", [None, 8])
def test_perplexity_matches_reference_on_carried_state(w_bits):
    (ref_cfg, ref_corpus, ref_state), (cfg, corpus, state) = _model(w_bits, seed=2)
    want = ref_perplexity.perplexity(ref_cfg, ref_state, ref_corpus)
    got = perplexity.perplexity(cfg, state, corpus)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ll = perplexity.log_likelihood(cfg, state, corpus, block=700)
    np.testing.assert_allclose(float(ll), float(ref_perplexity.log_likelihood(
        ref_cfg, ref_state, ref_corpus)), rtol=1e-5)


@pytest.mark.parametrize("w_bits", [None, 8])
def test_core_set_matches_reference_on_carried_state(w_bits):
    (ref_cfg, _, ref_state), (cfg, _, state) = _model(w_bits, seed=3, sweeps=8)
    for kw in ({}, {"mass_coverage": 0.6}, {"max_topics": 3}):
        ids, score = coreset.select_core_set(cfg, state, **kw)
        ref_ids, ref_score = ref_coreset.select_core_set(ref_cfg, ref_state, **kw)
        assert ids == ref_ids, kw
        np.testing.assert_allclose(score.numpy(), np.asarray(ref_score), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(coreset.topic_mass(cfg, state).numpy(),
                               np.asarray(ref_coreset.topic_mass(ref_cfg, ref_state)), rtol=1e-6)


def test_add_documents_incremental_and_full_recompute():
    _, (cfg, corpus, state) = _model(8, seed=4)
    model = update.UpdatableModel(cfg=cfg, corpus=corpus, state=state, full_recompute_every=2)
    rng = np.random.default_rng(0)
    m = 300
    new_docs = (cfg.num_docs + rng.integers(0, 5, m)).astype(np.int32)
    new_words = rng.integers(0, cfg.vocab_size, m).astype(np.int32)
    new_w = rng.uniform(0.2, 1.0, m).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    inc = update.add_documents(model, new_docs, new_words, new_w, gen, update_sweeps=2,
                               num_docs=cfg.num_docs + 6)
    assert inc.cfg.num_docs == cfg.num_docs + 6 and inc.updates_since_recompute == 1
    assert inc.corpus.num_tokens == corpus.num_tokens + m
    # Old tokens keep their topics; counts rebuild from the merged z.
    assert torch.equal(inc.state.z[: corpus.num_tokens], state.z)
    rebuilt = codec.rebuild_state(inc.cfg, inc.corpus, inc.state.z)
    assert torch.equal(rebuilt.n_wt, inc.state.n_wt)
    full = update.add_documents(inc, new_docs + 6, new_words, new_w, gen, update_sweeps=1)
    assert full.updates_since_recompute == 0
    assert full.corpus.num_tokens == corpus.num_tokens + 2 * m


def test_run_replays_a_reference_chain_of_rlda_sweeps():
    """20 sweeps of the reference's `gibbs.run` on a prepared RLDA corpus,
    its noise replayed through the port's `run` from the same initial
    topics: the chains stay identical (near-ties never arise here)."""
    from repro.core import rlda as ref_rlda
    from repro.core.types import init_state as ref_init
    from repro.data import reviews as ref_reviews

    revs = ref_reviews.generate(ref_reviews.SyntheticSpec(
        num_reviews=150, vocab_size=300, num_topics=6, seed=11)).reviews
    prep = ref_rlda.prepare(revs, base_vocab=300, num_topics=6)
    ref_cfg, ref_corpus = prep.cfg, prep.corpus
    key, sweeps, block = jax.random.PRNGKey(3), 20, 4096
    want = ref_gibbs.run(ref_cfg, ref_corpus, key, sweeps, block=block)

    # gibbs.run: split once for the init, then one key per sweep.
    key, sub = jax.random.split(key)
    init = ref_codec.encode_state(ref_cfg, ref_init(ref_cfg, ref_corpus, sub))
    n, k = ref_corpus.num_tokens, ref_cfg.num_topics
    noise = [torch.as_tensor(_reference_block_noise(kk, n, block, k))
             for kk in jax.random.split(key, sweeps)]
    fields = {f: getattr(ref_cfg, f) for f in
              ("num_topics", "vocab_size", "num_docs", "alpha", "beta", "w_bits")}
    cfg, corpus, state = types.from_reference(
        fields, {f: np.asarray(getattr(ref_corpus, f)) for f in ("docs", "words", "weights")},
        {f: np.asarray(getattr(init, f)) for f in ("z", "n_dt", "n_wt", "n_t")}, device="cpu")
    got = gibbs.run(cfg, corpus, None, sweeps, state=state, block=block, noise=noise)
    np.testing.assert_array_equal(got.z.numpy(), np.asarray(want.z))
    np.testing.assert_array_equal(got.n_wt.numpy(), np.asarray(want.n_wt))
    np.testing.assert_allclose(perplexity.perplexity(cfg, got, corpus),
                               ref_perplexity.perplexity(ref_cfg, want, ref_corpus), rtol=1e-5)
