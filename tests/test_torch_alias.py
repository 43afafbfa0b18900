"""The port's AliasLDA core (`repro_torch.core.alias`) vs the JAX reference.

Both sides take the same numpy inputs, made from a seed.

Tolerances, and why:
  * alias tables are held to the distribution they encode, never entry by
    entry: PyTorch's and XLA's float32 `cumsum` round differently, so a
    threshold may move in its last bits and, where two heavy buckets nearly
    tie, a threshold and its alias may both change while encoding the same
    mass. Reconstructions agree within 2e-5 at K <= 128. At K = 1000 a
    single bucket's threshold can be off by up to 1 in either
    implementation (the float32 prefix sums lose the drained-donor chain's
    last bits), which moves one topic's mass by up to 1/K = 1e-3;
  * given the reference's draws and tables, the port's sweep equals the
    reference's on `z` except at accept near-ties (|log u - log a| below
    1e-5, where XLA's and PyTorch's `log` may differ by an ulp); rebuilt
    counts are then exact at `w_bits` 8 and within 1e-6 in float32;
  * with tables the port builds itself, a token may also flip where the
    bucket-vs-alias uniform sits within 1e-5 of the threshold, or where its
    proposal reads an entry that a differently closed near-tie changed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api.backends import get_backend as ref_get_backend  # noqa: E402
from repro.core import alias as ref_alias  # noqa: E402
from repro.core import codec as ref_codec  # noqa: E402
from repro.core import types as ref_types  # noqa: E402
from repro.kernels.alias_mh import ops as ref_ops  # noqa: E402
from repro_torch.api.backends import get_backend  # noqa: E402
from repro_torch.core import alias, codec, types  # noqa: E402
from repro_torch.kernels.alias_mh import ops  # noqa: E402

NEAR_TIE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _reconstruction(thresh, al):
    """Row-wise p[t] = (thresh[t] + Σ_{j: alias[j]==t} (1 - thresh[j])) / K."""
    thresh = np.atleast_2d(np.asarray(thresh, np.float64))
    al = np.atleast_2d(np.asarray(al))
    rows, k = thresh.shape
    recon = thresh.copy()
    for j in range(k):
        np.add.at(recon, (np.arange(rows), al[:, j]), 1.0 - thresh[:, j])
    return recon / k


# -- the table build (ports of tests/test_gibbs.py's alias-table tests) ------


@pytest.mark.parametrize("k", [2, 3, 8, 33, 64])
def test_alias_table_is_exact_distribution(k):
    p = np.random.default_rng(k).dirichlet(np.full(k, 0.4))
    thresh, al = alias.build_alias_tables(torch.tensor(p, dtype=torch.float32))
    assert thresh.dtype == torch.float32 and al.dtype == torch.int32
    np.testing.assert_allclose(_reconstruction(thresh, al)[0], p, atol=2e-5)


_RNG = np.random.default_rng(1)
DEGENERATE = {
    "drain_chain": np.r_[1e-7, np.full(63, (1 - 1e-7) / 63)],
    "one_hot": np.eye(16)[3],
    "zero_entries": np.r_[np.zeros(12), _RNG.dirichlet(np.full(4, 0.3))],
    "uniform": np.full(32, 1 / 32),
    "two_buckets": np.array([0.999, 0.001]),
    "large_sparse_k": _RNG.dirichlet(np.full(256, 0.05)),
}


@pytest.mark.parametrize("case", sorted(DEGENERATE))
def test_alias_table_exact_on_degenerate_rows(case):
    p = DEGENERATE[case]
    thresh, al = alias.build_alias_tables(torch.tensor(p, dtype=torch.float32))
    t = thresh.numpy()
    assert ((t >= 0.0) & (t <= 1.0)).all()
    np.testing.assert_allclose(_reconstruction(thresh, al)[0], p / p.sum(), atol=2e-5)
    zero = np.flatnonzero(p == 0.0)  # zero-probability topics are unreachable
    if zero.size:
        np.testing.assert_allclose(t[zero], 0.0, atol=1e-7)


def test_alias_table_zero_row_uniform_fallback():
    thresh, al = alias.build_alias_tables(torch.zeros(16))
    np.testing.assert_allclose(thresh.numpy(), 1.0)
    np.testing.assert_allclose(_reconstruction(thresh, al)[0], np.full(16, 1 / 16), atol=1e-7)


def test_alias_tables_batched_matches_per_row():
    rng = np.random.default_rng(2)
    probs = rng.dirichlet(np.full(24, 0.2), size=40).astype(np.float32)
    probs[7] = 0.0
    thresh, al = alias.build_alias_tables(torch.tensor(probs))
    assert thresh.shape == al.shape == (40, 24)
    for i in (0, 7, 13, 39):
        t_i, a_i = alias.build_alias_tables(torch.tensor(probs[i]))
        assert torch.equal(thresh[i], t_i) and torch.equal(al[i], a_i)
    # Leading batch dimensions are kept.
    t3, a3 = alias.build_alias_tables(torch.tensor(probs).reshape(4, 10, 24))
    assert torch.equal(t3.reshape(40, 24), thresh) and torch.equal(a3.reshape(40, 24), al)


@pytest.mark.parametrize("k,tol", [(12, 2e-5), (128, 2e-5), (1000, 1e-3)])
def test_tables_reconstruct_the_reference_distribution(k, tol):
    rng = np.random.default_rng(k)
    probs = rng.gamma(0.3, 2.0, (400 if k < 1000 else 150, k)).astype(np.float32)
    probs[5] = 0.0  # an unseen word: uniform fallback on both sides
    thresh, al = alias.build_alias_tables(torch.tensor(probs))
    ref_thresh, ref_al = ref_alias.build_alias_tables(jnp.asarray(probs))
    mine, ref = _reconstruction(thresh, al), _reconstruction(ref_thresh, ref_al)
    assert np.abs(mine - ref).max() <= tol
    target = probs / np.where(probs.sum(1, keepdims=True) > 0, probs.sum(1, keepdims=True), 1)
    target[5] = 1.0 / k
    assert np.abs(mine - target).max() <= tol
    assert ((thresh >= 0) & (thresh <= 1)).all()
    assert int(al.min()) >= 0 and int(al.max()) < k


# -- the sweep ---------------------------------------------------------------


def _models(w_bits, seed=0, n=3000, d=40, v=150, k=12):
    """The same model on both sides: (ref cfg, corpus, stored state) and
    (port cfg, corpus, stored state), from numpy arrays."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, d, n).astype(np.int32)
    words = rng.integers(0, v, n).astype(np.int32)
    weights = (rng.random(n) * (rng.random(n) > 0.05)).astype(np.float32)
    fields = dict(num_topics=k, vocab_size=v, num_docs=d, alpha=0.1, beta=0.01, w_bits=w_bits)
    ref_cfg = ref_types.LDAConfig(**fields)
    ref_corpus = ref_types.Corpus(jnp.asarray(docs), jnp.asarray(words), jnp.asarray(weights))
    ref_state = ref_codec.rebuild_state(
        ref_cfg, ref_corpus, jnp.asarray(rng.integers(0, k, n).astype(np.int32)))
    port = types.from_reference(
        fields, {"docs": docs, "words": words, "weights": weights},
        {f: np.asarray(getattr(ref_state, f)) for f in ("z", "n_dt", "n_wt", "n_t")},
        device="cpu")
    return (ref_cfg, ref_corpus, ref_state), port


def _reference_sweep(ref_cfg, ref_corpus, ref_state, key, mh_steps):
    """The reference sweep, its draws and its tables (as tensors)."""
    real = ref_codec.decode_state(ref_cfg, ref_state)
    want = ref_codec.encode_state(
        ref_cfg, ref_alias.mh_sweep(ref_cfg, real, ref_corpus, key, mh_steps))
    n, k = ref_corpus.num_tokens, ref_cfg.num_topics
    draws = tuple(torch.tensor(np.asarray(x)) for x in ref_ops._draws(key, n, k, mh_steps))
    tw, aw = ref_alias.build_alias_tables(real.n_wt + ref_cfg.beta)
    td, ad = ref_alias.build_alias_tables(real.n_dt + ref_cfg.alpha)
    tables = tuple(torch.tensor(np.asarray(x)) for x in (tw, aw, td, ad))
    return want, draws, tables


def _flagged(cfg, corpus, state, draws, tables):
    """Tokens whose smallest accept or proposal margin is a near-tie."""
    acc, prop = ops.margins(corpus.docs, corpus.words, state.z, corpus.weights,
                            state.n_dt, state.n_wt, state.n_t, *tables, *draws,
                            alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar,
                            w_bits=codec.codec_for(cfg).spec.w_bits)
    return ((acc < NEAR_TIE) | (prop < NEAR_TIE)).numpy()


def _assert_counts_match_rebuild(ref_cfg, ref_corpus, got, w_bits):
    ref_rebuilt = ref_codec.rebuild_state(ref_cfg, ref_corpus, jnp.asarray(got.z.numpy()))
    for f in ("n_dt", "n_wt", "n_t"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(ref_rebuilt, f))
        if w_bits is None:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("mh_steps", [2, 4])
@pytest.mark.parametrize("w_bits", [None, 8])
def test_mh_sweep_replays_reference_draws_and_tables(w_bits, mh_steps):
    (ref_cfg, ref_corpus, ref_state), (cfg, corpus, state) = _models(w_bits, seed=mh_steps)
    want, draws, tables = _reference_sweep(ref_cfg, ref_corpus, ref_state,
                                           jax.random.PRNGKey(7), mh_steps)
    got = codec.encode_state(cfg, alias.mh_sweep(cfg, codec.decode_state(cfg, state), corpus,
                                                 None, mh_steps, draws=draws, tables=tables))
    diff = np.flatnonzero(got.z.numpy() != np.asarray(want.z))
    acc, _ = ops.margins(corpus.docs, corpus.words, state.z, corpus.weights, state.n_dt,
                         state.n_wt, state.n_t, *tables, *draws, alpha=cfg.alpha,
                         beta=cfg.beta, beta_bar=cfg.beta_bar,
                         w_bits=codec.codec_for(cfg).spec.w_bits)
    assert all(float(acc[i]) < NEAR_TIE for i in diff), diff[:10]
    _assert_counts_match_rebuild(ref_cfg, ref_corpus, got, w_bits)
    if diff.size == 0:  # then the counts equal the reference's own
        for f in ("n_dt", "n_wt", "n_t"):
            g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            if w_bits is None:
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=f)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f)


def _reads_a_different_entry(corpus, draws, tables, ref_tables):
    """Tokens whose proposal in some round reads a table entry where the
    port's and the reference's tables differ: an alias, or a threshold by
    more than NEAR_TIE (a near-tie between heavy buckets closes differently;
    both tables still encode the same distribution)."""
    j_prop = draws[0].long()
    hit = torch.zeros(corpus.num_tokens, dtype=torch.bool)
    for s in range(j_prop.shape[0]):
        rows = (corpus.words if s % 2 == 0 else corpus.docs).long()
        th, al, ref_th, ref_al = (t[rows, j_prop[s]] for t in (
            tables[2 * (s % 2)], tables[2 * (s % 2) + 1],
            ref_tables[2 * (s % 2)], ref_tables[2 * (s % 2) + 1]))
        hit |= (al != ref_al) | ((th - ref_th).abs() > NEAR_TIE)
    return hit.numpy()


@pytest.mark.parametrize("w_bits", [None, 8])
def test_mh_sweep_with_port_tables_differs_only_at_near_ties(w_bits):
    (ref_cfg, ref_corpus, ref_state), (cfg, corpus, state) = _models(w_bits, seed=9)
    want, draws, ref_tables = _reference_sweep(ref_cfg, ref_corpus, ref_state,
                                               jax.random.PRNGKey(3), 4)
    real = codec.decode_state(cfg, state)
    tables = alias.sweep_tables(cfg, real.n_dt, real.n_wt)
    got = codec.encode_state(cfg, alias.mh_sweep(cfg, real, corpus, None, 4, draws=draws))
    diff = np.flatnonzero(got.z.numpy() != np.asarray(want.z))
    other_entry = _reads_a_different_entry(corpus, draws, tables, ref_tables)
    exempt = _flagged(cfg, corpus, state, draws, tables) | other_entry
    assert exempt[diff].all(), diff[~exempt[diff]][:10]
    assert other_entry.mean() < 0.02
    _assert_counts_match_rebuild(ref_cfg, ref_corpus, got, w_bits)


def test_sweep_moves_assignments_and_keeps_frozen_tokens():
    """The reference's dead-proposal regression: a sweep must move topics."""
    _, (cfg, corpus, state) = _models(8, seed=5)
    gen = torch.Generator().manual_seed(0)
    out = codec.encode_state(cfg, alias.mh_sweep(cfg, codec.decode_state(cfg, state),
                                                 corpus, gen, 4))
    live = corpus.weights > 0
    assert int((out.z != state.z)[live].sum()) > 0.2 * int(live.sum())
    assert torch.equal(out.z[~live], state.z[~live])


def test_backend_sweep_matches_the_real_unit_oracle():
    """The `alias` backend (the kernel sweep on stored fixed-point counts,
    its plain version on CPU tensors) gives the chain of the eager oracle
    run on the decoded counts from the same generator: the in-kernel
    scaling by 2^-(w_bits+1) is the codec's decode."""
    _, (cfg, corpus, state) = _models(8, seed=6)
    backend = get_backend("alias")
    assert backend.mh_steps == 4
    got = backend.run(cfg, corpus, torch.Generator().manual_seed(4), 3, state=state)
    gen = torch.Generator().manual_seed(4)
    want = state
    for _ in range(3):
        want = codec.encode_state(cfg, alias.mh_sweep(cfg, codec.decode_state(cfg, want),
                                                      corpus, gen, 4))
    for f in ("z", "n_dt", "n_wt", "n_t"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("w_bits", [None, 8])
def test_ops_mh_sweep_matches_reference_kernel_sweep(w_bits):
    """The port's kernel-path sweep against the reference's fused sweep
    (Pallas kernel in interpret mode) from the same key's draws."""
    (ref_cfg, ref_corpus, ref_state), (cfg, corpus, state) = _models(w_bits, seed=11, n=1500)
    key = jax.random.PRNGKey(2)
    want = ref_ops.mh_sweep(ref_cfg, ref_state, ref_corpus, key, 4)
    _, draws, tables = _reference_sweep(ref_cfg, ref_corpus, ref_state, key, 4)
    got = ops.mh_sweep(cfg, state, corpus, None, 4, draws=draws, tables=tables)
    diff = np.flatnonzero(got.z.numpy() != np.asarray(want.z))
    assert _flagged(cfg, corpus, state, draws, tables)[diff].all()
    _assert_counts_match_rebuild(ref_cfg, ref_corpus, got, w_bits)


def test_reference_backend_fit_and_port_backend_fit_land_together():
    """Same model, each package's alias backend from its own stream: after
    20 sweeps both chains sit at a similar training perplexity."""
    from repro.core import perplexity as ref_perplexity
    from repro_torch.core import perplexity

    (ref_cfg, ref_corpus, ref_state), (cfg, corpus, state) = _models(8, seed=13, n=2000)
    ref_out = ref_get_backend("alias").run(ref_cfg, ref_corpus, jax.random.PRNGKey(1), 20,
                                           state=ref_state)
    out = get_backend("alias").run(cfg, corpus, torch.Generator().manual_seed(1), 20,
                                   state=state)
    p_ref = ref_perplexity.perplexity(ref_cfg, ref_out, ref_corpus)
    p = perplexity.perplexity(cfg, out, corpus)
    assert abs(np.log(p) - np.log(p_ref)) < 0.1, (p, p_ref)
