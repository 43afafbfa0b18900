"""The port's SparseLDA phone sampler (`repro_torch.core.sparse`) and its
`sparse` backend vs the JAX package, on the CPU at small sizes.

What is held, and how:
  * `SparseLDASampler` and `DenseGibbsSampler` are numpy in both packages
    and draw from `np.random.default_rng(seed)`: from the same seed and
    inputs (fractional weights, with and without supplied counts carrying
    extra frozen mass) three sweeps give the same `z` and the same float64
    counts, exactly;
  * the `sparse` backend speaks stored state: at `w_bits` 8 it emits int32
    fixed point that survives an encode(decode(.)) round trip, and on both
    fixed-point and float states its counts are the rebuild of its own `z`
    and decode to the corpus's weight total;
  * the backend is the class run with the seed it derives from the
    caller's generator (one `torch.randint` draw): the reference's class
    from that seed gives the same `z`, and the reference's rebuild of it
    the same stored counts;
  * its capabilities and the `device_kind="phone"` route equal the
    reference's, and it serves fit + update + view through the port's
    service.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.api as ref_api  # noqa: E402
from repro.core import codec as ref_codec  # noqa: E402
from repro.core import sparse as ref_sparse  # noqa: E402
from repro.core import types as ref_types  # noqa: E402
from repro_torch.api import VedaliaService, backends  # noqa: E402
from repro_torch.core import codec, rlda, sparse, types  # noqa: E402
from repro_torch.data import reviews  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed=0, n=300, d=12, v=50, k=6):
    """Random token arrays with fractional weights (a tenth of them 0: the
    frozen tokens of an incremental update) and a random start."""
    rng = np.random.default_rng(seed)
    docs = np.sort(rng.integers(0, d, n)).astype(np.int32)
    words = rng.integers(0, v, n).astype(np.int32)
    weights = rng.uniform(0.2, 1.5, n).astype(np.float32)
    weights[rng.random(n) < 0.1] = 0.0
    z = rng.integers(0, k, n).astype(np.int32)
    return dict(num_topics=k, vocab_size=v, num_docs=d), docs, words, weights, z, rng


def _counts(dims, docs, words, weights, z, rng):
    """Counts of (z, weights) plus extra mass, as a stored state whose
    frozen tokens still count: float64 (D, K), (V, K), (K,)."""
    d, v, k = dims["num_docs"], dims["vocab_size"], dims["num_topics"]
    n_dt, n_wt, n_t = np.zeros((d, k)), np.zeros((v, k)), np.zeros(k)
    np.add.at(n_dt, (docs, z), weights)
    np.add.at(n_wt, (words, z), weights)
    np.add.at(n_t, z, weights)
    extra_d = rng.integers(0, 3, (d, k)).astype(np.float64)
    extra_w = np.zeros((v, k))
    np.add.at(extra_w, (rng.integers(0, v, d * k), np.tile(np.arange(k), d)), extra_d.ravel())
    return n_dt + extra_d, n_wt + extra_w, n_t + extra_d.sum(0)


@pytest.mark.parametrize("with_counts", [False, True], ids=["rebuilt", "supplied"])
@pytest.mark.parametrize("name", ["SparseLDASampler", "DenseGibbsSampler"])
def test_sampler_classes_equal_the_reference(name, with_counts):
    dims, docs, words, weights, z, rng = _inputs(seed=3)
    counts = _counts(dims, docs, words, weights, z, rng) if with_counts else None
    port = getattr(sparse, name)(types.LDAConfig(**dims), docs, words, z,
                                 weights=weights, seed=11, counts=counts)
    ref = getattr(ref_sparse, name)(ref_types.LDAConfig(**dims), docs, words, z,
                                    weights=weights, seed=11, counts=counts)
    port.run(3)
    ref.run(3)
    assert (port.z != z).any()  # the chain moved
    np.testing.assert_array_equal(port.z, ref.z)
    for field in ("n_dt", "n_wt", "n_t"):
        np.testing.assert_array_equal(getattr(port, field), getattr(ref, field))
    assert port.s == ref.s
    assert port.rng.bit_generator.state == ref.rng.bit_generator.state


def _prepared(w_bits, seed=0):
    revs = reviews.generate(reviews.SyntheticSpec(
        num_reviews=30, vocab_size=120, num_topics=4, mean_tokens=25, seed=seed)).reviews
    return rlda.prepare(revs, base_vocab=120, num_topics=4, w_bits=w_bits, device="cpu")


@pytest.mark.parametrize("w_bits", [8, None], ids=["w_bits8", "float"])
def test_sparse_backend_invariants(w_bits):
    prep = _prepared(w_bits)
    cfg, corpus = prep.cfg, prep.corpus
    st = backends.get_backend("sparse").run(cfg, corpus, torch.Generator().manual_seed(3), 2)
    want = torch.int32 if w_bits is not None else torch.float32
    assert st.n_dt.dtype == st.n_wt.dtype == st.n_t.dtype == want
    assert st.z.dtype == torch.int32 and st.z.device == corpus.device
    assert int(st.z.min()) >= 0 and int(st.z.max()) < cfg.num_topics
    # Counts are the rebuild of the state's own assignments.
    rebuilt = codec.rebuild_state(cfg, corpus, st.z)
    for field in ("n_dt", "n_wt", "n_t"):
        torch.testing.assert_close(getattr(st, field), getattr(rebuilt, field),
                                   rtol=0, atol=0)
    # Stored state survives a decode/encode round trip ...
    st2 = codec.encode_state(cfg, codec.decode_state(cfg, st))
    for field in ("n_dt", "n_wt", "n_t"):
        assert torch.equal(getattr(st, field), getattr(st2, field))
    # ... and decodes to the weight total the corpus carries.
    _, n_wt, _ = codec.decode_counts(cfg, st)
    tol = corpus.num_tokens * 2.0 ** -9
    assert abs(float(n_wt.sum()) - float(corpus.weights.sum())) <= tol
    # A warm sweep continues from the given state.
    st3 = backends.get_backend("sparse").sweep(cfg, st, corpus, torch.Generator().manual_seed(4))
    assert st3.z.shape == st.z.shape and not torch.equal(st3.z, st.z)


@pytest.mark.parametrize("w_bits", [8, None], ids=["w_bits8", "float"])
@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_backend_is_the_class_run_with_its_derived_seed(dense, w_bits):
    """The port's backend on a stored state = the reference's class from the
    seed the backend derives (one `torch.randint` draw of the generator) on
    the reference's decoded counts; the stored state it returns = the
    reference's rebuild of that `z`."""
    prep = _prepared(w_bits, seed=1)
    cfg, corpus = prep.cfg, prep.corpus
    start = backends.get_backend("torch").run(cfg, corpus, torch.Generator().manual_seed(0), 2)
    gen = torch.Generator().manual_seed(9)
    twin = torch.Generator().manual_seed(9)
    got = backends.get_backend("sparse", dense=dense).run(cfg, corpus, gen, 3, state=start)
    seed = int(torch.randint(0, np.iinfo(np.int32).max, (1,), generator=twin))

    ref_cfg = ref_types.LDAConfig(**{f: getattr(cfg, f) for f in (
        "num_topics", "vocab_size", "num_docs", "alpha", "beta", "w_bits")})
    ref_corpus = ref_types.Corpus(*(jnp.asarray(codec.as_numpy(t)) for t in (
        corpus.docs, corpus.words, corpus.weights)))
    ref_state = ref_types.LDAState(*(jnp.asarray(codec.as_numpy(t)) for t in (
        start.z, start.n_dt, start.n_wt, start.n_t)))
    cls = ref_sparse.DenseGibbsSampler if dense else ref_sparse.SparseLDASampler
    ref = cls(ref_cfg, np.asarray(ref_corpus.docs), np.asarray(ref_corpus.words),
              np.asarray(ref_state.z), weights=np.asarray(ref_corpus.weights, np.float64),
              seed=seed, counts=ref_codec.decode_counts_np(ref_cfg, ref_state))
    ref.run(3)
    np.testing.assert_array_equal(codec.as_numpy(got.z), ref.z)
    want = ref_codec.rebuild_state(ref_cfg, ref_corpus, jnp.asarray(ref.z, jnp.int32))
    for field in ("n_dt", "n_wt", "n_t"):
        a, b = codec.as_numpy(getattr(got, field)), np.asarray(getattr(want, field))
        if w_bits is None:  # float32 sums: XLA's scatter adds in its own order
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5)
        else:
            np.testing.assert_array_equal(a, b)


def test_decode_counts_np_equals_the_reference():
    prep = _prepared(8, seed=2)
    st = backends.get_backend("torch").run(prep.cfg, prep.corpus,
                                           torch.Generator().manual_seed(1), 1)
    ref_cfg = ref_types.LDAConfig(num_topics=prep.cfg.num_topics,
                                  vocab_size=prep.cfg.vocab_size,
                                  num_docs=prep.cfg.num_docs, w_bits=8)
    ref_state = ref_types.LDAState(*(jnp.asarray(codec.as_numpy(t)) for t in (
        st.z, st.n_dt, st.n_wt, st.n_t)))
    for a, b in zip(codec.decode_counts_np(prep.cfg, st),
                    ref_codec.decode_counts_np(ref_cfg, ref_state)):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)


def test_capabilities_and_phone_route_equal_the_reference():
    assert "sparse" in backends.available_backends()
    assert backends.backend_capabilities("sparse").to_dict() \
        == ref_api.backend_capabilities("sparse").to_dict()
    for kw in (dict(device_kind="phone"), dict(device_kind="phone", num_models=4)):
        assert backends.select_backend(**kw) == ref_api.select_backend(**kw) == "sparse"
    assert type(backends.get_backend("sparse")).__name__ == "SparseSampler"
    assert backends.get_backend("sparse", dense=True).dense


def test_sparse_backend_serves_through_the_service():
    """The phone path end to end (the reference's
    `test_sparse_backend_serves_through_service`), plus `auto` with
    `device_kind="phone"`."""
    svc = VedaliaService(device="cpu", backend="sparse", num_sweeps=5, update_sweeps=1)
    revs = reviews.generate(reviews.SyntheticSpec(
        num_reviews=25, vocab_size=120, num_topics=4, mean_tokens=25, seed=0)).reviews
    handle = svc.fit(revs[:20], num_topics=4, base_vocab=120, w_bits=8)
    assert handle.backend == "sparse"
    resp = svc.update(handle, revs[20:])
    assert np.isfinite(resp.perplexity)
    assert svc.view(handle).valid
    phone = VedaliaService(device="cpu", backend="auto", num_sweeps=2).fit(
        revs[:15], num_topics=4, base_vocab=120, device_kind="phone")
    assert phone.backend == "sparse"
