"""Port state layer vs the JAX reference: fixed point, counts, codec, carry.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: fixed-point results are exact; float32 count rebuilds are held
to rtol 1e-6 (a scatter-add may sum in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import codec as ref_codec  # noqa: E402
from repro.core import fractional as ref_fractional  # noqa: E402
from repro.core import quant as ref_quant  # noqa: E402
from repro.core import types as ref_types  # noqa: E402
from repro_torch.core import codec, fractional, quant, types  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small tensors: a thread pool costs more than it gains.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _corpus_np(seed=0, n=3000, d=40, v=150):
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, d, n).astype(np.int32)
    words = rng.integers(0, v, n).astype(np.int32)
    weights = rng.uniform(0.0, 1.5, n).astype(np.float32)
    weights[rng.random(n) < 0.05] = 0.0
    return docs, words, weights


@pytest.mark.parametrize("w_bits", [2, 8, 12])
def test_to_fixed_from_fixed_match_reference_with_ties(w_bits):
    s = 1 << (w_bits + 1)
    rng = np.random.default_rng(w_bits)
    x = rng.uniform(-3, 40, 500).astype(np.float32)
    # Exact .5 ties in fixed units: round half to even on both sides.
    ties = (np.arange(-6, 50) + 0.5).astype(np.float32) / s
    x = np.concatenate([x, ties, np.float32([0.0, 1.0 / s, 0.5 / s])])
    want = np.asarray(ref_fractional.to_fixed(jnp.asarray(x), w_bits))
    got = fractional.to_fixed(torch.as_tensor(x), w_bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    back_ref = np.asarray(ref_fractional.from_fixed(jnp.asarray(want), w_bits))
    back = fractional.from_fixed(got, w_bits)
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(), back_ref)
    assert fractional.flush_threshold(w_bits) == ref_fractional.flush_threshold(w_bits)
    assert fractional.precision(w_bits) == ref_fractional.precision(w_bits)


@pytest.mark.parametrize("w_bits", [None, 8])
def test_build_counts_matches_reference(w_bits):
    docs, words, weights = _corpus_np(seed=1)
    k = 7
    z = np.random.default_rng(2).integers(0, k, len(docs)).astype(np.int32)
    fields = dict(num_topics=k, vocab_size=150, num_docs=40, alpha=0.1, beta=0.01,
                  w_bits=w_bits)
    ref_cfg = ref_types.LDAConfig(**fields)
    ref_corpus = ref_types.Corpus(jnp.asarray(docs), jnp.asarray(words), jnp.asarray(weights))
    want = ref_codec.rebuild_state(ref_cfg, ref_corpus, jnp.asarray(z))

    cfg = types.LDAConfig(**fields)
    corpus = types.corpus_from_numpy(docs, words, weights, device="cpu")
    got = codec.rebuild_state(cfg, corpus, torch.as_tensor(z))
    for name in ("n_dt", "n_wt", "n_t"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        if w_bits is None:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got.z.numpy(), z)


@pytest.mark.parametrize("w_bits", [None, 8])
def test_state_codec_round_trips(w_bits):
    docs, words, weights = _corpus_np(seed=3)
    cfg = types.LDAConfig(num_topics=5, vocab_size=150, num_docs=40, w_bits=w_bits)
    corpus = types.corpus_from_numpy(docs, words, weights, device="cpu")
    gen = torch.Generator().manual_seed(0)
    real = types.init_state(cfg, corpus, gen)
    sc = codec.codec_for(cfg)
    stored = sc.encode_state(real)
    decoded = sc.decode_state(stored)
    tol = 0.0 if w_bits is None else 0.5 / fractional.scale(w_bits)
    for name in ("n_dt", "n_wt", "n_t"):
        diff = (getattr(decoded, name) - getattr(real, name)).abs().max()
        assert float(diff) <= tol + 1e-6, name
        np.testing.assert_allclose(
            sc.decode_array_np(getattr(stored, name)),
            np.asarray(ref_codec.codec_for(ref_types.LDAConfig(
                num_topics=5, vocab_size=150, num_docs=40, w_bits=w_bits)).decode_array_np(
                    getattr(stored, name).numpy())),
            rtol=0, atol=0, err_msg=name)
    # Re-encoding decoded stored counts is the identity.
    again = sc.encode_state(sc.decode_state(stored))
    for name in ("n_dt", "n_wt", "n_t"):
        assert torch.equal(getattr(again, name), getattr(stored, name)), name


@pytest.mark.parametrize("mode", ["int8", "int4_packed"])
def test_packed_tables_match_reference(mode):
    x = np.random.default_rng(4).gamma(1.0, 3.0, (33, 13)).astype(np.float32)
    x[5] = 0.0
    spec, ref_spec = quant.QuantSpec(mode=mode), ref_quant.QuantSpec(mode=mode)
    codes, scales = codec.StateCodec(spec).pack_table(torch.as_tensor(x))
    ref_codes, ref_scales = ref_codec.StateCodec(ref_spec).pack_table(x)
    np.testing.assert_array_equal(codes, ref_codes)
    np.testing.assert_array_equal(scales, ref_scales)
    np.testing.assert_array_equal(
        codec.StateCodec(spec).unpack_table(codes, scales, 13),
        ref_codec.StateCodec(ref_spec).unpack_table(ref_codes, ref_scales, 13))


def test_quant_spec_matches_reference():
    for spec in (quant.QuantSpec.f32(), quant.QuantSpec.fixed(8), quant.QuantSpec.int8(),
                 quant.QuantSpec.int4(6)):
        ref = ref_quant.QuantSpec(mode=spec.mode, w_bits=spec.w_bits)
        assert (spec.live_mode, spec.live_fixed, spec.packed) == \
            (ref.live_mode, ref.live_fixed, ref.packed)
        assert hash(spec) == hash(quant.QuantSpec(spec.mode, spec.w_bits))
    assert quant.MODES == ref_quant.MODES
    with pytest.raises(ValueError):
        quant.QuantSpec(mode="fixed")
    cfg = types.LDAConfig(num_topics=3, vocab_size=4, num_docs=2, w_bits=6)
    assert quant.spec_for(cfg) == quant.QuantSpec.fixed(6)


@pytest.mark.parametrize("w_bits", [None, 8])
def test_from_reference_then_to_numpy_is_identity(w_bits):
    docs, words, weights = _corpus_np(seed=5)
    fields = dict(num_topics=6, vocab_size=150, num_docs=40, alpha=0.2, beta=0.05,
                  w_bits=w_bits)
    ref_cfg = ref_types.LDAConfig(**fields)
    ref_corpus = ref_types.Corpus(jnp.asarray(docs), jnp.asarray(words), jnp.asarray(weights))
    z = np.random.default_rng(6).integers(0, 6, len(docs)).astype(np.int32)
    ref_state = ref_codec.rebuild_state(ref_cfg, ref_corpus, jnp.asarray(z))
    state_np = {f: np.asarray(getattr(ref_state, f)) for f in ("z", "n_dt", "n_wt", "n_t")}
    corpus_np = {"docs": docs, "words": words, "weights": weights}

    cfg, corpus, state = types.from_reference(fields, corpus_np, state_np, device="cpu")
    assert cfg == types.LDAConfig(**fields)
    assert state.n_wt.dtype == (torch.float32 if w_bits is None else torch.int32)
    assert state.z.dtype == corpus.docs.dtype == torch.int32
    cfg_back, corpus_back, state_back = types.to_numpy(cfg, corpus, state)
    assert ref_types.LDAConfig(**cfg_back) == ref_cfg
    for f, a in corpus_np.items():
        assert corpus_back[f].dtype == a.dtype
        np.testing.assert_array_equal(corpus_back[f], a)
    for f, a in state_np.items():
        assert state_back[f].dtype == a.dtype
        np.testing.assert_array_equal(state_back[f], a)


def test_init_state_is_consistent_and_seeded():
    docs, words, weights = _corpus_np(seed=7)
    cfg = types.LDAConfig(num_topics=9, vocab_size=150, num_docs=40)
    corpus = types.corpus_from_numpy(docs, words, weights, device="cpu")
    a = types.init_state(cfg, corpus, torch.Generator().manual_seed(3))
    b = types.init_state(cfg, corpus, torch.Generator().manual_seed(3))
    assert torch.equal(a.z, b.z) and a.z.dtype == torch.int32
    assert int(a.z.min()) >= 0 and int(a.z.max()) < 9
    np.testing.assert_allclose(float(a.n_t.sum()), float(weights.sum()), rtol=1e-5)
    np.testing.assert_allclose(a.n_dt.sum(0).numpy(), a.n_t.numpy(), rtol=1e-5, atol=1e-4)
