"""The packed-table (int8 / int4) sweeps of the port vs the JAX reference.

Covers the tensor twins of the kernel-feed quantization helpers
(`core.quant.quantize_rows_torch`, `pack_nibbles_torch`,
`unpack_nibbles_torch`, `fake_quantize_rows`), the packed-table resample
(`kernels.lda_gibbs.ops.resample_quant_plain`, the plain version of the
`lda_gibbs_resample_quant` CUDA entry), and the packed branches of the
`cuda` sweep (`lda_gibbs.ops.sweep_resample`) and the `alias` sweep
(`alias_mh.ops.mh_sweep`). The reference side runs as its own tests run it
on the CPU: the Pallas kernel `gibbs_resample_blocked_quant` and the packed
`sweep_resample` / `mh_resample` in interpret mode. Inputs are made with
numpy from a seed and handed to both sides.

Tolerances, and why:
  * the quantization twins equal the jnp helpers exactly (same float32
    division, round half to even, clip and nibble order);
  * resampled topics are equal on every token except near-ties, where the
    top-2 margin of score + noise is below 1e-5 (lda_gibbs), or an accept
    margin |log u - log a| is below 1e-5 in some round (alias_mh): XLA's and
    PyTorch's float32 `log` may differ by an ulp there;
  * a packed sweep agrees with the exact sweep from the same noise on more
    than 80% of tokens: the reference's own check of the packed paths.

The CUDA entry itself runs only on the card (`test_torch_cuda.py`); here
the wrapper takes the plain version because the tensors lie on the CPU.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import alias as ref_alias  # noqa: E402
from repro.core import codec as ref_codec  # noqa: E402
from repro.core import quant as ref_quant  # noqa: E402
from repro.core import types as ref_types  # noqa: E402
from repro.kernels.alias_mh import ops as ref_alias_ops  # noqa: E402
from repro.kernels.lda_gibbs import kernel as ref_kernel  # noqa: E402
from repro.kernels.lda_gibbs import ops as ref_ops  # noqa: E402
from repro_torch.api import backends  # noqa: E402
from repro_torch.core import codec, quant, types  # noqa: E402
from repro_torch.core.quant import QuantSpec  # noqa: E402
from repro_torch.kernels.alias_mh import ops as alias_ops  # noqa: E402
from repro_torch.kernels.lda_gibbs import ops  # noqa: E402

NEAR_TIE = 1e-5
HP = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * 300)
SPECS = [QuantSpec.int8, QuantSpec.int4]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _table(rows, k, seed):
    """A non-negative count table with all-zero rows, ties and a negative
    entry (clipped to 0 by both sides)."""
    rng = np.random.default_rng(seed)
    x = rng.gamma(0.5, 3.0, (rows, k)).astype(np.float32)
    x[::7] = 0.0  # all-zero rows: scale 0, exact-zero codes
    x[1::5, 0] = x[1::5].max(axis=1)  # a repeated row maximum
    x[2, -1] = -0.5
    # Entries exactly half a step from a code boundary, so round-half-to-even
    # decides them.
    x[3] = np.arange(k, dtype=np.float32) + 0.5
    return x


# -- the kernel-feed helpers -------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", [1, 7, 12, 33, 128])
def test_quant_twins_equal_jnp_helpers(bits, k):
    x = _table(40, k, seed=k + bits)
    codes, scales = quant.quantize_rows_torch(torch.as_tensor(x), bits)
    want_codes, want_scales = ref_quant.quantize_rows_jnp(jnp.asarray(x), bits)
    assert codes.dtype == torch.uint8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_scales))
    assert (scales.numpy()[::7] == 0).all() and (codes.numpy()[::7] == 0).all()

    if bits == 4:
        packed = quant.pack_nibbles_torch(codes)
        want_packed = ref_quant.pack_nibbles_jnp(want_codes)
        assert packed.shape == (40, (k + 1) // 2) and packed.dtype == torch.uint8
        np.testing.assert_array_equal(packed.numpy(), np.asarray(want_packed))
        np.testing.assert_array_equal(packed.numpy(), ref_quant.pack_nibbles(codes.numpy()))
        unpacked = quant.unpack_nibbles_torch(packed, k)
        np.testing.assert_array_equal(
            unpacked.numpy(), np.asarray(ref_quant.unpack_nibbles_jnp(want_packed, k)))
        np.testing.assert_array_equal(unpacked.numpy(), codes.numpy())

    fq = quant.fake_quantize_rows(torch.as_tensor(x), bits)
    assert isinstance(fq, torch.Tensor)
    np.testing.assert_array_equal(
        fq.numpy(), np.asarray(ref_quant.fake_quantize_rows(jnp.asarray(x), bits)))
    fq_np = quant.fake_quantize_rows(x, bits)
    assert isinstance(fq_np, np.ndarray)
    np.testing.assert_array_equal(fq_np, ref_quant.fake_quantize_rows(x, bits))


def test_quant_twins_take_stacked_tables():
    x = _table(30, 12, seed=3).reshape(3, 10, 12)
    codes, scales = quant.quantize_rows_torch(torch.as_tensor(x), 4)
    want_codes, want_scales = ref_quant.quantize_rows_jnp(jnp.asarray(x), 4)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_scales))
    np.testing.assert_array_equal(quant.pack_nibbles_torch(codes).numpy(),
                                  np.asarray(ref_quant.pack_nibbles_jnp(want_codes)))


# -- the packed-table resample -----------------------------------------------


def _inputs(n, k, w_bits, bits, seed, d=60, v=300):
    """Token ids, assignments, weights (10% zero), stored n_dt / n_t
    (float32, or int32 fixed point), the packed word table made from a
    count table of plausible magnitude, and Gumbel noise."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, d, n).astype(np.int32)
    words = rng.integers(0, v, n).astype(np.int32)
    z = rng.integers(0, k, n).astype(np.int32)
    weights = rng.uniform(0.05, 1.2, n).astype(np.float32)
    weights[rng.random(n) < 0.1] = 0.0
    n_dt = rng.gamma(0.6, 4.0, (d, k)).astype(np.float32)
    n_wt = rng.gamma(0.4, 2.0, (v, k)).astype(np.float32)
    n_wt[::11] = 0.0
    n_t = n_wt.sum(0)
    if w_bits is not None:
        s = 1 << (w_bits + 1)
        n_dt, n_t = (np.round(x * s).astype(np.int32) for x in (n_dt, n_t))
    codes, scales = ref_quant.quantize_rows(n_wt, bits)  # numpy, packed for int4
    noise = rng.gumbel(size=(n, k)).astype(np.float32)
    return docs, words, z, weights, n_dt, codes, scales, n_t, noise


def _torch(arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _assert_same_but_near_ties(got, want, scores, weights):
    """Equal topics except where the top-2 margin is below NEAR_TIE."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.flatnonzero(got != want)
    top2 = np.sort(scores, axis=1)[:, -2:]
    for i in diff:
        assert weights[i] > 0, f"frozen token {i} moved"
        assert top2[i, 1] - top2[i, 0] < NEAR_TIE, \
            f"token {i}: {got[i]} vs {want[i]} with margin {top2[i, 1] - top2[i, 0]}"
    return len(diff)


@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", [12, 33])
def test_plain_quant_matches_pallas_kernel_interpret(k, bits, w_bits):
    n = 700
    arrays = _inputs(n, k, w_bits, bits, seed=10 * k + bits + (w_bits or 0))
    docs, words, z, weights, n_dt, codes, scales, n_t, noise = arrays
    hp = dict(HP, bits=bits, w_bits=w_bits)
    got = ops.resample_quant(*_torch(arrays), **hp)
    assert got.dtype == torch.int32 and got.shape == (n,)

    # The reference kernel takes pre-gathered rows padded as its ops.py pads
    # them: K to 128 lanes (256 for int4, so the packed lane dim stays 128),
    # N to the 256-token block; its n_dt and totals are real-unit float32.
    kp = -(-k // 256) * 256 if bits == 4 else -(-k // 128) * 128
    npad = -(-n // 256) * 256
    s = np.float32(1.0 if w_bits is None else 2.0 ** -(w_bits + 1))

    def pad2(x, fill=0):
        return np.pad(x, ((0, npad - n), (0, kp - x.shape[1])), constant_values=fill)

    def pad1(x):
        return np.pad(x, (0, npad - n))

    code_rows = ref_quant.unpack_nibbles(codes, k) if bits == 4 else codes
    code_rows = pad2(code_rows[words])
    if bits == 4:
        code_rows = ref_quant.pack_nibbles(code_rows)
    want = ref_kernel.gibbs_resample_blocked_quant(
        jnp.asarray(code_rows), jnp.asarray(pad1(scales[words])),
        jnp.asarray(pad2(n_dt[docs].astype(np.float32) * s)),
        jnp.asarray(np.pad(n_t.astype(np.float32) * s, (0, kp - k))),
        jnp.asarray(pad1(z)), jnp.asarray(pad1(weights)), jnp.asarray(pad2(noise, -np.inf)),
        bits=bits, interpret=True, **HP)[:n]
    scores = ops.perturbed_scores_quant(*_torch(arrays), **hp).numpy()
    flips = _assert_same_but_near_ties(got.numpy(), want, scores, weights)
    assert flips <= n // 100
    frozen = weights == 0
    np.testing.assert_array_equal(got.numpy()[frozen], z[frozen])


def test_quant_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    arrays = _torch(_inputs(300, 12, 8, 4, seed=3))
    hp = dict(HP, bits=4, w_bits=8)
    before = ops.resample_quant.launches
    got = ops.resample_quant(*arrays, **hp)
    np.testing.assert_array_equal(got.numpy(), ops.resample_quant_plain(*arrays, **hp).numpy())
    assert ops.resample_quant.launches == before


def test_quant_wrapper_checks_what_the_kernel_takes():
    good = _torch(_inputs(64, 12, 8, 8, seed=4))
    docs, words, z, weights, n_dt, codes, scales, n_t, noise = good
    ops._check_quant(*good, 8, 8)
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        ops._check_quant(*good, 2, 8)
    with pytest.raises(ValueError, match="columns"):
        ops._check_quant(*good, 4, 8)  # int8-wide codes declared as int4
    with pytest.raises(ValueError, match="uint8"):
        ops._check_quant(*good[:5], codes.to(torch.int32), *good[6:], 8, 8)
    with pytest.raises(ValueError, match="scales must be float32"):
        ops._check_quant(*good[:6], scales[:-1].contiguous(), *good[7:], 8, 8)
    with pytest.raises(ValueError, match="must be torch.float32"):
        ops._check_quant(*good, 8, None)  # int32 n_dt needs w_bits
    with pytest.raises(ValueError, match="contiguous"):
        ops._check_quant(*good[:5], codes.t().contiguous().t(), *good[6:], 8, 8)


# -- the packed sweeps -------------------------------------------------------


def _models(spec, seed=0, n=1500, d=40, v=150, k=12):
    """The same packed-spec model on both sides: (ref cfg, corpus, stored
    state) and (port cfg, corpus, stored state), from numpy arrays."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, d, n).astype(np.int32)
    words = rng.integers(0, v, n).astype(np.int32)
    weights = (rng.random(n) * (rng.random(n) > 0.05)).astype(np.float32)
    fields = dict(num_topics=k, vocab_size=v, num_docs=d, alpha=0.1, beta=0.01,
                  w_bits=spec.w_bits)
    ref_cfg = ref_types.LDAConfig(**fields, quant=ref_quant.QuantSpec(spec.mode, spec.w_bits))
    ref_corpus = ref_types.Corpus(jnp.asarray(docs), jnp.asarray(words), jnp.asarray(weights))
    ref_state = ref_codec.rebuild_state(
        ref_cfg, ref_corpus, jnp.asarray(rng.integers(0, k, n).astype(np.int32)))
    cfg, corpus, state = types.from_reference(
        dict(fields, quant=spec.mode), {"docs": docs, "words": words, "weights": weights},
        {f: np.asarray(getattr(ref_state, f)) for f in ("z", "n_dt", "n_wt", "n_t")},
        device="cpu")
    assert cfg.quant_spec == spec
    return (ref_cfg, ref_corpus, ref_state), (cfg, corpus, state)


@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("make_spec", SPECS, ids=["int8", "int4"])
def test_packed_sweep_replays_reference_packed_sweep(make_spec, w_bits):
    spec = make_spec(w_bits=w_bits)
    (ref_cfg, ref_corpus, ref_state), (cfg, corpus, state) = _models(spec, seed=5)
    key = jax.random.PRNGKey(9)
    want = ref_ops.sweep_resample(ref_cfg, ref_state, ref_corpus, key)
    # The reference draws (npad, kp_base) noise whatever the packing, and
    # slices the live block: the port takes the same columns.
    n, k = corpus.num_tokens, cfg.num_topics
    npad = -(-n // 256) * 256
    noise = torch.tensor(np.asarray(jax.random.gumbel(key, (npad, 128), jnp.float32))[:n, :k])
    got = ops.sweep_resample(cfg, state, corpus, None, noise=noise)

    codes, scales = ops.pack_word_table(cfg, state.n_wt)
    scores = ops.perturbed_scores_quant(
        corpus.docs, corpus.words, state.z, corpus.weights, state.n_dt, codes, scales,
        state.n_t, noise, alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar,
        bits=spec.bits, w_bits=w_bits).numpy()
    _assert_same_but_near_ties(got.numpy(), want, scores, corpus.weights.numpy())
    # The packed sweep really scored against the packed table: the exact
    # sweep from the same noise lands some tokens elsewhere.
    exact = ops.sweep_resample(dataclasses.replace(cfg, quant=None), state, corpus, None,
                               noise=noise)
    assert (exact != got).any()


def _reference_packed_tables(ref_cfg, ref_state, bits):
    """The stale tables the reference's packed `mh_resample` builds. They
    are built under `jax.jit`, as that jitted sweep builds them: XLA's
    fused fake-quantization may round the dequantized table an ulp away
    from the eager jnp helper (which the twins above equal exactly), and
    an ulp can move a threshold and its alias."""

    def build(state):
        real = ref_codec.decode_state(ref_cfg, state)
        n_wt_q = ref_quant.fake_quantize_rows(real.n_wt, bits)
        return (*ref_alias.build_alias_tables(n_wt_q + ref_cfg.beta),
                *ref_alias.build_alias_tables(real.n_dt + ref_cfg.alpha))

    return tuple(torch.tensor(np.asarray(x)) for x in jax.jit(build)(ref_state))


@pytest.mark.parametrize("make_spec", SPECS, ids=["int8", "int4"])
def test_packed_mh_sweep_replays_reference_packed_sweep(make_spec):
    spec = make_spec(w_bits=8)
    (ref_cfg, ref_corpus, ref_state), (cfg, corpus, state) = _models(spec, seed=6)
    key, mh_steps = jax.random.PRNGKey(4), 4
    want = ref_alias_ops.mh_resample(ref_cfg, ref_state, ref_corpus, key, mh_steps)
    n, k = corpus.num_tokens, cfg.num_topics
    draws = tuple(torch.tensor(np.asarray(x))
                  for x in ref_alias_ops._draws(key, n, k, mh_steps))
    tables = _reference_packed_tables(ref_cfg, ref_state, spec.bits)
    got = alias_ops.mh_sweep(cfg, state, corpus, None, mh_steps, draws=draws, tables=tables)

    sc = codec.codec_for(cfg)
    n_wt_q = quant.fake_quantize_rows(sc.decode_array(state.n_wt), spec.bits)
    acc, _ = alias_ops.margins(corpus.docs, corpus.words, state.z, corpus.weights,
                               sc.decode_array(state.n_dt), n_wt_q,
                               sc.decode_array(state.n_t), *tables, *draws,
                               alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar)
    diff = np.flatnonzero(got.z.numpy() != np.asarray(want))
    assert all(float(acc[i]) < NEAR_TIE for i in diff), diff[:10]
    # The rebuilt counts are the reference's rebuild of the same z, exactly.
    ref_rebuilt = ref_codec.rebuild_state(ref_cfg, ref_corpus, jnp.asarray(got.z.numpy()))
    for f in ("n_dt", "n_wt", "n_t"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref_rebuilt, f)), err_msg=f)


@pytest.mark.parametrize("name", ["torch", "batched"])
def test_oracle_and_batched_backends_ignore_a_packed_spec(name):
    """`torch` (the reference's `jnp`) and `batched` run the exact path
    whatever `cfg.quant` says, as the reference's oracle and batched sweeps
    do: from one generator seed the packed and exact runs are the same chain."""
    spec = QuantSpec.int8(w_bits=8)
    _, (cfg, corpus, _) = _models(spec, seed=7, n=800)
    exact_cfg = dataclasses.replace(cfg, quant=None)
    sampler = backends.get_backend(name)
    got = sampler.run(cfg, corpus, torch.Generator().manual_seed(3), 2)
    want = sampler.run(exact_cfg, corpus, torch.Generator().manual_seed(3), 2)
    for f in ("z", "n_dt", "n_wt", "n_t"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert backends.backend_capabilities(name).quant_modes == ("f32", "fixed")


@pytest.mark.parametrize("name", ["cuda", "alias"])
def test_packed_backends_advertise_and_honor_packed_modes(name):
    assert backends.backend_capabilities(name).quant_modes == (
        "f32", "fixed", "int8", "int4_packed")
    spec = QuantSpec.int4(w_bits=8)
    _, (cfg, corpus, state) = _models(spec, seed=8, n=800)
    sampler = backends.get_backend(name)
    got = sampler.sweep(cfg, state, corpus, torch.Generator().manual_seed(2))
    want = sampler.sweep(dataclasses.replace(cfg, quant=None), state, corpus,
                         torch.Generator().manual_seed(2))
    assert not torch.equal(got.z, want.z)  # the packed spec changed the sweep
    # Stored units out, counts consistent with z.
    rebuilt = codec.rebuild_state(cfg, corpus, got.z)
    for f in ("n_dt", "n_wt", "n_t"):
        assert torch.equal(getattr(rebuilt, f), getattr(got, f)), f


@pytest.mark.parametrize("make_spec", SPECS, ids=["int8", "int4"])
@pytest.mark.parametrize("path", ["gibbs", "alias"])
def test_packed_sweep_agrees_with_exact_sweep(path, make_spec):
    """The reference's own check of its packed paths
    (`tests/test_quant.py::test_packed_*_kernel_sweep_runs`): from the same
    noise or draws, most tokens land where the exact sweep lands them."""
    spec = make_spec(w_bits=8)
    rng = np.random.default_rng(0)
    n, v, d, k = 1500, 96, 30, 8
    fields = dict(num_topics=k, vocab_size=v, num_docs=d, w_bits=8)
    cfg = types.LDAConfig(**fields)
    cfg_q = types.LDAConfig(**fields, quant=spec)
    corpus = types.corpus_from_numpy(rng.integers(0, d, n).astype(np.int32),
                                     rng.integers(0, v, n).astype(np.int32),
                                     rng.random(n).astype(np.float32), device="cpu")
    state = codec.encode_state(cfg, types.init_state(cfg, corpus,
                                                     torch.Generator().manual_seed(1)))
    if path == "gibbs":
        noise = ops.gumbel((n, k), torch.Generator().manual_seed(2), "cpu")
        z_ref = ops.sweep_resample(cfg, state, corpus, None, noise=noise)
        z_q = ops.sweep_resample(cfg_q, state, corpus, None, noise=noise)
    else:
        from repro_torch.core import alias

        draws = alias.sweep_draws(torch.Generator().manual_seed(2), n, k, 4, "cpu")
        z_ref = alias_ops.mh_sweep(cfg, state, corpus, None, draws=draws).z
        z_q = alias_ops.mh_sweep(cfg_q, state, corpus, None, draws=draws).z
    assert z_q.shape == z_ref.shape
    assert int(z_q.min()) >= 0 and int(z_q.max()) < k
    agree = float((z_q == z_ref).float().mean())
    assert agree > 0.8, f"packed sweep diverged: agreement {agree:.2%}"
