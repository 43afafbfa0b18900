"""The packed-table Gibbs entry's Philox noise mode and the packed sweep's
word-table build, on the CPU, against the JAX reference.

In Philox mode the packed-table entry (`lda_gibbs_resample_quant`) draws
its Gumbel noise itself, the same g(i, t) the exact entry draws under the
same key: word t & 3 of Philox4x32-10 with counter (t >> 2, i, offset_lo,
offset_hi) and key (seed_lo, seed_hi ^ 0x4C444147). On CPU tensors
`ops.resample_quant(..., philox=key)` runs `resample_quant_plain` on
`philox_gumbel_plain`'s draw. The reference takes its noise as an input,
so its side (the Pallas kernel `gibbs_resample_blocked_quant` in interpret
mode) gets the same noise as a numpy array.

A packed sweep quantizes its stale word table once (`ops.pack_word_table`:
one kernel launch on the card, `pack_word_table_plain` here); the plain
path is held against the reference's `quantize_rows_jnp` and
`pack_nibbles_jnp`.

Tolerances, and why:
  * resampled topics equal the reference's on every token except
    near-ties, where the top-2 margin of score + noise is below 1e-5
    (XLA's and PyTorch's float32 `log` may differ by an ulp there);
  * the packed table equals the reference's exactly (the same float32
    division, round half to even, clip and nibble order);
  * on a lossless table (integer real counts, every row's maximum equal to
    the code range, so every scale is 1) a packed resample or sweep equals
    the exact one under the same key bit for bit: both score the same
    floats with the same operations.

The kernels themselves run only on the card (`test_torch_cuda.py`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import codec as ref_codec  # noqa: E402
from repro.core import quant as ref_quant  # noqa: E402
from repro.core import types as ref_types  # noqa: E402
from repro.kernels.lda_gibbs import kernel as ref_kernel  # noqa: E402
from repro_torch.core import types  # noqa: E402
from repro_torch.core.quant import QuantSpec  # noqa: E402
from repro_torch.kernels.lda_gibbs import ops  # noqa: E402

NEAR_TIE = 1e-5
HP = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * 300)
KEY = (2 ** 64 - 7, 2 ** 35 + 12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(n, k, w_bits, bits, seed, d=60, v=300):
    """Token ids, assignments, weights (10% zero), stored n_dt / n_t
    (float32, or int32 fixed point) and the packed word table made from a
    count table of plausible magnitude (no noise: a Philox key stands in)."""
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
    return docs, words, z, weights, n_dt, codes, scales, n_t


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


# -- the Philox mode against the reference ------------------------------------


@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", [12, 33])
def test_plain_quant_on_philox_noise_matches_pallas_kernel_interpret(k, bits, w_bits):
    n = 700
    arrays = _inputs(n, k, w_bits, bits, seed=20 * k + bits + (w_bits or 0))
    docs, words, z, weights, n_dt, codes, scales, n_t = arrays
    hp = dict(HP, bits=bits, w_bits=w_bits)
    got = ops.resample_quant(*_torch(arrays), philox=KEY, **hp)
    assert got.dtype == torch.int32 and got.shape == (n,)
    noise = ops.philox_gumbel_plain(*KEY, n, k).numpy()
    assert noise.shape == (n, k) and np.isfinite(noise).all()

    # The reference kernel takes pre-gathered rows padded as its ops.py pads
    # them: K to 128 lanes (256 for int4, so the packed lane dim stays 128),
    # N to the 256-token block, padded topics' noise -inf; its n_dt and
    # totals are real-unit float32.
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
    scores = ops.perturbed_scores_quant(*_torch(arrays), torch.as_tensor(noise), **hp).numpy()
    flips = _assert_same_but_near_ties(got.numpy(), want, scores, weights)
    assert flips <= n // 100
    frozen = weights == 0
    np.testing.assert_array_equal(got.numpy()[frozen], z[frozen])


# -- the wrapper's Philox mode on the CPU --------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_wrapper_with_a_key_runs_the_plain_version_on_cpu_and_counts_no_launch(bits):
    arrays = _torch(_inputs(300, 12, 8, bits, seed=3))
    hp = dict(HP, bits=bits, w_bits=8)
    before = (ops.resample_quant.launches, ops.resample_quant.launches_philox)
    got = ops.resample_quant(*arrays, philox=KEY, **hp)
    noise = ops.philox_noise(arrays[2], arrays[7], KEY)
    np.testing.assert_array_equal(
        got.numpy(), ops.resample_quant_plain(*arrays, noise, **hp).numpy())
    assert (ops.resample_quant.launches, ops.resample_quant.launches_philox) == before
    # A key is a draw of its own: another offset moves some tokens.
    other = ops.resample_quant(*arrays, philox=(KEY[0], KEY[1] + 4), **hp)
    assert not torch.equal(got, other)


def test_quant_wrapper_refuses_noise_and_key_together():
    arrays = _torch(_inputs(64, 12, 8, 8, seed=4))
    noise = ops.philox_noise(arrays[2], arrays[7], KEY)
    with pytest.raises(ValueError, match="not both"):
        ops.resample_quant(*arrays, noise, philox=KEY, bits=8, w_bits=8, **HP)
    with pytest.raises(ValueError, match="not both or neither"):
        ops._check_quant(*arrays, None, 8, 8)


@pytest.mark.parametrize("bad", [(1.5, 0), (-1, 0), (2 ** 64, 0), (1, 2, 3), [1, 2],
                                 torch.zeros(2, dtype=torch.int64)],
                         ids=["float", "negative", "too-wide", "triple", "list", "tensor"])
def test_quant_wrapper_refuses_a_bad_key(bad):
    arrays = _torch(_inputs(64, 12, 8, 4, seed=5))
    with pytest.raises(ValueError, match="key must be a"):
        ops.resample_quant(*arrays, philox=bad, bits=4, w_bits=8, **HP)


def test_quant_wrapper_checks_a_key_call_against_the_tables():
    docs, words, z, weights, n_dt, codes, scales, n_t = _torch(_inputs(64, 12, 8, 8, seed=6))
    with pytest.raises(ValueError, match="columns"):  # int8-wide codes declared as int4
        ops.resample_quant(docs, words, z, weights, n_dt, codes, scales, n_t, philox=KEY,
                           bits=4, w_bits=8, **HP)
    with pytest.raises(ValueError, match=r"z must be \(N,\)"):
        ops.resample_quant(docs, words, z[None], weights, n_dt, codes, scales, n_t,
                           philox=KEY, bits=8, w_bits=8, **HP)


# -- lossless tables: packed equals exact under one key -------------------------


def _lossless(n, k, w_bits, bits, seed, d=50, v=80):
    """Ids, z, weights and stored tables whose word table quantizes without
    loss: integer real counts with every row's maximum equal to the code
    range, so every row's scale is 1 and its codes are its counts."""
    rng = np.random.default_rng(seed)
    levels = (1 << bits) - 1
    real = rng.integers(0, levels + 1, (v, k)).astype(np.float32)
    real[np.arange(v), rng.integers(0, k, v)] = levels
    n_dt = rng.gamma(0.6, 4.0, (d, k)).astype(np.float32)
    n_t = real.sum(0)
    n_wt = real
    if w_bits is not None:
        s = 1 << (w_bits + 1)
        n_dt, n_wt, n_t = (np.round(x * s).astype(np.int32) for x in (n_dt, real, n_t))
    weights = rng.uniform(0.05, 1.2, n).astype(np.float32)
    weights[rng.random(n) < 0.1] = 0.0
    return (rng.integers(0, d, n).astype(np.int32), rng.integers(0, v, n).astype(np.int32),
            rng.integers(0, k, n).astype(np.int32), weights, n_dt, n_wt, n_t)


def _cfg(k, v, d, w_bits, mode):
    return types.LDAConfig(num_topics=k, vocab_size=v, num_docs=d, w_bits=w_bits,
                           quant=None if mode is None else QuantSpec(mode, w_bits=w_bits))


@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", [12, 33])
def test_lossless_packed_resample_equals_exact_under_one_key(k, bits, w_bits):
    docs, words, z, weights, n_dt, n_wt, n_t = _torch(_lossless(900, k, w_bits, bits, seed=k))
    cfg = _cfg(k, n_wt.shape[0], n_dt.shape[0], w_bits, "int8" if bits == 8 else "int4_packed")
    codes, scales = ops.pack_word_table(cfg, n_wt)
    assert torch.equal(scales, torch.ones_like(scales))
    hp = dict(HP, w_bits=w_bits)
    exact = ops.resample(docs, words, z, weights, n_dt, n_wt, n_t, philox=KEY, **hp)
    packed = ops.resample_quant(docs, words, z, weights, n_dt, codes, scales, n_t, philox=KEY,
                                bits=bits, **hp)
    assert torch.equal(packed, exact)
    noise = ops.philox_noise(z, n_t, KEY)
    assert torch.equal(
        ops.perturbed_scores_quant(docs, words, z, weights, n_dt, codes, scales, n_t, noise,
                                   bits=bits, **hp),
        ops.perturbed_scores(docs, words, z, weights, n_dt, n_wt, n_t, noise, **hp))


@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("mode", ["int8", "int4_packed"])
def test_lossless_packed_cpu_sweep_equals_exact_sweep_from_one_generator(mode, w_bits):
    # On the CPU both sweeps draw (N, K) `torch.rand` Gumbel noise from the
    # generator, so from one generator state they draw the same noise.
    bits = 8 if mode == "int8" else 4
    docs, words, z, weights, n_dt, n_wt, n_t = _torch(_lossless(1200, 12, w_bits, bits, seed=7))
    v, d = n_wt.shape[0], n_dt.shape[0]
    corpus = types.Corpus(docs, words, weights)
    state = types.LDAState(z, n_dt, n_wt, n_t)
    gen = torch.Generator().manual_seed(11)
    twin = torch.Generator()
    twin.set_state(gen.get_state())
    exact = ops.sweep_resample(_cfg(12, v, d, w_bits, None), state, corpus, gen)
    before = ops.pack_word_table.launches
    packed = ops.sweep_resample(_cfg(12, v, d, w_bits, mode), state, corpus, twin)
    assert ops.pack_word_table.launches == before  # the CPU packs with the plain version
    assert torch.equal(packed, exact)
    assert torch.equal(gen.get_state(), twin.get_state())


def test_packed_cpu_sweep_keeps_torch_rand_noise():
    arrays = _inputs(800, 12, 8, 8, seed=8)
    docs, words, z, weights, n_dt, _, _, n_t = _torch(arrays)
    rng = np.random.default_rng(8)
    n_wt = torch.as_tensor(np.round(rng.gamma(0.4, 2.0, (300, 12)) * 512).astype(np.int32))
    cfg = _cfg(12, 300, 60, 8, "int8")
    gen = torch.Generator().manual_seed(5)
    twin = torch.Generator()
    twin.set_state(gen.get_state())
    got = ops.sweep_resample(cfg, types.LDAState(z, n_dt, n_wt, n_t),
                             types.Corpus(docs, words, weights), gen)
    codes, scales = ops.pack_word_table_plain(cfg, n_wt)
    noise = ops.gumbel((800, 12), twin, "cpu")
    want = ops.resample_quant_plain(docs, words, z, weights, n_dt, codes, scales, n_t, noise,
                                    bits=8, w_bits=8, alpha=cfg.alpha, beta=cfg.beta,
                                    beta_bar=cfg.beta_bar)
    assert torch.equal(got, want)


# -- the plain pack path against the reference ----------------------------------


def _stored_table(v, k, w_bits, seed):
    """A stored (V, K) word table (float32, or int32 fixed point) with
    all-zero rows, repeated row maxima and entries half a step from a code
    boundary, so round-half-to-even decides them."""
    rng = np.random.default_rng(seed)
    x = rng.gamma(0.5, 3.0, (v, k)).astype(np.float32)
    x[::7] = 0.0
    x[1::5, 0] = x[1::5].max(axis=1)
    x[3] = np.arange(k, dtype=np.float32) + 0.5
    x[4] = (np.arange(k, dtype=np.float32) % 3) * 0.5
    if w_bits is not None:
        x = np.round(x * (1 << (w_bits + 1))).astype(np.int32)
    return x


@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", [7, 12])
def test_plain_pack_path_equals_reference_quantize_rows(k, bits, w_bits):
    x = _stored_table(60, k, w_bits, seed=k * bits)
    mode = "int8" if bits == 8 else "int4_packed"
    cfg = _cfg(k, 60, 10, w_bits, mode)
    ref_cfg = ref_types.LDAConfig(num_topics=k, vocab_size=60, num_docs=10, w_bits=w_bits,
                                  quant=ref_quant.QuantSpec(mode, w_bits))
    before = ops.pack_word_table.launches
    codes, scales = ops.pack_word_table(cfg, torch.as_tensor(x))
    assert ops.pack_word_table.launches == before
    want_codes, want_scales = ref_quant.quantize_rows_jnp(
        ref_codec.decode_array(ref_cfg, jnp.asarray(x)), bits)
    if bits == 4:
        want_codes = ref_quant.pack_nibbles_jnp(want_codes)
    assert codes.dtype == torch.uint8 and codes.shape == (60, k if bits == 8 else (k + 1) // 2)
    assert scales.dtype == torch.float32 and scales.shape == (60,)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_scales))
    if bits == 4 and k % 2:
        assert (codes.numpy()[:, -1] >> 4 == 0).all()  # the padding nibble is zero
