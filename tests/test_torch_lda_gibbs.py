"""The lda_gibbs kernel's plain version and sweep vs the JAX reference.

The reference side runs as its own tests run it on the CPU: the Pallas
kernel `gibbs_resample_blocked` in interpret mode (K lane-padded to 128
with -inf noise, N padded to the 256-token block, as its `ops.py` does)
and the pure-jnp oracle `ref.resample_tile`. Inputs and noise are made
with numpy from a seed and handed to both sides.

Tolerance: resampled topics are equal on every token except near-ties,
where the top-2 margin of score + noise is below 1e-5 — XLA's and
PyTorch's float32 `log` may differ by an ulp there. Counts rebuilt from
the port's topics are exact in `w_bits` fixed point.

The Hopper kernel itself runs only on the card (`test_torch_cuda.py`);
here the wrapper takes the plain version because the tensors lie on the
CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import codec as ref_codec  # noqa: E402
from repro.core import types as ref_types  # noqa: E402
from repro.kernels.lda_gibbs import kernel as ref_kernel  # noqa: E402
from repro.kernels.lda_gibbs import ops as ref_ops  # noqa: E402
from repro.kernels.lda_gibbs import ref as ref_ref  # noqa: E402
from repro_torch.core import codec, types  # noqa: E402
from repro_torch.kernels.lda_gibbs import ops  # noqa: E402

NEAR_TIE = 1e-5
HP = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * 300)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(n, k, w_bits, seed, d=60, v=300):
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, d, n).astype(np.int32)
    words = rng.integers(0, v, n).astype(np.int32)
    z = rng.integers(0, k, n).astype(np.int32)
    weights = rng.uniform(0.05, 1.2, n).astype(np.float32)
    weights[rng.random(n) < 0.1] = 0.0  # frozen / padding tokens
    n_dt = rng.gamma(0.6, 4.0, (d, k)).astype(np.float32)
    n_wt = rng.gamma(0.4, 2.0, (v, k)).astype(np.float32)
    n_t = n_wt.sum(0)
    if w_bits is not None:
        s = 1 << (w_bits + 1)
        n_dt, n_wt, n_t = (np.round(x * s).astype(np.int32) for x in (n_dt, n_wt, n_t))
    noise = rng.gumbel(size=(n, k)).astype(np.float32)
    return docs, words, z, weights, n_dt, n_wt, n_t, noise


def _torch(arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _assert_same_but_near_ties(got, want, scores, weights):
    """Equal topics except where the top-2 margin is below NEAR_TIE."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.flatnonzero(got != want)
    top2 = np.sort(scores, axis=1)[:, -2:] if scores.shape[1] > 1 else None
    for i in diff:
        assert weights[i] > 0, f"frozen token {i} moved"
        assert top2 is not None and top2[i, 1] - top2[i, 0] < NEAR_TIE, \
            f"token {i}: {got[i]} vs {want[i]} with margin {top2[i, 1] - top2[i, 0]}"
    return len(diff)


def _scores(arrays, w_bits):
    return ops.perturbed_scores(*_torch(arrays), w_bits=w_bits, **HP).numpy()


@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("k", [12, 128, 200])
def test_plain_matches_pallas_kernel_interpret(k, w_bits):
    n = 1000
    arrays = _inputs(n, k, w_bits, seed=k + (w_bits or 0))
    docs, words, z, weights, n_dt, n_wt, n_t, noise = arrays
    got = ops.resample(*_torch(arrays), w_bits=w_bits, **HP)
    assert got.dtype == torch.int32 and got.shape == (n,)

    # The reference kernel takes pre-gathered rows, padded as its ops.py pads.
    kp, npad = -(-k // 128) * 128, -(-n // 256) * 256

    def pad2(x, fill=0):
        return np.pad(x, ((0, npad - n), (0, kp - k)), constant_values=fill)

    def pad1(x):
        return np.pad(x, (0, npad - n))

    want = ref_kernel.gibbs_resample_blocked(
        jnp.asarray(pad2(n_dt[docs])), jnp.asarray(pad2(n_wt[words])),
        jnp.asarray(np.pad(n_t, (0, kp - k))), jnp.asarray(pad1(z)),
        jnp.asarray(pad1(weights)), jnp.asarray(pad2(noise, -np.inf)),
        w_bits=w_bits, interpret=True, **HP)[:n]
    flips = _assert_same_but_near_ties(got.numpy(), want, _scores(arrays, w_bits), weights)
    assert flips <= n // 100


@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("k", [12, 128, 200])
def test_plain_matches_reference_oracle(k, w_bits):
    n = 2048
    arrays = _inputs(n, k, w_bits, seed=7 * k + 1)
    docs, words, z, weights, n_dt, n_wt, n_t, noise = arrays
    got = ops.resample_plain(*_torch(arrays), w_bits=w_bits, **HP)
    s = 1.0 if w_bits is None else 2.0 ** -(w_bits + 1)
    want = ref_ref.resample_tile(
        jnp.asarray(n_dt[docs] * np.float32(s)), jnp.asarray(n_wt[words] * np.float32(s)),
        jnp.asarray(n_t * np.float32(s)), jnp.asarray(z), jnp.asarray(weights),
        jnp.asarray(noise), **HP)
    _assert_same_but_near_ties(got.numpy(), want, _scores(arrays, w_bits), weights)
    # Frozen tokens keep their topic.
    frozen = weights == 0
    np.testing.assert_array_equal(got.numpy()[frozen], z[frozen])


@pytest.mark.parametrize("w_bits", [None, 8])
def test_ops_sweep_matches_reference_sweep(w_bits):
    rng = np.random.default_rng(11)
    n, d, v, k = 1500, 50, 250, 12
    docs = rng.integers(0, d, n).astype(np.int32)
    words = rng.integers(0, v, n).astype(np.int32)
    weights = rng.uniform(0.1, 1.0, n).astype(np.float32)
    z0 = rng.integers(0, k, n).astype(np.int32)
    fields = dict(num_topics=k, vocab_size=v, num_docs=d, alpha=0.1, beta=0.01, w_bits=w_bits)
    ref_cfg = ref_types.LDAConfig(**fields)
    ref_corpus = ref_types.Corpus(jnp.asarray(docs), jnp.asarray(words), jnp.asarray(weights))
    ref_state = ref_codec.rebuild_state(ref_cfg, ref_corpus, jnp.asarray(z0))
    key = jax.random.PRNGKey(5)
    want = ref_ops.sweep(ref_cfg, ref_state, ref_corpus, key)

    # The reference draws (npad, kp) noise and slices the live block.
    npad = -(-n // 256) * 256
    noise = np.asarray(jax.random.gumbel(key, (npad, 128), jnp.float32))[:n, :k]
    cfg, corpus, state = types.from_reference(
        fields, {"docs": docs, "words": words, "weights": weights},
        {f: np.asarray(getattr(ref_state, f)) for f in ("z", "n_dt", "n_wt", "n_t")},
        device="cpu")
    noise = noise.copy()
    got = ops.sweep(cfg, state, corpus, None, noise=torch.as_tensor(noise))

    sc = codec.codec_for(cfg)
    real = sc.decode_state(state)
    scores = ops.perturbed_scores(corpus.docs, corpus.words, state.z, corpus.weights,
                                  real.n_dt, real.n_wt, real.n_t, torch.as_tensor(noise),
                                  alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar).numpy()
    _assert_same_but_near_ties(got.z.numpy(), want.z, scores, weights)
    # Counts: the port's rebuild equals the reference's rebuild of the same z.
    ref_rebuilt = ref_codec.rebuild_state(ref_cfg, ref_corpus, jnp.asarray(got.z.numpy()))
    for f in ("n_dt", "n_wt", "n_t"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(ref_rebuilt, f))
        if w_bits is None:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    arrays = _torch(_inputs(300, 12, None, seed=3))
    before = ops.resample.launches
    got = ops.resample(*arrays, **HP)
    np.testing.assert_array_equal(got.numpy(), ops.resample_plain(*arrays, **HP).numpy())
    assert ops.resample.launches == before


def test_wrapper_checks_what_the_kernel_takes():
    docs, words, z, weights, n_dt, n_wt, n_t, noise = _torch(_inputs(64, 12, 8, seed=4))
    good = (docs, words, z, weights, n_dt, n_wt, n_t, noise)
    ops._check(*good, 8)
    with pytest.raises(ValueError, match="must be torch.float32"):
        ops._check(*good, None)  # int tables need w_bits
    with pytest.raises(ValueError, match="docs must be int32"):
        ops._check(docs.long(), *good[1:], 8)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(*good[:7], noise.t().contiguous().t(), 8)
    with pytest.raises(ValueError, match="count tables"):
        ops._check(*good[:4], n_dt[:, :5].contiguous(), *good[5:], 8)


def test_gumbel_draw_is_standard_and_seeded():
    g1 = ops.gumbel((20000, 4), torch.Generator().manual_seed(1), "cpu")
    g2 = ops.gumbel((20000, 4), torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(g1, g2) and torch.isfinite(g1).all()
    # Standard Gumbel: mean = Euler–Mascheroni, variance = π²/6.
    assert abs(float(g1.mean()) - 0.5772) < 0.02
    assert abs(float(g1.var()) - np.pi ** 2 / 6) < 0.05
