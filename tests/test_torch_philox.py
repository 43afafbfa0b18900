"""The Philox noise mode of the lda_gibbs kernel: its plain version on the
CPU, held against Philox4x32-10's known answers and the JAX reference.

In Philox mode the kernel draws its Gumbel noise itself: g(i, t) from word
t & 3 of Philox4x32-10 with counter (t >> 2, i, offset_lo, offset_hi) and
key (seed_lo, seed_hi ^ 0x4C444147), i the token's index within its model.
`philox_gumbel_plain` is that draw in eager PyTorch, and on CPU tensors
the wrapper runs `resample_plain` on it. The reference takes its noise as
an input, so its side gets the same noise as a numpy array.

Tolerances: the Philox words are exact integers (known-answer vectors from
Random123, which cuRAND's `curand_Philox4x32_10` also gives); the Gumbel
mean of 2e5 draws lies within 0.02 of Euler's constant (its standard error
is 0.003); resampled topics agree with the reference except near-ties,
where the top-2 margin of score + noise is below 1e-5 (XLA's and PyTorch's
float32 `log` may differ by an ulp there).

The kernel itself runs only on the card (`test_torch_cuda.py`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.lda_gibbs import kernel as ref_kernel  # noqa: E402
from repro.kernels.lda_gibbs import ref as ref_ref  # noqa: E402
from repro_torch.kernels.lda_gibbs import ops  # noqa: E402

NEAR_TIE = 1e-5
HP = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * 300)
U32 = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(n, k, w_bits, seed, d=60, v=300):
    """Ids, assignments, weights (10% zero) and stored count tables, made
    with numpy from `seed` (no noise: the Philox key stands in for it)."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, d, n).astype(np.int32)
    words = rng.integers(0, v, n).astype(np.int32)
    z = rng.integers(0, k, n).astype(np.int32)
    weights = rng.uniform(0.05, 1.2, n).astype(np.float32)
    weights[rng.random(n) < 0.1] = 0.0
    n_dt = rng.gamma(0.6, 4.0, (d, k)).astype(np.float32)
    n_wt = rng.gamma(0.4, 2.0, (v, k)).astype(np.float32)
    n_t = n_wt.sum(0)
    if w_bits is not None:
        s = 1 << (w_bits + 1)
        n_dt, n_wt, n_t = (np.round(x * s).astype(np.int32) for x in (n_dt, n_wt, n_t))
    return docs, words, z, weights, n_dt, n_wt, n_t


def _torch(arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((U32, U32, U32, U32), (U32, U32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    got = ops.philox4x32_10_plain(torch.tensor(counter), torch.tensor(key))
    assert tuple(got.tolist()) == want


def test_uniform_to_gumbel_is_finite_at_both_ends():
    # x = 0 gives u = 0 (clamped to the smallest normal float), x = 2^32 - 1
    # gives u = 1 - 2^-24, the largest the map reaches.
    g = ops.philox_words_to_gumbel(torch.tensor([0, 0xFF, 0x100, U32]))
    assert bool(torch.isfinite(g).all())
    tiny = torch.finfo(torch.float32).tiny
    want = -np.log(-np.log(np.float32([tiny, tiny, 2.0 ** -24, 1 - 2.0 ** -24]),
                           dtype=np.float64))
    np.testing.assert_allclose(g.double().numpy(), want, rtol=1e-6)


def test_philox_gumbel_is_standard_and_seeded():
    g = ops.philox_gumbel_plain(1234, 8, 50_000, 4)
    assert g.shape == (50_000, 4) and g.dtype == torch.float32
    assert torch.equal(g, ops.philox_gumbel_plain(1234, 8, 50_000, 4))
    assert abs(float(g.double().mean()) - 0.5772) < 0.02
    assert not torch.equal(g, ops.philox_gumbel_plain(1234, 12, 50_000, 4))


def test_philox_draw_does_not_depend_on_the_layout():
    seed, offset, n, k = 2 ** 64 - 5, 2 ** 33 + 4, 1000, 13
    full = ops.philox_gumbel_plain(seed, offset, n, k)
    assert torch.equal(full[300:417], ops.philox_gumbel_plain(seed, offset, 117, k, start=300))
    # A wider K extends each row's draw: topic t's variate depends on t alone.
    assert torch.equal(full, ops.philox_gumbel_plain(seed, offset, n, 20)[:, :k])


def test_stacked_philox_draw_is_each_models_own_draw():
    keys = [(2 ** 64 - 5, 16), (7, 0), (2 ** 40 + 3, 2 ** 35)]
    table = torch.tensor([[ops._i64(s), ops._i64(o)] for s, o in keys])
    stacked = ops.philox_gumbel_plain(table[:, 0], table[:, 1], 257, 12)
    assert stacked.shape == (3, 257, 12)
    for m, (s, o) in enumerate(keys):
        assert torch.equal(stacked[m], ops.philox_gumbel_plain(s, o, 257, 12))


def test_wrapper_with_a_key_runs_the_plain_version_on_cpu_and_counts_no_launch():
    args = _torch(_inputs(300, 12, 8, seed=3))
    key = (99, 40)
    counters = (ops.resample, ops.resample_many)
    before = [(c.launches, c.launches_philox) for c in counters]
    got = ops.resample(*args, philox=key, w_bits=8, **HP)
    noise = ops.philox_gumbel_plain(*key, 300, 12)
    assert torch.equal(got, ops.resample_plain(*args, noise, w_bits=8, **HP))
    # Stacked: model m under its own key equals its single-model call.
    stack = tuple(torch.stack([a, a.flip(0)]) for a in args)
    keys = torch.tensor([[99, 40], [5, 8]])
    many = ops.resample_many(*stack, philox=keys, w_bits=8, **HP)
    for m in range(2):
        one = ops.resample(*(a[m] for a in stack), philox=tuple(keys[m].tolist()), w_bits=8,
                           **HP)
        assert torch.equal(many[m], one)
    assert [(c.launches, c.launches_philox) for c in counters] == before


def test_wrapper_refuses_a_bad_key():
    args = _torch(_inputs(64, 12, None, seed=4))
    noise = ops.philox_gumbel_plain(1, 0, 64, 12)
    with pytest.raises(ValueError, match="not both"):
        ops.resample(*args, noise, philox=(1, 0), **HP)
    with pytest.raises(ValueError, match="not both"):
        ops._check(*args, None, None)
    with pytest.raises(ValueError, match="key must be a"):
        ops.resample(*args, philox=(1, -1), **HP)
    stack = tuple(a[None] for a in args)
    with pytest.raises(ValueError, match="key must be a contiguous int64"):
        ops.resample_many(*stack, philox=torch.tensor([[1, 0, 0]]), **HP)
    with pytest.raises(ValueError, match="key must be a contiguous int64"):
        ops.resample_many(*stack, philox=torch.tensor([[1, 0]], dtype=torch.int32), **HP)


def test_philox_key_needs_a_generator_with_an_offset():
    # A CPU generator keeps no Philox offset; the card's does (test_torch_cuda).
    with pytest.raises(RuntimeError, match="offset"):
        ops.philox_key(torch.Generator().manual_seed(0))


def _assert_same_but_near_ties(got, want, scores, weights):
    got, want = np.asarray(got), np.asarray(want)
    top2 = np.sort(scores, axis=1)[:, -2:]
    for i in np.flatnonzero(got != want):
        assert weights[i] > 0, f"frozen token {i} moved"
        assert top2[i, 1] - top2[i, 0] < NEAR_TIE, f"token {i}: {got[i]} vs {want[i]}"


@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("k", [12, 128])
def test_philox_mode_matches_reference_oracle_and_pallas_kernel(k, w_bits):
    n = 1000
    arrays = _inputs(n, k, w_bits, seed=5 * k + (w_bits or 0))
    docs, words, z, weights, n_dt, n_wt, n_t = arrays
    key = (2 ** 63 + 17, 4 * k)
    got = ops.resample(*_torch(arrays), philox=key, w_bits=w_bits, **HP).numpy()
    noise = ops.philox_gumbel_plain(*key, n, k)
    scores = ops.perturbed_scores(*_torch(arrays), noise, w_bits=w_bits, **HP).numpy()
    noise = noise.numpy()
    s = np.float32(1.0 if w_bits is None else 2.0 ** -(w_bits + 1))

    want = ref_ref.resample_tile(
        jnp.asarray(n_dt[docs] * s), jnp.asarray(n_wt[words] * s), jnp.asarray(n_t * s),
        jnp.asarray(z), jnp.asarray(weights), jnp.asarray(noise), **HP)
    _assert_same_but_near_ties(got, want, scores, weights)

    # The Pallas kernel in interpret mode, padded as the reference's ops.py pads.
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
    _assert_same_but_near_ties(got, want, scores, weights)
