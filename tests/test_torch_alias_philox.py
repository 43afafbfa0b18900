"""The Philox draw mode of the alias_mh kernel: its plain version on the CPU,
held against Philox4x32-10's known answers and the JAX reference.

In the Philox mode the kernel makes each MH round's draws itself: for round
r and token i (its index within its own model), one Philox4x32-10 call with
counter (r, i, offset_lo, offset_hi) and key (seed_lo, seed_hi ^
0x414C4D48) gives j = (x0 * K) >> 32, u_prop = (x1 >> 8) * 2^-24 and u_acc =
(x2 >> 8) * 2^-24. `philox_mh_draws_plain` is that draw in eager PyTorch, and
on CPU tensors the wrappers run the plain version on it. The reference takes
its draws as inputs, so its side gets the same draws as numpy arrays.

Tolerances: the Philox words are exact integers (the known-answer vector of
Random123 at the zero counter and key, which cuRAND's `curand_Philox4x32_10`
also gives); bucket counts of 2e5 draws lie within 5 standard errors of
uniform; topics agree with the reference except accept near-ties, where
|log u_acc - log a| is below 1e-5 in some round (XLA's and PyTorch's float32
`log` may differ by an ulp there). Both sides read the same alias tables, so
the proposal step itself never differs.

The kernel itself runs only on the card (`test_torch_cuda.py`).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.alias_mh import kernel as ref_kernel  # noqa: E402
from repro_torch.core import alias, batch, codec, quant, types  # noqa: E402
from repro_torch.kernels.alias_mh import ops  # noqa: E402
from repro_torch.kernels.lda_gibbs import ops as lda_ops  # noqa: E402

NEAR_TIE = 1e-5
HP = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * 300)
U32 = 0xFFFFFFFF
TAG = 0x414C4D48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tables(n, k, w_bits, seed, lead=(), d=60, v=300):
    """Ids, assignments, weights (10% zero), stored count tables and the
    stale alias tables built from the real-unit counts, with an optional
    leading model axis `lead` — all numpy, from `seed` (no draws: the
    Philox key stands in for them)."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, d, (*lead, n)).astype(np.int32)
    words = rng.integers(0, v, (*lead, n)).astype(np.int32)
    z = rng.integers(0, k, (*lead, n)).astype(np.int32)
    weights = rng.uniform(0.05, 1.2, (*lead, n)).astype(np.float32)
    weights[rng.random((*lead, n)) < 0.1] = 0.0
    n_dt = rng.gamma(0.6, 4.0, (*lead, d, k)).astype(np.float32)
    n_wt = rng.gamma(0.4, 2.0, (*lead, v, k)).astype(np.float32)
    if w_bits is not None:
        sc = 1 << (w_bits + 1)
        n_dt, n_wt = (np.round(x * sc) / sc for x in (n_dt, n_wt))
    n_t = n_wt.sum(-2, dtype=np.float32)
    tw, aw = alias.build_alias_tables(torch.tensor(n_wt + HP["beta"], dtype=torch.float32))
    td, ad = alias.build_alias_tables(torch.tensor(n_dt + HP["alpha"], dtype=torch.float32))
    if w_bits is not None:
        sc = 1 << (w_bits + 1)
        n_dt, n_wt, n_t = (np.round(x * sc).astype(np.int32) for x in (n_dt, n_wt, n_t))
    return (docs, words, z, weights, n_dt, n_wt, n_t, tw.numpy(), aw.numpy(), td.numpy(),
            ad.numpy())


def _torch(arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _plain_words(seed, offset, r, i):
    """Philox words of round r, token i under the alias kernel's key."""
    ctr = torch.tensor([r, i, offset & U32, offset >> 32])
    key = torch.tensor([seed & U32, (seed >> 32) ^ TAG])
    return lda_ops.philox4x32_10_plain(ctr, key).tolist()


def test_philox_draws_known_answer_at_the_zero_counter():
    # Counter (0, 0, 0, 0) and key (0, 0): round 0, token 0, offset 0, and a
    # seed whose high word is the tag. Random123's known answer.
    x = (0x6627E8D5, 0xE169C58D, 0xBC57AC4C)
    for k in (12, 1000, 2 ** 13):
        j, up, ua = ops.philox_mh_draws_plain(TAG << 32, 0, 1, 1, k)
        assert int(j[0, 0]) == (x[0] * k) >> 32
        assert float(up[0, 0]) == (x[1] >> 8) * 2.0 ** -24
        assert float(ua[0, 0]) == (x[2] >> 8) * 2.0 ** -24


def test_philox_draws_are_the_kernels_words_in_the_s_n_layout():
    seed, offset, n, s, k = 2 ** 64 - 7, 2 ** 35 + 8, 600, 4, 37
    j, up, ua = ops.philox_mh_draws_plain(seed, offset, n, s, k)
    assert j.shape == up.shape == ua.shape == (s, n)
    assert j.dtype == torch.int32 and up.dtype == ua.dtype == torch.float32
    for r, i in ((0, 0), (1, 5), (3, 599), (2, 311)):
        x = _plain_words(seed, offset, r, i)
        assert int(j[r, i]) == (x[0] * k) >> 32
        assert float(up[r, i]) == (x[1] >> 8) * 2.0 ** -24
        assert float(ua[r, i]) == (x[2] >> 8) * 2.0 ** -24


def test_philox_draws_do_not_depend_on_the_layout():
    seed, offset, n, s, k = 99, 2 ** 33 + 4, 1000, 4, 13
    full = ops.philox_mh_draws_plain(seed, offset, n, s, k)
    # Fewer tokens, a later window of tokens, fewer rounds: the same draws.
    for part, want in zip(ops.philox_mh_draws_plain(seed, offset, 117, s, k, start=300),
                          full):
        assert torch.equal(part, want[:, 300:417])
    for part, want in zip(ops.philox_mh_draws_plain(seed, offset, 400, 2, k), full):
        assert torch.equal(part, want[:2, :400])
    # A model's draws in a stack are its own single-model draws.
    keys = [(2 ** 64 - 5, 16), (seed, offset), (2 ** 40 + 3, 2 ** 35)]
    table = torch.tensor([[lda_ops._i64(a), lda_ops._i64(b)] for a, b in keys])
    stacked = ops.philox_mh_draws_plain(table[:, 0], table[:, 1], n, s, k)
    assert stacked[0].shape == (3, s, n)
    for x, want in zip(stacked, full):
        assert torch.equal(x[1], want)
    for m, (a, b) in enumerate(keys):
        for x, want in zip(stacked, ops.philox_mh_draws_plain(a, b, n, s, k)):
            assert torch.equal(x[m], want)
    # Another offset (the next sweep) or another stream tag: other draws.
    assert not torch.equal(full[1], ops.philox_mh_draws_plain(seed, offset + 4, n, s, k)[1])
    gumbel_words = lda_ops.philox_plain(seed, offset, torch.tensor(0), torch.tensor(0),
                                        tag=lda_ops.PHILOX_KEY_TAG)
    assert gumbel_words.tolist() != _plain_words(seed, offset, 0, 0)


@pytest.mark.parametrize("k", [2, 12, 1000])
def test_philox_draws_are_in_range_and_near_uniform(k):
    n, s = 50_000, 4
    j, up, ua = ops.philox_mh_draws_plain(2 ** 63 + 1, 8, n, s, k)
    assert int(j.min()) >= 0 and int(j.max()) < k
    counts = torch.bincount(j.flatten().long(), minlength=k).double()
    expect = n * s / k
    assert float((counts - expect).abs().max()) < 5 * (expect * (1 - 1 / k)) ** 0.5 + 1
    for u in (up, ua):
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
        assert abs(float(u.double().mean()) - 0.5) < 0.005
    assert abs(float(torch.corrcoef(torch.stack([up.flatten(), ua.flatten()]))[0, 1])) < 0.01


def _assert_same_but_near_ties(got, want, arrays, draws, w_bits):
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    acc, _ = ops.margins(*_torch(arrays), *draws, w_bits=w_bits, **HP)
    acc = acc.numpy().reshape(-1)
    weights = np.asarray(arrays[3]).reshape(-1)
    diff = np.flatnonzero(got != want)
    for i in diff:
        assert weights[i] > 0, f"frozen token {i} moved"
        assert acc[i] < NEAR_TIE, f"token {i}: {got[i]} vs {want[i]}, accept margin {acc[i]}"
    return len(diff)


def _gathered(arrays, draws, n, k, m=None):
    """The reference kernel's inputs: rows and tables gathered per token, K
    lane-padded to 128 and N to the 256-token block as its `ops.py` pads
    (thresholds with 0.0, accept uniforms with 1.0); with `m`, per model."""
    docs, words, z, weights, n_dt, n_wt, n_t, tw, aw, td, ad = arrays
    j, up, ua = (x.numpy() for x in draws)
    kp, npad = -(-k // 128) * 128, -(-n // 256) * 256
    lead = () if m is None else (m,)
    idx = () if m is None else (np.arange(m)[:, None],)

    def rows(table, ids, fill=0):
        x = table[(*idx, ids)]
        pad = [(0, 0)] * len(lead) + [(0, npad - n), (0, kp - k)]
        return jnp.asarray(np.pad(x, pad, constant_values=fill))

    def tok(x):
        return jnp.asarray(np.pad(x, [(0, 0)] * len(lead) + [(0, npad - n)]))

    def rnd(x, fill=0):
        return jnp.asarray(np.pad(x, [(0, 0)] * (len(lead) + 1) + [(0, npad - n)],
                                  constant_values=fill))

    tot = jnp.asarray(np.pad(n_t, [(0, 0)] * len(lead) + [(0, kp - k)]))
    return (rows(n_dt, docs), rows(n_wt, words), tot, rows(tw, words, 0.0), rows(aw, words),
            rows(td, docs, 0.0), rows(ad, docs), tok(z), tok(weights), rnd(j), rnd(up, 0.0),
            rnd(ua, 1.0))


@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("k", [12, 128])
def test_philox_mode_matches_pallas_kernel_interpret(k, w_bits):
    n, s = 1000, 4
    arrays = _tables(n, k, w_bits, seed=3 * k + (w_bits or 0))
    key = (2 ** 63 + 17, 4 * k)
    got = ops.mh_resample(*_torch(arrays), philox=key, mh_steps=s, w_bits=w_bits, **HP)
    assert got.dtype == torch.int32 and got.shape == (n,)
    draws = ops.philox_mh_draws_plain(*key, n, s, k)
    assert torch.equal(got, ops.mh_resample_plain(*_torch(arrays), *draws, w_bits=w_bits, **HP))
    want = ref_kernel.alias_mh_blocked(*_gathered(arrays, draws, n, k), w_bits=w_bits,
                                       interpret=True, **HP)[:n]
    flips = _assert_same_but_near_ties(got.numpy(), want, arrays, draws, w_bits)
    assert flips <= n // 100
    assert int((got != torch.as_tensor(arrays[2])).sum()) > n // 20  # the chain moves


@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("k", [12, 128])
def test_batched_philox_mode_matches_batched_pallas_kernel_interpret(k, w_bits):
    m, n, s = 3, 512, 2
    arrays = _tables(n, k, w_bits, seed=5 * k + (w_bits or 0), lead=(m,))
    table = torch.tensor([[2 ** 62 + 5, 8], [-3, 2 ** 40], [11, 0]])
    got = ops.mh_resample_many(*_torch(arrays), philox=table, mh_steps=s, w_bits=w_bits, **HP)
    assert got.shape == (m, n)
    draws = ops.philox_mh_draws_plain(table[:, 0], table[:, 1], n, s, k)
    want = ref_kernel.alias_mh_blocked_batched(*_gathered(arrays, draws, n, k, m=m),
                                               w_bits=w_bits, interpret=True, **HP)[:, :n]
    _assert_same_but_near_ties(got.numpy(), want, arrays, draws, w_bits)
    # Model m under its own key is its single-model Philox call.
    for i in range(m):
        one = ops.mh_resample(*(t[i] for t in _torch(arrays)),
                              philox=tuple(x % 2 ** 64 for x in table[i].tolist()),
                              mh_steps=s, w_bits=w_bits, **HP)
        assert torch.equal(got[i], one)


def test_wrappers_with_a_key_run_the_plain_version_on_cpu_and_count_no_launch():
    arrays = _torch(_tables(300, 12, 8, seed=3))
    counters = (ops.mh_resample, ops.mh_resample_many)
    before = [(c.launches, c.launches_philox) for c in counters]
    key = (99, 40)
    got = ops.mh_resample(*arrays, philox=key, mh_steps=3, w_bits=8, **HP)
    draws = ops.philox_mh_draws_plain(*key, 300, 3, 12)
    assert draws[0].shape == (3, 300)
    assert torch.equal(got, ops.mh_resample_plain(*arrays, *draws, w_bits=8, **HP))
    stack = tuple(torch.stack([a, a]) for a in arrays)
    many = ops.mh_resample_many(*stack, philox=torch.tensor([[99, 40], [5, 8]]), mh_steps=3,
                                w_bits=8, **HP)
    assert torch.equal(many[0], got)
    assert [(c.launches, c.launches_philox) for c in counters] == before


def test_wrappers_refuse_a_bad_key():
    arrays = _torch(_tables(64, 12, None, seed=4))
    draws = ops.philox_mh_draws_plain(1, 0, 64, 2, 12)
    with pytest.raises(ValueError, match="not both"):
        ops.mh_resample(*arrays, *draws, philox=(1, 0), mh_steps=2, **HP)
    with pytest.raises(ValueError, match="not both or neither"):
        ops.mh_resample(*arrays, **HP)
    with pytest.raises(ValueError, match="not both or neither"):
        ops.mh_resample(*arrays, draws[0], None, None, **HP)
    with pytest.raises(ValueError, match="mh_steps >= 1"):
        ops.mh_resample(*arrays, philox=(1, 0), **HP)
    with pytest.raises(ValueError, match="mh_steps >= 1"):
        ops.mh_resample(*arrays, philox=(1, 0), mh_steps=0, **HP)
    with pytest.raises(ValueError, match="mh_steps goes with a Philox key"):
        ops._check(*arrays, *draws, None, mh_steps=2)
    with pytest.raises(ValueError, match="key must be a"):
        ops.mh_resample(*arrays, philox=(1, -1), mh_steps=2, **HP)
    with pytest.raises(ValueError, match="key must be a"):
        ops.mh_resample(*arrays, philox=(1, 2 ** 64), mh_steps=2, **HP)
    stack = tuple(a[None] for a in arrays)
    for bad in (torch.tensor([[1, 0, 0]]), torch.tensor([[1, 0]], dtype=torch.int32),
                torch.tensor([[1, 0], [2, 0]]), (1, 0)):
        with pytest.raises(ValueError, match="key must be a contiguous int64"):
            ops.mh_resample_many(*stack, philox=bad, mh_steps=2, **HP)
    z = ops.mh_resample(*(t.to("meta") for t in arrays), philox=(1, 0), mh_steps=2, **HP)
    assert z.device.type == "meta"  # `meta` takes the plain version, as the CPU
    elsewhere = SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="no alias_mh kernel"):
        ops.mh_resample(*[elsewhere] * 11, philox=(1, 0), mh_steps=2, **HP)


def _stack(k, w_bits, lengths, seed, d=50, v=200):
    rng = np.random.default_rng(seed)
    cfgs, corpora, states = [], [], []
    for n_i in lengths:
        cfg = types.LDAConfig(num_topics=k, vocab_size=v, num_docs=d, w_bits=w_bits)
        c = types.corpus_from_numpy(rng.integers(0, d, n_i), rng.integers(0, v, n_i),
                                    rng.uniform(0.1, 1.0, n_i), device="cpu")
        cfgs.append(cfg)
        corpora.append(c)
        states.append(codec.rebuild_state(cfg, c, torch.as_tensor(
            rng.integers(0, k, n_i), dtype=torch.int32)))
    return cfgs, corpora, states


@pytest.mark.parametrize("w_bits", [None, 8])
def test_mh_sweep_many_with_a_key_table_equals_single_sweeps(w_bits):
    k, s, lengths = 12, 4, [700, 433, 700, 519]
    cfgs, corpora, states = _stack(k, w_bits, lengths, seed=11)
    bcfg = batch.batch_cfg(cfgs, 50)
    stacked = batch.stack_corpora(corpora, max(lengths))
    stacked_states = batch.stack_states(bcfg, states, max(lengths))
    keys = [(2 ** 64 - 1 - i, 4 * i + 8) for i in range(len(lengths))]
    table = torch.tensor([[lda_ops._i64(a), lda_ops._i64(b)] for a, b in keys])
    got = ops.mh_sweep_many(bcfg, stacked_states, stacked, philox=table, mh_steps=s)
    for i, (cfg, c, st, key) in enumerate(zip(cfgs, corpora, states, keys)):
        one = ops.mh_sweep(cfg, st, c, None, s,
                           draws=ops.philox_mh_draws_plain(*key, lengths[i], s, k))
        assert torch.equal(got.z[i, :lengths[i]], one.z), i
        for name in ("n_wt", "n_t"):
            assert torch.equal(getattr(got, name)[i], getattr(one, name)), (i, name)
        assert torch.equal(got.n_dt[i, :cfg.num_docs], one.n_dt), i


def test_cpu_sweeps_keep_the_generators_draws():
    # Off the card the sweeps draw `sweep_draws` from the generator, as
    # before: a CPU generator has no Philox offset.
    k, lengths = 12, [300, 211]
    cfgs, corpora, states = _stack(k, 8, lengths, seed=2)
    gen = torch.Generator().manual_seed(5)
    got = ops.mh_sweep(cfgs[0], states[0], corpora[0], gen, 4)
    draws = alias.sweep_draws(torch.Generator().manual_seed(5), lengths[0], k, 4, "cpu")
    assert torch.equal(got.z, ops.mh_sweep(cfgs[0], states[0], corpora[0], None, 4,
                                           draws=draws).z)
    bcfg = batch.batch_cfg(cfgs, 50)
    gens = [torch.Generator().manual_seed(7 + i) for i in range(2)]
    many = alias.run_many(bcfg, batch.stack_states(bcfg, states, 300),
                          batch.stack_corpora(corpora, 300), gens, 1, 4, lengths)
    for i in range(2):
        one = ops.mh_sweep(cfgs[i], states[i], corpora[i],
                           torch.Generator().manual_seed(7 + i), 4)
        assert torch.equal(many.z[i, :lengths[i]], one.z)


@pytest.mark.parametrize("bits", [8, 4])
def test_counts_the_kernel_reads_are_never_negative(bits):
    # The kernel reads log q from the tables of log(max(x * s, 0) + prior):
    # exact when every count it sees is >= 0. Stored counts are sums of
    # non-negative weights; a packed sweep's word table is codes >= 0 times
    # scales >= 0, even from a table with negative entries.
    cfgs, corpora, states = _stack(12, 8, [900], seed=bits)
    state = states[0]
    for _ in range(3):
        state = ops.mh_sweep(cfgs[0], state, corpora[0], torch.Generator().manual_seed(1), 4)
        for t in (state.n_dt, state.n_wt, state.n_t):
            assert int(t.min()) >= 0
    real = codec.decode_array(cfgs[0], state.n_wt)
    noisy = real - torch.rand(real.shape, generator=torch.Generator().manual_seed(3))
    for table in (real, noisy):
        fq = quant.fake_quantize_rows(table, bits)
        assert float(fq.min()) >= 0.0
        assert torch.equal(torch.clamp_min(fq, 0.0), fq)
