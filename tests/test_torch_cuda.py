"""The Hopper kernels (lda_gibbs, alias_mh, single-model and batched, the
packed-table lda_gibbs entry, chunk_scan and decode_attn) on the card,
against their plain versions.

Every test here needs a CUDA card (marker `cuda`) and skips without one;
this file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: each kernel's topics equal its plain version's on every token
except near-ties, where CUDA's `logf` and PyTorch's `log` could differ by
an ulp: a top-2 margin of score + noise below 1e-5 for lda_gibbs, an
accept margin |log u - log a| below 1e-5 in some round for alias_mh.
A batched launch equals the single-model launches on each model's own
rows exactly: both entries run the same kernel body. The Philox modes
(noise or MH draws made in the kernel) are held to the same near-tie rules
against the plain versions on `philox_gumbel_plain`'s noise and
`philox_mh_draws_plain`'s draws (alias_mh also exempts a proposal margin
|u_prop - thresh| below 1e-5, and runs both of its bodies, direct and log
tables; the packed-table lda_gibbs entry runs both of its bodies); their
Philox words equal cuRAND's exactly, and a `batched` sweep
equals the single `cuda` sweeps, a batched `alias` sweep the single `alias`
sweeps, from cloned generators exactly. The pack kernel's codes and scales
equal the eager quantization's bit for bit, and on a lossless packed table
(every scale 1) the packed-table entry equals the exact entry under one
Philox key exactly, as a packed sweep equals an exact one from one
generator. chunk_scan and
decode_attn sum in other orders than their plain versions: float32 within
3e-5 (chunk_scan, the reference's own tolerance; 1e-4 past 1,000 tokens,
where 64 chunks of state carry) and 2e-5 (decode_attn); bf16 outputs within
the reference's bf16 tolerances (5e-2 for y, 2e-2 for the state); bf16
attention within one bf16 ulp (atol 1e-5, rtol 1e-2), since both sides
round one float32 result. The chunk_scan kernels have no backward: both
entries raise under grad mode with an input that requires grad, and a
reduced train step on the card (the plain scans) matches the CPU's (loss
within 2e-3; gradients as `tests/test_torch_train_parity.py` holds them).
lda_gibbs at the production RLDA sweep's block (8192 tokens, K 256, `w_bits`
8 or float32 tables) holds the near-tie rule in both noise modes, and
`launch.dryrun_rlda.run_one` at 2^20 tokens of that config keeps its count
invariants. At K 8,192, the most the entries admit, the K > 32 body's 64 KB
of shared memory a block (past the default 48 KB) holds the near-tie rule
in both noise modes, single and batched.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import alias, batch, codec, types  # noqa: E402
from repro_torch.kernels.alias_mh import ops as alias_ops  # noqa: E402
from repro_torch.kernels.lda_gibbs import kernel as lda_kernel  # noqa: E402
from repro_torch.kernels.lda_gibbs import ops  # noqa: E402

NEAR_TIE = 1e-5
HP = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * 300)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the hand-written kernels run only on a CUDA card")
    return torch.device("cuda")


def _inputs(n, k, w_bits, seed, device, d=60, v=300):
    rng = np.random.default_rng(seed)
    weights = rng.uniform(0.05, 1.2, n).astype(np.float32)
    weights[rng.random(n) < 0.1] = 0.0
    n_dt = rng.gamma(0.6, 4.0, (d, k)).astype(np.float32)
    n_wt = rng.gamma(0.4, 2.0, (v, k)).astype(np.float32)
    n_t = n_wt.sum(0)
    if w_bits is not None:
        s = 1 << (w_bits + 1)
        n_dt, n_wt, n_t = (np.round(x * s).astype(np.int32) for x in (n_dt, n_wt, n_t))
    arrays = (rng.integers(0, d, n).astype(np.int32), rng.integers(0, v, n).astype(np.int32),
              rng.integers(0, k, n).astype(np.int32), weights, n_dt, n_wt, n_t,
              rng.gumbel(size=(n, k)).astype(np.float32))
    return tuple(torch.tensor(a, device=device) for a in arrays)


def _assert_same_but_near_ties(got, want, scores):
    top2 = scores.topk(2, dim=1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    diff = np.flatnonzero((got != want).cpu().numpy())
    assert all(margin[i] < NEAR_TIE for i in diff), diff[:10]


@pytest.mark.cuda
@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("k", [12, 33, 200])
def test_kernel_matches_plain_on_card(card, k, w_bits):
    args = _inputs(4099, k, w_bits, seed=k, device=card)
    before = ops.resample.launches
    got = ops.resample(*args, w_bits=w_bits, **HP)
    torch.cuda.synchronize()
    assert ops.resample.launches == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    want = ops.resample_plain(*args, w_bits=w_bits, **HP)
    _assert_same_but_near_ties(got, want, ops.perturbed_scores(*args, w_bits=w_bits, **HP))
    frozen = args[3] == 0
    assert torch.equal(got[frozen], args[2][frozen])


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    args = _inputs(256, 12, 8, seed=1, device=card)
    with pytest.raises(ValueError, match="must be torch.float32"):
        ops.resample(*args, **HP)  # int32 tables without w_bits
    with pytest.raises(ValueError, match="docs must be int32"):
        ops.resample(args[0].long(), *args[1:], w_bits=8, **HP)
    with pytest.raises(ValueError, match="docs is on cpu"):
        ops.resample(args[0].cpu(), *args[1:], w_bits=8, **HP)


@pytest.mark.cuda
@pytest.mark.parametrize("w_bits", [None, 8])
def test_cuda_sweep_matches_cpu_sweep_on_the_same_noise(card, w_bits):
    rng = np.random.default_rng(3)
    n, d, v, k = 5000, 80, 400, 12
    cfg = types.LDAConfig(num_topics=k, vocab_size=v, num_docs=d, w_bits=w_bits)
    cpu = types.corpus_from_numpy(rng.integers(0, d, n), rng.integers(0, v, n),
                                  rng.uniform(0.1, 1.0, n), device="cpu")
    state = codec.rebuild_state(cfg, cpu, torch.as_tensor(rng.integers(0, k, n), dtype=torch.int32))
    noise = torch.tensor(rng.gumbel(size=(n, k)).astype(np.float32))
    want = ops.sweep(cfg, state, cpu, None, noise=noise)
    got = ops.sweep(cfg, state.to(card), cpu.to(card), None, noise=noise.to(card))
    real = codec.decode_state(cfg, state)
    scores = ops.perturbed_scores(cpu.docs, cpu.words, state.z, cpu.weights, real.n_dt,
                                  real.n_wt, real.n_t, noise, alpha=cfg.alpha, beta=cfg.beta,
                                  beta_bar=cfg.beta_bar)
    _assert_same_but_near_ties(got.z.cpu(), want.z, scores)
    # Atomic float adds on the card may move a fixed-point rounding by a unit.
    for f in ("n_dt", "n_wt", "n_t"):
        dev = (getattr(got, f).cpu().double() - getattr(want, f).double()).abs().max()
        assert float(dev) <= (1.0 if w_bits is not None else 1e-4), f


def _alias_inputs(n, k, w_bits, seed, device, mh_steps=4, d=60, v=300):
    """(ids, z, weights, stored counts, alias tables, (S, N) draws) on `device`."""
    rng = np.random.default_rng(seed)
    weights = rng.uniform(0.05, 1.2, n).astype(np.float32)
    weights[rng.random(n) < 0.1] = 0.0
    n_dt = torch.tensor(rng.gamma(0.6, 4.0, (d, k)).astype(np.float32), device=device)
    n_wt = torch.tensor(rng.gamma(0.4, 2.0, (v, k)).astype(np.float32), device=device)
    cfg = types.LDAConfig(num_topics=k, vocab_size=v, num_docs=d, w_bits=w_bits)
    if w_bits is not None:  # real counts on the fixed-point grid
        n_dt, n_wt = (codec.decode_array(cfg, codec.codec_for(cfg).encode_array(x))
                      for x in (n_dt, n_wt))
    tables = alias.sweep_tables(cfg, n_dt, n_wt)
    sc = codec.codec_for(cfg)
    counts = tuple(sc.encode_array(x) for x in (n_dt, n_wt, n_wt.sum(0)))
    ids = tuple(torch.tensor(a, device=device) for a in (
        rng.integers(0, d, n).astype(np.int32), rng.integers(0, v, n).astype(np.int32),
        rng.integers(0, k, n).astype(np.int32), weights))
    draws = alias.sweep_draws(torch.Generator(device=device).manual_seed(seed), n, k,
                              mh_steps, device)
    return (*ids, *counts, *tables, *draws)


def _assert_alias_same_but_near_ties(got, want, args, w_bits):
    acc, _ = alias_ops.margins(*args, w_bits=w_bits, **HP)
    diff = torch.nonzero(got != want).flatten()
    assert bool((acc[diff] < NEAR_TIE).all()), diff[:10].tolist()
    assert bool((args[3][diff] > 0).all()), "a frozen token moved"


@pytest.mark.cuda
@pytest.mark.parametrize("mh_steps", [2, 4])
@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("k", [12, 33, 200])
def test_alias_kernel_matches_plain_on_card(card, k, w_bits, mh_steps):
    args = _alias_inputs(4099, k, w_bits, seed=k + mh_steps, device=card, mh_steps=mh_steps)
    before = alias_ops.mh_resample.launches
    got = alias_ops.mh_resample(*args, w_bits=w_bits, **HP)
    torch.cuda.synchronize()
    assert alias_ops.mh_resample.launches == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    want = alias_ops.mh_resample_plain(*args, w_bits=w_bits, **HP)
    _assert_alias_same_but_near_ties(got, want, args, w_bits)
    frozen = args[3] == 0
    assert torch.equal(got[frozen], args[2][frozen])
    assert int((got != args[2]).sum()) > 0  # the chain moves


@pytest.mark.cuda
def test_alias_wrapper_refuses_what_the_kernel_does_not_take(card):
    args = list(_alias_inputs(256, 12, 8, seed=1, device=card))
    with pytest.raises(ValueError, match="must be torch.float32"):
        alias_ops.mh_resample(*args, **HP)  # int32 tables without w_bits
    bad = list(args)
    bad[11] = args[11].long()
    with pytest.raises(ValueError, match="j_prop must be int32"):
        alias_ops.mh_resample(*bad, w_bits=8, **HP)
    bad = list(args)
    bad[8] = args[8].cpu()
    with pytest.raises(ValueError, match="alias_w is on cpu"):
        alias_ops.mh_resample(*bad, w_bits=8, **HP)
    bad = list(args)
    bad[7] = args[7][:, :5].contiguous()
    with pytest.raises(ValueError, match="thresh_w must be float32"):
        alias_ops.mh_resample(*bad, w_bits=8, **HP)


@pytest.mark.cuda
@pytest.mark.parametrize("w_bits", [None, 8])
def test_alias_sweep_on_card_matches_cpu_sweep_on_the_same_draws(card, w_bits):
    rng = np.random.default_rng(5)
    n, d, v, k = 5000, 80, 400, 12
    cfg = types.LDAConfig(num_topics=k, vocab_size=v, num_docs=d, w_bits=w_bits)
    cpu = types.corpus_from_numpy(rng.integers(0, d, n), rng.integers(0, v, n),
                                  rng.uniform(0.1, 1.0, n), device="cpu")
    state = codec.rebuild_state(cfg, cpu, torch.as_tensor(rng.integers(0, k, n), dtype=torch.int32))
    real = codec.decode_state(cfg, state)
    tables = alias.sweep_tables(cfg, real.n_dt, real.n_wt)
    draws = alias.sweep_draws(torch.Generator().manual_seed(2), n, k, 4, "cpu")
    want = alias_ops.mh_sweep(cfg, state, cpu, None, 4, draws=draws, tables=tables)
    got = alias_ops.mh_sweep(cfg, state.to(card), cpu.to(card), None, 4,
                             draws=tuple(t.to(card) for t in draws),
                             tables=tuple(t.to(card) for t in tables))
    args = (cpu.docs, cpu.words, state.z, cpu.weights, state.n_dt, state.n_wt, state.n_t,
            *tables, *draws)
    _assert_alias_same_but_near_ties(got.z.cpu(), want.z, args, w_bits)
    for f in ("n_dt", "n_wt", "n_t"):
        dev = (getattr(got, f).cpu().double() - getattr(want, f).double()).abs().max()
        assert float(dev) <= (1.0 if w_bits is not None else 1e-4), f


# -- the batched kernels -------------------------------------------------------


def _stack_inputs(m, n, k, w_bits, seed, device, mh_steps=None, d=60, v=300):
    """A ragged stack of m models on `device`: each model's tokens past its
    own length are weight-0 padding. Gibbs arguments, or with `mh_steps`
    the alias_mh arguments (tables from the real-unit counts, draws)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(n // 2, n + 1, m)
    lengths[0] = n
    cfg = types.LDAConfig(num_topics=k, vocab_size=v, num_docs=d, w_bits=w_bits)
    sc = codec.codec_for(cfg)
    weights = rng.uniform(0.05, 1.2, (m, n)).astype(np.float32)
    weights[rng.random((m, n)) < 0.1] = 0.0
    weights[np.arange(n)[None, :] >= lengths[:, None]] = 0.0
    ids = tuple(torch.tensor(a, device=device) for a in (
        rng.integers(0, d, (m, n)).astype(np.int32), rng.integers(0, v, (m, n)).astype(np.int32),
        rng.integers(0, k, (m, n)).astype(np.int32), weights))
    n_dt = sc.decode_array(sc.encode_array(torch.tensor(
        rng.gamma(0.6, 4.0, (m, d, k)).astype(np.float32), device=device)))
    n_wt = sc.decode_array(sc.encode_array(torch.tensor(
        rng.gamma(0.4, 2.0, (m, v, k)).astype(np.float32), device=device)))
    counts = tuple(sc.encode_array(x) for x in (n_dt, n_wt, n_wt.sum(1)))
    if mh_steps is None:
        return (*ids, *counts, torch.tensor(rng.gumbel(size=(m, n, k)).astype(np.float32),
                                            device=device))
    tables = alias.sweep_tables(cfg, n_dt, n_wt)
    draws = tuple(torch.tensor(a, device=device) for a in (
        rng.integers(0, k, (m, mh_steps, n)).astype(np.int32),
        rng.random((m, mh_steps, n)).astype(np.float32),
        rng.random((m, mh_steps, n)).astype(np.float32)))
    return (*ids, *counts, *tables, *draws)


@pytest.mark.cuda
@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("k", [12, 33, 200])
def test_batched_kernel_matches_plain_and_single_launches_on_card(card, k, w_bits):
    args = _stack_inputs(5, 4099, k, w_bits, seed=k, device=card)
    before = (ops.resample_many.launches, ops.resample.launches)
    got = ops.resample_many(*args, w_bits=w_bits, **HP)
    torch.cuda.synchronize()
    assert (ops.resample_many.launches, ops.resample.launches) == (before[0] + 1, before[1])
    assert got.dtype == torch.int32 and got.shape == (5, 4099) and got.device.type == "cuda"
    want = ops.resample_many_plain(*args, w_bits=w_bits, **HP)
    scores = ops.perturbed_scores(*args, w_bits=w_bits, **HP)
    _assert_same_but_near_ties(got.flatten(), want.flatten(), scores.flatten(0, 1))
    frozen = args[3] == 0
    assert torch.equal(got[frozen], args[2][frozen])
    for m in range(5):
        assert torch.equal(got[m], ops.resample(*(a[m] for a in args), w_bits=w_bits, **HP))


@pytest.mark.cuda
@pytest.mark.parametrize("mh_steps", [2, 4])
@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("k", [12, 200])
def test_batched_alias_kernel_matches_plain_and_single_launches_on_card(card, k, w_bits,
                                                                        mh_steps):
    args = _stack_inputs(5, 4099, k, w_bits, seed=k + mh_steps, device=card,
                         mh_steps=mh_steps)
    before = (alias_ops.mh_resample_many.launches, alias_ops.mh_resample.launches)
    got = alias_ops.mh_resample_many(*args, w_bits=w_bits, **HP)
    torch.cuda.synchronize()
    assert (alias_ops.mh_resample_many.launches, alias_ops.mh_resample.launches) == \
        (before[0] + 1, before[1])
    want = alias_ops.mh_resample_many_plain(*args, w_bits=w_bits, **HP)
    acc, _ = alias_ops.margins(*args, w_bits=w_bits, **HP)
    diff = got != want
    assert bool((acc[diff] < NEAR_TIE).all()) and bool((args[3][diff] > 0).all())
    assert int((got != args[2]).sum()) > 0  # the chains move
    for m in range(5):
        one = alias_ops.mh_resample(*(a[m].contiguous() for a in args), w_bits=w_bits, **HP)
        assert torch.equal(got[m], one)


@pytest.mark.cuda
def test_batched_wrappers_refuse_what_the_kernels_do_not_take(card):
    args = list(_stack_inputs(3, 256, 12, 8, seed=1, device=card))
    with pytest.raises(ValueError, match="must be torch.float32"):
        ops.resample_many(*args, **HP)  # int32 tables without w_bits
    with pytest.raises(ValueError, match=r"noise must be \(M, N, K\)"):
        ops.resample_many(*args[:7], args[7][0], w_bits=8, **HP)
    with pytest.raises(ValueError, match="count tables"):
        ops.resample_many(*args[:4], args[4][:2].contiguous(), *args[5:], w_bits=8, **HP)
    args = list(_stack_inputs(3, 256, 12, 8, seed=2, device=card, mh_steps=2))
    with pytest.raises(ValueError, match="draws must be"):
        alias_ops.mh_resample_many(*args[:11], args[11][0], *args[12:], w_bits=8, **HP)
    with pytest.raises(ValueError, match="alias_w is on cpu"):
        alias_ops.mh_resample_many(*args[:8], args[8].cpu(), *args[9:], w_bits=8, **HP)


@pytest.mark.cuda
@pytest.mark.parametrize("w_bits", [None, 8])
def test_batched_sweeps_on_card_match_cpu_sweeps_on_the_same_noise(card, w_bits):
    args = _stack_inputs(4, 3000, 12, w_bits, seed=9, device="cpu")
    cfg = types.LDAConfig(num_topics=12, vocab_size=300, num_docs=60, w_bits=w_bits)
    corpora = types.Corpus(args[0], args[1], args[3])
    state = codec.rebuild_state(cfg, corpora, args[2])
    card_corpora = types.Corpus(*(t.to(card) for t in (args[0], args[1], args[3])))
    want = ops.sweep_many(cfg, state, corpora, args[7])
    got = ops.sweep_many(cfg, state.to(card), card_corpora, args[7].to(card))
    real = codec.decode_state(cfg, state)
    scores = ops.perturbed_scores(args[0], args[1], state.z, args[3], real.n_dt, real.n_wt,
                                  real.n_t, args[7], alpha=cfg.alpha, beta=cfg.beta,
                                  beta_bar=cfg.beta_bar)
    _assert_same_but_near_ties(got.z.cpu().flatten(), want.z.flatten(), scores.flatten(0, 1))

    tables = alias.sweep_tables(cfg, real.n_dt, real.n_wt)
    gen = torch.Generator().manual_seed(2)
    draws = (torch.randint(0, 12, (4, 4, 3000), generator=gen, dtype=torch.int32),
             torch.rand((4, 4, 3000), generator=gen), torch.rand((4, 4, 3000), generator=gen))
    want_a = alias_ops.mh_sweep_many(cfg, state, corpora, draws, tables)
    got_a = alias_ops.mh_sweep_many(cfg, state.to(card), card_corpora,
                                    tuple(t.to(card) for t in draws),
                                    tuple(t.to(card) for t in tables))
    acc, _ = alias_ops.margins(args[0], args[1], state.z, args[3], state.n_dt, state.n_wt,
                               state.n_t, *tables, *draws, w_bits=w_bits, **HP)
    diff = got_a.z.cpu() != want_a.z
    assert bool((acc[diff] < NEAR_TIE).all())
    # Atomic float adds on the card may move a fixed-point rounding by a unit.
    for got_s, want_s in ((got, want), (got_a, want_a)):
        if bool((got_s.z.cpu() == want_s.z).all()):
            for f in ("n_dt", "n_wt", "n_t"):
                dev = (getattr(got_s, f).cpu().double() - getattr(want_s, f).double()).abs()
                assert float(dev.max()) <= (1.0 if w_bits is not None else 1e-4), f



# -- the exact entries' Philox mode ------------------------------------------------


@pytest.mark.cuda
def test_kernel_philox_words_equal_curand_on_card(card):
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 2 ** 32, (4096, 4), dtype=np.uint64)
    key = rng.integers(0, 2 ** 32, (4096, 2), dtype=np.uint64)
    ctr[0], key[0] = 0, 0
    ctr[1], key[1] = 2 ** 32 - 1, 2 ** 32 - 1
    as_i32 = lambda a: torch.tensor(a.astype(np.uint32).view(np.int32), device=card)  # noqa: E731
    ours, theirs = lda_kernel.philox_words(as_i32(ctr), as_i32(key))
    assert torch.equal(ours, theirs)
    want = ops.philox4x32_10_plain(torch.tensor(ctr.astype(np.int64)),
                                   torch.tensor(key.astype(np.int64)))
    assert torch.equal(ours.cpu().to(torch.int64) & 0xFFFFFFFF, want)


@pytest.mark.cuda
@pytest.mark.parametrize("many", [False, True])
@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("k,n,v", [(5, 2051, 300), (5, 131101, 300), (12, 2051, 300),
                                   (12, 131101, 300), (12, 140001, 40000), (20, 2051, 300),
                                   (20, 131101, 300), (33, 2051, 300), (128, 2051, 300),
                                   (1000, 517, 300)])
def test_both_noise_modes_match_plain_on_card(card, k, n, v, w_bits, many):
    # K <= 32: below 2^17 tokens a call takes a group of lanes a token (16,
    # or 32 above K 16) and reads the count rows, above it a thread a token
    # and the rows' log tables (with V 40,000 the tables outnumber the
    # tokens).
    if many:
        args = _stack_inputs(3, n, k, w_bits, seed=k + 1, device=card, v=v)
        key = torch.tensor([[2 ** 62 + 5, 8], [-3, 2 ** 40], [11, 0]], device=card)
        wrapper, plain = ops.resample_many, ops.resample_many_plain
        counter = ops.resample_many
    else:
        args = _inputs(n, k, w_bits, seed=k + 1, device=card, v=v)
        key = (2 ** 64 - 3, 2 ** 33 + 12)
        wrapper, plain = ops.resample, ops.resample_plain
        counter = ops.resample
    noise = ops.philox_noise(args[2], args[6], key)
    for kernel_noise, kernel_key, plain_noise in ((args[7], None, args[7]), (None, key, noise)):
        before = (counter.launches, counter.launches_philox)
        got = wrapper(*args[:7], kernel_noise, philox=kernel_key, w_bits=w_bits, **HP)
        torch.cuda.synchronize()
        assert (counter.launches, counter.launches_philox) == (
            before[0] + 1, before[1] + (kernel_key is not None))
        want = plain(*args[:7], plain_noise, w_bits=w_bits, **HP)
        scores = ops.perturbed_scores(*args[:7], plain_noise, w_bits=w_bits, **HP)
        _assert_same_but_near_ties(got.flatten(), want.flatten(), scores.reshape(-1, k))
        frozen = args[3] == 0
        assert torch.equal(got[frozen], args[2][frozen])


@pytest.mark.cuda
@pytest.mark.parametrize("many", [False, True])
def test_warp_body_past_48kb_of_shared_memory_matches_plain_on_card(card, many):
    # K 8,192, the most the entries admit: the K > 32 body's 2 K floats of
    # totals and logs take 64 KB of dynamic shared memory a block, past the
    # 48 KB a kernel has unless it is opted in.
    k, n, d, v = 8192, 4096, 64, 512
    if many:
        args = _stack_inputs(2, n, k, None, seed=7, device=card, d=d, v=v)
        key = torch.tensor([[2 ** 62 + 5, 8], [-3, 2 ** 40]], device=card)
        wrapper, plain = ops.resample_many, ops.resample_many_plain
    else:
        args = _inputs(n, k, None, seed=7, device=card, d=d, v=v)
        key = (2 ** 64 - 3, 2 ** 33 + 12)
        wrapper, plain = ops.resample, ops.resample_plain
    hp = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * v)
    noise = ops.philox_noise(args[2], args[6], key)
    for kernel_noise, kernel_key, plain_noise in ((args[7], None, args[7]), (None, key, noise)):
        got = wrapper(*args[:7], kernel_noise, philox=kernel_key, **hp)
        torch.cuda.synchronize()
        want = plain(*args[:7], plain_noise, **hp)
        scores = ops.perturbed_scores(*args[:7], plain_noise, **hp)
        _assert_same_but_near_ties(got.flatten(), want.flatten(), scores.reshape(-1, k))
        frozen = args[3] == 0
        assert torch.equal(got[frozen], args[2][frozen])


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(12, 1031), (12, 140001), (128, 1031)])
def test_unaligned_tables_take_scalar_loads_on_card(card, k, n):
    args = list(_inputs(n, k, None, seed=k, device=card))
    want = ops.resample(*args, **HP)
    shifted = []
    for t in (args[4], args[5], args[7]):  # n_dt, n_wt, noise 4 bytes off a 16-byte line
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        shifted.append(view)
    assert shifted[0].data_ptr() % 16 != 0
    args[4], args[5], args[7] = shifted
    assert torch.equal(ops.resample(*args, **HP), want)
    assert torch.equal(ops.resample(*args[:7], philox=(5, 0), **HP),
                       ops.resample(*args[:4], *(t.contiguous().clone() for t in args[4:7]),
                                    philox=(5, 0), **HP))


@pytest.mark.cuda
@pytest.mark.parametrize("w_bits", [None, 8])
def test_philox_key_advances_the_card_generator(card, w_bits):
    gen = torch.Generator(device=card).manual_seed(2 ** 64 - 1)
    seed, offset = ops.philox_key(gen)
    assert seed == 2 ** 64 - 1 and gen.get_offset() == offset + 4
    table = ops.philox_keys([gen, torch.Generator(device=card).manual_seed(7)], card)
    assert table.device.type == "cuda" and table.dtype == torch.int64
    assert table[0].tolist() == [ops._i64(2 ** 64 - 1), offset + 4]
    # A sweep on the card draws in the kernel: two sweeps from one
    # generator differ, and a clone of it replays the first exactly.
    rng = np.random.default_rng(1)
    n, d, v, k = 3000, 80, 400, 12
    cfg = types.LDAConfig(num_topics=k, vocab_size=v, num_docs=d, w_bits=w_bits)
    corpus = types.corpus_from_numpy(rng.integers(0, d, n), rng.integers(0, v, n),
                                     rng.uniform(0.1, 1.0, n), device=card)
    state = codec.rebuild_state(cfg, corpus, torch.as_tensor(rng.integers(0, k, n),
                                                             dtype=torch.int32, device=card))
    gen = torch.Generator(device=card).manual_seed(3)
    twin = torch.Generator(device=card)
    twin.set_state(gen.get_state())
    before = ops.resample.launches
    first = ops.sweep_resample(cfg, state, corpus, gen)
    second = ops.sweep_resample(cfg, state, corpus, gen)
    assert ops.resample.launches == before + 2
    assert torch.equal(first, ops.sweep_resample(cfg, state, corpus, twin))
    assert not torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("k", [12, 128])
def test_batched_sweep_equals_single_cuda_sweeps_on_card(card, k, w_bits):
    rng = np.random.default_rng(k)
    lengths = [1500, 977, 1500, 1203]
    d, v = 60, 300
    cfgs, corpora, states = [], [], []
    for n_i in lengths:
        cfg = types.LDAConfig(num_topics=k, vocab_size=v, num_docs=d, w_bits=w_bits)
        c = types.corpus_from_numpy(rng.integers(0, d, n_i), rng.integers(0, v, n_i),
                                    rng.uniform(0.1, 1.0, n_i), device=card)
        cfgs.append(cfg)
        corpora.append(c)
        states.append(codec.rebuild_state(cfg, c, torch.as_tensor(
            rng.integers(0, k, n_i), dtype=torch.int32, device=card)))
    bcfg = batch.batch_cfg(cfgs, d)
    n_pad = max(lengths)
    stacked = batch.stack_corpora(corpora, n_pad)
    stacked_states = batch.stack_states(bcfg, states, n_pad)
    gens = [torch.Generator(device=card).manual_seed(100 + i) for i in range(len(lengths))]
    twins = []
    for g in gens:
        t = torch.Generator(device=card)
        t.set_state(g.get_state())
        twins.append(t)
    before = (ops.resample_many.launches, ops.resample.launches)
    got = batch.sweep_batch(bcfg, stacked_states, stacked, gens, lengths)
    assert (ops.resample_many.launches, ops.resample.launches) == (before[0] + 1, before[1])
    for i, (cfg, c, st, twin) in enumerate(zip(cfgs, corpora, states, twins)):
        one = ops.sweep_resample(cfg, st, c, twin)
        assert torch.equal(got.z[i, : lengths[i]], one), i
        assert twin.get_offset() == gens[i].get_offset()


@pytest.mark.cuda
def test_wrappers_refuse_bad_philox_arguments_on_card(card):
    args = _inputs(256, 12, 8, seed=1, device=card)
    with pytest.raises(ValueError, match="not both"):
        ops.resample(*args, philox=(1, 0), w_bits=8, **HP)
    with pytest.raises(ValueError, match="key must be a"):
        ops.resample(*args[:7], philox=(1.5, 0), w_bits=8, **HP)
    stack = _stack_inputs(3, 256, 12, 8, seed=2, device=card)
    good = torch.zeros((3, 2), dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="not both"):
        ops.resample_many(*stack, philox=good, w_bits=8, **HP)
    for bad in (good.cpu(), good[:2], good.to(torch.int32), good.t().contiguous().t()):
        with pytest.raises(ValueError, match="key must be a contiguous int64"):
            ops.resample_many(*stack[:7], philox=bad, w_bits=8, **HP)
    with pytest.raises(ValueError, match=r"z must be \(M, N\)"):
        ops.resample_many(*(a[0] for a in stack[:7]), philox=good, w_bits=8, **HP)


# -- the alias_mh kernel's Philox mode and its two bodies -----------------------


def _alias_margins_ok(got, want, args, draws, w_bits):
    """Differences only at near-ties (accept or proposal margin below
    NEAR_TIE in some round) and never on a frozen token."""
    acc, prop = alias_ops.margins(*args[:11], *draws, w_bits=w_bits, **HP)
    diff = got != want
    near = (acc < NEAR_TIE) | (prop < NEAR_TIE)
    return bool((near[diff]).all()) and bool((args[3][diff] > 0).all())


@pytest.mark.cuda
def test_alias_kernel_philox_words_equal_curand_on_card(card):
    from repro_torch.kernels.alias_mh import kernel as alias_kernel

    rng = np.random.default_rng(1)
    ctr = rng.integers(0, 2 ** 32, (4096, 4), dtype=np.uint64)
    key = rng.integers(0, 2 ** 32, (4096, 2), dtype=np.uint64)
    ctr[0], key[0] = 0, 0
    ctr[1], key[1] = 2 ** 32 - 1, 2 ** 32 - 1
    as_i32 = lambda a: torch.tensor(a.astype(np.uint32).view(np.int32), device=card)  # noqa: E731
    ours, theirs = alias_kernel.philox_words(as_i32(ctr), as_i32(key))
    assert torch.equal(ours, theirs)
    want = ops.philox4x32_10_plain(torch.tensor(ctr.astype(np.int64)),
                                   torch.tensor(key.astype(np.int64)))
    assert torch.equal(ours.cpu().to(torch.int64) & 0xFFFFFFFF, want)


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["auto", "direct", "tables"])
@pytest.mark.parametrize("many", [False, True])
@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("k,n,s", [(12, 4099, 4), (12, 40001, 2), (33, 4099, 3),
                                   (200, 4099, 4), (1000, 1031, 2)])
def test_alias_both_draw_modes_and_bodies_match_plain_on_card(card, k, n, s, w_bits, many,
                                                             body):
    from repro_torch.kernels.alias_mh import kernel as alias_kernel

    if many:
        args = _stack_inputs(3, n, k, w_bits, seed=k + s, device=card, mh_steps=s)
        key = torch.tensor([[2 ** 62 + 5, 8], [-3, 2 ** 40], [11, 0]], device=card)
        launch, plain = alias_kernel.launch_many, alias_ops.mh_resample_many_plain
    else:
        args = _alias_inputs(n, k, w_bits, seed=k + s, device=card, mh_steps=s)
        key = (2 ** 64 - 3, 2 ** 33 + 12)
        launch, plain = alias_kernel.launch, alias_ops.mh_resample_plain
    draws = alias_ops.philox_draws(args[2], args[6], key, s)
    raw = dict(alpha=HP["alpha"], beta=HP["beta"], beta_bar=HP["beta_bar"],
               scale=1.0 if w_bits is None else 2.0 ** -(w_bits + 1), body=body)
    for kernel_draws, extra, plain_draws in (
            (args[11:], {}, args[11:]),
            ((None, None, None), dict(philox=key, mh_steps=s), draws)):
        got = torch.empty_like(args[2])
        launch(*args[:11], *kernel_draws, got, **raw, **extra)
        torch.cuda.synchronize()
        want = plain(*args[:11], *plain_draws, w_bits=w_bits, **HP)
        assert _alias_margins_ok(got, want, args, plain_draws, w_bits)
        frozen = args[3] == 0
        assert torch.equal(got[frozen], args[2][frozen])
        assert int((got != args[2]).sum()) > 0  # the chains move


@pytest.mark.cuda
@pytest.mark.parametrize("w_bits", [None, 8])
def test_alias_sweep_on_card_draws_in_the_kernel(card, w_bits):
    rng = np.random.default_rng(3)
    n, d, v, k = 5000, 80, 400, 12
    cfg = types.LDAConfig(num_topics=k, vocab_size=v, num_docs=d, w_bits=w_bits)
    cpu = types.corpus_from_numpy(rng.integers(0, d, n), rng.integers(0, v, n),
                                  rng.uniform(0.1, 1.0, n), device="cpu")
    state = codec.rebuild_state(cfg, cpu, torch.as_tensor(rng.integers(0, k, n),
                                                         dtype=torch.int32))
    gen = torch.Generator(device=card).manual_seed(2 ** 63 + 9)
    twin = torch.Generator(device=card)
    twin.set_state(gen.get_state())
    seed, offset = gen.initial_seed(), gen.get_offset()
    before = (alias_ops.mh_resample.launches, alias_ops.mh_resample.launches_philox)
    first = alias_ops.mh_sweep(cfg, state.to(card), cpu.to(card), gen, 4)
    second = alias_ops.mh_sweep(cfg, state.to(card), cpu.to(card), gen, 4)
    assert (alias_ops.mh_resample.launches, alias_ops.mh_resample.launches_philox) == \
        (before[0] + 2, before[1] + 2)
    assert gen.get_offset() == offset + 8
    assert torch.equal(first.z, alias_ops.mh_sweep(cfg, state.to(card), cpu.to(card), twin, 4).z)
    assert not torch.equal(first.z, second.z)
    # The CPU sweep on the plain Philox draws of the same key.
    draws = alias_ops.philox_mh_draws_plain(seed, offset, n, 4, k)
    want = alias_ops.mh_sweep(cfg, state, cpu, None, 4, draws=draws)
    real = codec.decode_state(cfg, state)
    args = (cpu.docs, cpu.words, state.z, cpu.weights, state.n_dt, state.n_wt, state.n_t,
            *alias.sweep_tables(cfg, real.n_dt, real.n_wt))
    assert _alias_margins_ok(first.z.cpu(), want.z, args, draws, w_bits)


@pytest.mark.cuda
@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("k", [12, 128])
def test_batched_alias_sweep_equals_single_alias_sweeps_on_card(card, k, w_bits):
    rng = np.random.default_rng(k)
    lengths = [1500, 977, 1500, 1203]
    d, v = 60, 300
    cfgs, corpora, states = [], [], []
    for n_i in lengths:
        cfg = types.LDAConfig(num_topics=k, vocab_size=v, num_docs=d, w_bits=w_bits)
        c = types.corpus_from_numpy(rng.integers(0, d, n_i), rng.integers(0, v, n_i),
                                    rng.uniform(0.1, 1.0, n_i), device=card)
        cfgs.append(cfg)
        corpora.append(c)
        states.append(codec.rebuild_state(cfg, c, torch.as_tensor(
            rng.integers(0, k, n_i), dtype=torch.int32, device=card)))
    bcfg = batch.batch_cfg(cfgs, d)
    n_pad = max(lengths)
    stacked = batch.stack_corpora(corpora, n_pad)
    stacked_states = batch.stack_states(bcfg, states, n_pad)
    gens = [torch.Generator(device=card).manual_seed(100 + i) for i in range(len(lengths))]
    twins = []
    for g in gens:
        t = torch.Generator(device=card)
        t.set_state(g.get_state())
        twins.append(t)
    before = (alias_ops.mh_resample_many.launches, alias_ops.mh_resample_many.launches_philox,
              alias_ops.mh_resample.launches)
    got = alias.run_many(bcfg, stacked_states, stacked, gens, 2, 4, lengths)
    assert (alias_ops.mh_resample_many.launches, alias_ops.mh_resample_many.launches_philox,
            alias_ops.mh_resample.launches) == (before[0] + 2, before[1] + 2, before[2])
    for i, (cfg, c, st, twin) in enumerate(zip(cfgs, corpora, states, twins)):
        for _ in range(2):
            st = alias_ops.mh_sweep(cfg, st, c, twin, 4)
        assert torch.equal(got.z[i, : lengths[i]], st.z), i
        assert twin.get_offset() == gens[i].get_offset()


@pytest.mark.cuda
def test_alias_wrappers_refuse_bad_philox_arguments_on_card(card):
    args = _alias_inputs(256, 12, 8, seed=1, device=card)
    with pytest.raises(ValueError, match="not both"):
        alias_ops.mh_resample(*args, philox=(1, 0), mh_steps=4, w_bits=8, **HP)
    with pytest.raises(ValueError, match="mh_steps >= 1"):
        alias_ops.mh_resample(*args[:11], philox=(1, 0), w_bits=8, **HP)
    with pytest.raises(ValueError, match="key must be a"):
        alias_ops.mh_resample(*args[:11], philox=(1.5, 0), mh_steps=4, w_bits=8, **HP)
    stack = _stack_inputs(3, 256, 12, 8, seed=2, device=card, mh_steps=2)
    good = torch.zeros((3, 2), dtype=torch.int64, device=card)
    for bad in (good.cpu(), good[:2], good.to(torch.int32), good.t().contiguous().t()):
        with pytest.raises(ValueError, match="key must be a contiguous int64"):
            alias_ops.mh_resample_many(*stack[:11], philox=bad, mh_steps=2, w_bits=8, **HP)


# -- the packed-table entry (lda_gibbs_resample_quant) -------------------------


def _quant_inputs(n, k, w_bits, bits, seed, device, d=60, v=300):
    """Ids, z, weights, stored n_dt, the packed word table (codes, scales),
    stored n_t and noise on `device`: `_inputs` with its word table packed."""
    from repro_torch.core import quant

    docs, words, z, weights, n_dt, n_wt, n_t, noise = _inputs(n, k, w_bits, seed, device,
                                                              d=d, v=v)
    real = n_wt.to(torch.float32) * (1.0 if w_bits is None else 2.0 ** -(w_bits + 1))
    codes, scales = quant.quantize_rows_torch(real, bits)
    if bits == 4:
        codes = quant.pack_nibbles_torch(codes)
    return docs, words, z, weights, n_dt, codes.contiguous(), scales, n_t, noise


@pytest.mark.cuda
@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", [12, 33, 200])
def test_quant_kernel_matches_plain_on_card(card, k, bits, w_bits):
    args = _quant_inputs(4099, k, w_bits, bits, seed=k + bits, device=card)
    hp = dict(HP, bits=bits, w_bits=w_bits)
    before = ops.resample_quant.launches
    got = ops.resample_quant(*args, **hp)
    torch.cuda.synchronize()
    assert ops.resample_quant.launches == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    want = ops.resample_quant_plain(*args, **hp)
    _assert_same_but_near_ties(got, want, ops.perturbed_scores_quant(*args, **hp))
    frozen = args[3] == 0
    assert torch.equal(got[frozen], args[2][frozen])


@pytest.mark.cuda
def test_quant_wrapper_refuses_what_the_kernel_does_not_take(card):
    args = _quant_inputs(256, 12, 8, 8, seed=1, device=card)
    with pytest.raises(ValueError, match="columns"):
        ops.resample_quant(*args, bits=4, w_bits=8, **HP)
    with pytest.raises(ValueError, match="codes is on cpu"):
        ops.resample_quant(*args[:5], args[5].cpu(), *args[6:], bits=8, w_bits=8, **HP)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "int4_packed"])
def test_packed_cuda_sweep_launches_the_quant_entry_and_matches_cpu(card, mode):
    from repro_torch.core.quant import QuantSpec

    rng = np.random.default_rng(4)
    n, d, v, k = 5000, 80, 400, 12
    cfg = types.LDAConfig(num_topics=k, vocab_size=v, num_docs=d, w_bits=8,
                          quant=QuantSpec(mode, w_bits=8))
    cpu = types.corpus_from_numpy(rng.integers(0, d, n), rng.integers(0, v, n),
                                  rng.uniform(0.1, 1.0, n), device="cpu")
    state = codec.rebuild_state(cfg, cpu, torch.as_tensor(rng.integers(0, k, n), dtype=torch.int32))
    noise = torch.tensor(rng.gumbel(size=(n, k)).astype(np.float32))
    want = ops.sweep(cfg, state, cpu, None, noise=noise)
    before = (ops.resample.launches, ops.resample_quant.launches)
    got = ops.sweep(cfg, state.to(card), cpu.to(card), None, noise=noise.to(card))
    torch.cuda.synchronize()
    assert (ops.resample.launches, ops.resample_quant.launches) == (before[0], before[1] + 1)
    codes, scales = ops.pack_word_table(cfg, state.n_wt)
    scores = ops.perturbed_scores_quant(cpu.docs, cpu.words, state.z, cpu.weights, state.n_dt,
                                        codes, scales, state.n_t, noise, alpha=cfg.alpha,
                                        beta=cfg.beta, beta_bar=cfg.beta_bar,
                                        bits=cfg.quant_spec.bits, w_bits=8)
    _assert_same_but_near_ties(got.z.cpu(), want.z, scores)


@pytest.mark.cuda
@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n", [4099, 2 ** 17 + 5])
@pytest.mark.parametrize("k", [12, 33, 200])
def test_quant_both_noise_modes_match_plain_on_card(card, k, n, bits, w_bits):
    # K <= 32: 4,099 tokens take a group of lanes a token, 2^17 + 5 a thread
    # a token and the log tables (lw from the codes); K > 32 a warp a token.
    args = _quant_inputs(n, k, w_bits, bits, seed=k + bits + 1, device=card)
    hp = dict(HP, bits=bits, w_bits=w_bits)
    key = (2 ** 64 - 5, 2 ** 34 + 8)
    noise = ops.philox_noise(args[2], args[7], key)
    counter = ops.resample_quant
    for kernel_noise, kernel_key, plain_noise in ((args[8], None, args[8]), (None, key, noise)):
        before = (counter.launches, counter.launches_philox)
        got = ops.resample_quant(*args[:8], kernel_noise, philox=kernel_key, **hp)
        torch.cuda.synchronize()
        assert (counter.launches, counter.launches_philox) == (
            before[0] + 1, before[1] + (kernel_key is not None))
        want = ops.resample_quant_plain(*args[:8], plain_noise, **hp)
        _assert_same_but_near_ties(got, want,
                                   ops.perturbed_scores_quant(*args[:8], plain_noise, **hp))
        frozen = args[3] == 0
        assert torch.equal(got[frozen], args[2][frozen])


@pytest.mark.cuda
@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", [1, 7, 12, 33, 128])
def test_pack_kernel_equals_plain_on_card(card, k, bits, w_bits):
    from repro_torch.core.quant import QuantSpec

    rng = np.random.default_rng(k * bits)
    v = 1001
    x = rng.gamma(0.5, 3.0, (v, k)).astype(np.float32)
    x[::7] = 0.0  # all-zero rows: scale 0, codes 0
    x[1::5, 0] = x[1::5].max(axis=1)  # a repeated row maximum
    x[3] = np.arange(k, dtype=np.float32) + 0.5  # half a step: half to even decides
    x[4] = (np.arange(k, dtype=np.float32) % 3) * 0.5
    x[5, -1] = -0.5  # clipped to 0
    if w_bits is not None:
        x = np.round(x * (1 << (w_bits + 1))).astype(np.int32)
    cfg = types.LDAConfig(num_topics=k, vocab_size=v, num_docs=10, w_bits=w_bits,
                          quant=QuantSpec("int8" if bits == 8 else "int4_packed", w_bits=w_bits))
    table = torch.tensor(x, device=card)
    before = ops.pack_word_table.launches
    codes, scales = ops.pack_word_table(cfg, table)
    torch.cuda.synchronize()
    assert ops.pack_word_table.launches == before + 1
    # Bit for bit the plain version on the card and on the CPU.
    for want_codes, want_scales in (ops.pack_word_table_plain(cfg, table),
                                    ops.pack_word_table_plain(cfg, table.cpu())):
        assert codes.dtype == want_codes.dtype and codes.shape == want_codes.shape
        assert scales.dtype == want_scales.dtype and scales.shape == want_scales.shape
        assert torch.equal(codes.cpu(), want_codes.cpu())
        assert torch.equal(scales.view(torch.int32).cpu(), want_scales.view(torch.int32).cpu())


def _lossless_inputs(n, k, w_bits, bits, seed, device, d=60, v=300):
    """Ids, z, weights and stored n_dt / n_wt / n_t whose word table packs
    without loss: integer real counts, every row's maximum the code range."""
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
    arrays = (rng.integers(0, d, n).astype(np.int32), rng.integers(0, v, n).astype(np.int32),
              rng.integers(0, k, n).astype(np.int32), weights, n_dt, n_wt, n_t)
    return tuple(torch.tensor(a, device=device) for a in arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", [12, 33])
def test_lossless_packed_philox_resample_equals_exact_on_card(card, k, bits, w_bits):
    # Both bodies at K 12 (4,099 tokens: a group of lanes a token, from the
    # codes; 2^17 + 5: a thread a token, from lw built from the codes), the
    # warp body at K 33; each against the exact entry under the same key.
    from repro_torch.core.quant import QuantSpec

    key = (12345, 2 ** 40 + 4)
    for n in (4099, 2 ** 17 + 5):
        docs, words, z, weights, n_dt, n_wt, n_t = _lossless_inputs(n, k, w_bits, bits,
                                                                    seed=k + n, device=card)
        cfg = types.LDAConfig(num_topics=k, vocab_size=n_wt.shape[0], num_docs=n_dt.shape[0],
                              w_bits=w_bits, quant=QuantSpec(
                                  "int8" if bits == 8 else "int4_packed", w_bits=w_bits))
        codes, scales = ops.pack_word_table(cfg, n_wt)
        assert torch.equal(scales, torch.ones_like(scales))
        exact = ops.resample(docs, words, z, weights, n_dt, n_wt, n_t, philox=key,
                             w_bits=w_bits, **HP)
        packed = ops.resample_quant(docs, words, z, weights, n_dt, codes, scales, n_t,
                                    philox=key, bits=bits, w_bits=w_bits, **HP)
        torch.cuda.synchronize()
        assert torch.equal(packed, exact), int((packed != exact).sum())
        assert (packed != z).any()


@pytest.mark.cuda
@pytest.mark.parametrize("w_bits", [None, 8])
@pytest.mark.parametrize("mode", ["int8", "int4_packed"])
def test_packed_cuda_sweep_draws_in_the_kernel_on_card(card, mode, w_bits):
    # A packed sweep on the card: one pack launch, one quant launch in the
    # Philox mode, no exact launch; from one generator state it equals the
    # exact sweep on a lossless table (the same key, the same noise).
    from repro_torch.core.quant import QuantSpec

    bits = 8 if mode == "int8" else 4
    docs, words, z, weights, n_dt, n_wt, n_t = _lossless_inputs(5000, 12, w_bits, bits, seed=9,
                                                                device=card)
    corpus = types.Corpus(docs, words, weights)
    state = types.LDAState(z, n_dt, n_wt, n_t)
    fields = dict(num_topics=12, vocab_size=n_wt.shape[0], num_docs=n_dt.shape[0],
                  w_bits=w_bits)
    packed_cfg = types.LDAConfig(**fields, quant=QuantSpec(mode, w_bits=w_bits))
    gen = torch.Generator(device=card).manual_seed(21)
    twins = []
    for _ in range(2):
        t = torch.Generator(device=card)
        t.set_state(gen.get_state())
        twins.append(t)
    counters = (ops.resample, ops.resample_quant, ops.pack_word_table)
    before = [c.launches for c in counters] + [ops.resample_quant.launches_philox]
    packed = ops.sweep_resample(packed_cfg, state, corpus, gen)
    torch.cuda.synchronize()
    after = [c.launches for c in counters] + [ops.resample_quant.launches_philox]
    assert [a - b for a, b in zip(after, before)] == [0, 1, 1, 1]
    exact = ops.sweep_resample(types.LDAConfig(**fields), state, corpus, twins[0])
    assert torch.equal(packed, exact)
    assert gen.get_offset() == twins[0].get_offset()
    key = ops.philox_key(twins[1])
    codes, scales = ops.pack_word_table(packed_cfg, n_wt)
    assert torch.equal(packed, ops.resample_quant(
        docs, words, z, weights, n_dt, codes, scales, n_t, philox=key, bits=bits,
        w_bits=w_bits, alpha=packed_cfg.alpha, beta=packed_cfg.beta,
        beta_bar=packed_cfg.beta_bar))


@pytest.mark.cuda
def test_quant_wrappers_refuse_bad_philox_arguments_on_card(card):
    args = _quant_inputs(256, 12, 8, 8, seed=1, device=card)
    with pytest.raises(ValueError, match="not both"):
        ops.resample_quant(*args, philox=(1, 0), bits=8, w_bits=8, **HP)
    with pytest.raises(ValueError, match="key must be a"):
        ops.resample_quant(*args[:8], philox=(1.5, 0), bits=8, w_bits=8, **HP)
    with pytest.raises(ValueError, match="codes is on cpu, z on cuda"):
        ops.resample_quant(*args[:5], args[5].cpu(), *args[6:8], philox=(1, 0), bits=8,
                           w_bits=8, **HP)
    from repro_torch.core.quant import QuantSpec

    cfg = types.LDAConfig(num_topics=12, vocab_size=300, num_docs=60, w_bits=8,
                          quant=QuantSpec.int8(w_bits=8))
    table = torch.zeros((300, 12), dtype=torch.float32, device=card)
    with pytest.raises(ValueError, match="n_wt must be a contiguous 2-D torch.int32"):
        ops.pack_word_table(cfg, table)
    with pytest.raises(ValueError, match="n_wt must be a contiguous"):
        ops.pack_word_table(cfg, table.to(torch.int32).t().contiguous().t())


# -- chunk_scan ------------------------------------------------------------


def _scan_inputs(b, s, h, dk, dv, dtype, seed, device):
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(0.6, 1.0, (b, s, h, dk)), rng.standard_normal((b, s, h, dk)) * 0.3,
              rng.standard_normal((b, s, h, dv)) * 0.3, rng.standard_normal((b, s, h, dk)) * 0.3)
    w, k, v, q = (torch.tensor(a.astype(np.float32), device=device).to(dtype) for a in arrays)
    u = torch.tensor((rng.standard_normal((h, dk)) * 0.1).astype(np.float32), device=device)
    s0 = torch.tensor((rng.standard_normal((b, h, dk, dv)) * 0.1).astype(np.float32),
                      device=device)
    return w, k, v, q, u, s0


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,dk,dv,chunk", [
    (2, 128, 2, 64, 64, 16), (1, 256, 4, 32, 32, 64), (2, 64, 1, 128, 64, 64),
    (3, 96, 2, 64, 128, 64), (2, 100, 3, 64, 64, 32), (1, 2048, 8, 64, 64, 32),
    (2, 4096, 32, 64, 64, 32),   # rwkv6-1.6b's served prefill
    (1, 512, 32, 64, 64, 32),    # B = 1
    (2, 64, 3, 20, 40, 16),      # dk 20, dv 40; rwkv6 with u None
    (1, 600, 3, 64, 128, 64),    # ragged: chunk 60, dk != dv
    (2, 100, 2, 30, 20, 32),     # ragged: chunk 25; dk 30 (rows padded to 32)
    (1, 64, 2, 128, 48, 64),     # dk 128 at chunk 64
])
@pytest.mark.parametrize("include_current", [True, False])
@pytest.mark.parametrize("with_s0", [True, False])
def test_chunk_scan_kernel_matches_plain_on_card(card, b, s, h, dk, dv, chunk,
                                                 include_current, with_s0):
    from repro_torch.kernels.chunk_scan import ops as cs_ops

    w, k, v, q, u, s0 = _scan_inputs(b, s, h, dk, dv, torch.float32, s + dk, card)
    s0 = s0 if with_s0 else None
    u = None if dk == 20 else u  # rwkv6 with no u: a bonus of zeros
    kw = dict(include_current=include_current, chunk=chunk, s0=s0)
    before = cs_ops.chunk_scan.launches
    y, st = cs_ops.chunk_scan(w, k, v, q, u, **kw)
    torch.cuda.synchronize()
    assert cs_ops.chunk_scan.launches == before + 1
    y_p, st_p = cs_ops.chunk_scan_plain(w, k, v, q, u, **kw)
    tol = 3e-5 if s <= 1000 else 1e-4
    torch.testing.assert_close(y, y_p, atol=tol, rtol=tol)
    torch.testing.assert_close(st, st_p, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,dk,dv,chunk", [
    (2, 128, 4, 64, 64, 32),
    (2, 4096, 32, 64, 64, 32), (2, 512, 32, 64, 64, 32), (1, 512, 32, 64, 64, 32),  # rwkv6's
    (2, 64, 3, 20, 40, 16),   # dv 40: v rows of 80 bytes, 16-byte copies
    (2, 100, 2, 30, 20, 32),  # dv 20: v rows of 40 bytes, scalar copies
])
@pytest.mark.parametrize("include_current", [True, False])
def test_chunk_scan_kernel_bf16_on_card(card, b, s, h, dk, dv, chunk, include_current):
    from repro_torch.kernels.chunk_scan import ops as cs_ops

    w, k, v, q, u, s0 = _scan_inputs(b, s, h, dk, dv, torch.bfloat16, 7, card)
    kw = dict(include_current=include_current, chunk=chunk, s0=s0)
    y, st = cs_ops.chunk_scan(w, k, v, q, u, **kw)
    y_p, st_p = cs_ops.chunk_scan_plain(w, k, v, q, u, **kw)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_p.float(), atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(st, st_p, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,dk,chunk", [(2, 4096, 32, 64, 32), (1, 512, 32, 64, 32),
                                            (1, 600, 3, 20, 60), (2, 100, 2, 30, 25)])
def test_chunk_scan_scratch_and_launches_on_card(card, b, s, h, dk, chunk):
    """The wrapper's scratch is the source's, and a call is two CUDA
    launches (prep, then scan) counted once."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.chunk_scan import kernel
    from repro_torch.kernels.chunk_scan import ops as cs_ops

    assert kernel.scratch_floats(b, s, h, dk, chunk) == \
        kernel._lib().chunk_scan_scratch_floats(b, s, h, dk, chunk)
    w, k, v, q, u, _ = _scan_inputs(b, s, h, dk, dk, torch.bfloat16, 3, card)
    cs_ops.chunk_scan(w, k, v, q, u, include_current=False, chunk=chunk)
    torch.cuda.synchronize()
    before = cs_ops.chunk_scan.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cs_ops.chunk_scan(w, k, v, q, u, include_current=False, chunk=chunk)
        torch.cuda.synchronize()
    assert cs_ops.chunk_scan.launches == before + 1
    kernels = {ev.key: ev.count for ev in prof.key_averages()
               if str(ev.device_type).endswith("CUDA")}
    for name in ("prep_kernel", "scan_kernel"):
        assert sum(n for key, n in kernels.items() if name in key) == 1, kernels


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,dv,want", [(2, 32, 64, 256), (1, 32, 64, 128), (2, 32, 40, 192),
                                         (2, 32, 128, 512)])
def test_chunk_scan_scan_grid_on_card(card, tmp_path, b, h, dv, want):
    """The library's `dv_block()` is the source's `kDvb`, `scan_blocks` is
    B * H * ceil(dv / dv_block) (256 at rwkv6's B 2, 128 at B 1), and the
    scan kernel the wrapper launches has that grid (the profiler's trace)."""
    import json
    import re

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.chunk_scan import kernel
    from repro_torch.kernels.chunk_scan import ops as cs_ops

    dvb = kernel.dv_block()
    assert [dvb] == [int(x) for x in re.findall(r"constexpr int kDvb = (\d+);",
                                                kernel.SOURCE.read_text())]
    assert kernel.scan_blocks(b, h, dv) == b * h * -(-dv // dvb) == want
    w, k, v, q, u, _ = _scan_inputs(b, 64, h, 64, dv, torch.bfloat16, 5, card)
    cs_ops.chunk_scan(w, k, v, q, u, include_current=False, chunk=32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cs_ops.chunk_scan(w, k, v, q, u, include_current=False, chunk=32)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    grids = [ev["args"]["grid"] for ev in events
             if ev.get("cat") == "kernel" and "scan_kernel" in ev.get("name", "")]
    assert grids == [[b * h, -(-dv // dvb), 1]]


@pytest.mark.cuda
def test_chunk_scan_wrapper_refuses_what_the_kernel_does_not_take(card):
    from repro_torch.kernels.chunk_scan import ops as cs_ops

    w, k, v, q, u, s0 = _scan_inputs(1, 64, 2, 32, 32, torch.float32, 1, card)
    kw = dict(include_current=True, chunk=32)
    with pytest.raises(ValueError, match="k is on cpu"):
        cs_ops.chunk_scan(w, k.cpu(), v, q, u, **kw)
    with pytest.raises(ValueError, match="share one type"):
        cs_ops.chunk_scan(w, k.half(), v.half(), q.half(), u, **kw)
    with pytest.raises(ValueError, match="share one type"):
        cs_ops.chunk_scan(w, k.bfloat16(), v, q, u, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cs_ops.chunk_scan(w, k.transpose(1, 2).contiguous().transpose(1, 2), v, q, u, **kw)
    with pytest.raises(ValueError, match="chunk must be"):
        cs_ops.chunk_scan(w, k, v, q, u, include_current=True, chunk=128)
    with pytest.raises(ValueError, match="s0 must be"):
        cs_ops.chunk_scan(w, k, v, q, u, include_current=True, chunk=32, s0=s0.bfloat16())
    with pytest.raises(ValueError, match="shared memory"):
        big = _scan_inputs(1, 64, 1, 256, 256, torch.float32, 2, card)
        cs_ops.chunk_scan(*big[:5], include_current=True, chunk=64)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,dk,dv,chunk", [
    (2, 4096, 80, 64, 64, 32),   # Zamba2's prefill wave, one layer
    (1, 512, 80, 64, 64, 32),    # B = 1: 16-column state slices
    (2, 1000, 4, 32, 64, 32),    # ragged: chunk 25
    (1, 600, 3, 64, 128, 64),    # ragged: chunk 60, dk != dv
    (3, 96, 2, 128, 64, 64),     # dk 128 at chunk 64
    (2, 64, 3, 20, 48, 16),      # dk 20, dv 48: three 16-column state slices
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_s0", [True, False])
def test_chunk_scan_mamba2_kernel_matches_plain_on_card(card, b, s, h, dk, dv, chunk, dtype,
                                                        with_s0):
    from repro_torch.kernels.chunk_scan import ops as cs_ops

    rng = np.random.default_rng(s + dk + int(with_s0))
    w = torch.tensor(rng.uniform(0.6, 1.0, (b, s, h)).astype(np.float32), device=card)
    k, q = (torch.tensor((rng.standard_normal((b, s, dk)) * 0.3).astype(np.float32),
                         device=card).to(dtype) for _ in range(2))
    v = torch.tensor((rng.standard_normal((b, s, h, dv)) * 0.3).astype(np.float32),
                     device=card).to(dtype)
    s0 = (torch.tensor((rng.standard_normal((b, h, dk, dv)) * 0.1).astype(np.float32),
                       device=card) if with_s0 else None)
    before = cs_ops.chunk_scan.launches
    y, st = cs_ops.chunk_scan_mamba2(w, k, q, v, chunk=chunk, s0=s0)
    torch.cuda.synchronize()
    assert cs_ops.chunk_scan.launches == before + 1
    y_p, st_p = cs_ops.chunk_scan_mamba2_plain(w, k, q, v, chunk=chunk, s0=s0)
    assert y.dtype == dtype and st.dtype == torch.float32
    if dtype == torch.bfloat16:  # the reference's bf16 tolerances
        torch.testing.assert_close(y.float(), y_p.float(), atol=5e-2, rtol=5e-2)
        torch.testing.assert_close(st, st_p, atol=2e-2, rtol=2e-2)
    else:
        tol = 3e-5 if s <= 1000 else 1e-4
        torch.testing.assert_close(y, y_p, atol=tol, rtol=tol)
        torch.testing.assert_close(st, st_p, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_chunk_scan_mamba2_wrapper_refuses_what_the_kernel_does_not_take(card):
    from repro_torch.kernels.chunk_scan import ops as cs_ops

    w = torch.rand(1, 64, 2, device=card)
    k, q = torch.randn(1, 64, 32, device=card), torch.randn(1, 64, 32, device=card)
    v = torch.randn(1, 64, 2, 32, device=card)
    with pytest.raises(ValueError, match="k is on cpu"):
        cs_ops.chunk_scan_mamba2(w, k.cpu(), q, v)
    with pytest.raises(ValueError, match="share one type"):
        cs_ops.chunk_scan_mamba2(w, k.bfloat16(), q, v)
    with pytest.raises(ValueError, match="contiguous"):
        cs_ops.chunk_scan_mamba2(w, k, q, v.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="w must be"):
        cs_ops.chunk_scan_mamba2(w[..., None].expand(1, 64, 2, 32).contiguous(), k, q, v)
    with pytest.raises(ValueError, match="chunk must be"):
        cs_ops.chunk_scan_mamba2(w, k, q, v, chunk=128)
    with pytest.raises(ValueError, match="dk <= 256"):
        cs_ops.chunk_scan_mamba2(w, torch.randn(1, 64, 300, device=card),
                                 torch.randn(1, 64, 300, device=card), v)
    with pytest.raises(ValueError, match="multiple of 4"):  # k rows are 16-byte copies
        cs_ops.chunk_scan_mamba2(w, torch.randn(1, 64, 30, device=card),
                                 torch.randn(1, 64, 30, device=card), v)
    with pytest.raises(ValueError, match="multiple of 16"):  # v slices are 16-byte copies
        cs_ops.chunk_scan_mamba2(w, k, q, torch.randn(1, 64, 2, 40, device=card))
    with pytest.raises(ValueError, match="16-byte boundary"):
        off = torch.randn(1 + v.numel(), device=card)[1:].view(v.shape)
        cs_ops.chunk_scan_mamba2(w, k, q, off)
    with pytest.raises(ValueError, match="s0 must be"):
        cs_ops.chunk_scan_mamba2(w, k, q, v, s0=torch.zeros(1, 2, 32, 32, device=card,
                                                            dtype=torch.bfloat16))


# -- decode_attn -----------------------------------------------------------


def _attn_inputs(b, s, hkv, g, hd, dtype, seed, device):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal(shape).astype(np.float32),
                              device=device).to(dtype)
                 for shape in ((b, hkv * g, hd), (b, s, hkv, hd), (b, s, hkv, hd)))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hkv,g,hd", [
    (2, 256, 2, 4, 64), (1, 128, 4, 1, 32), (2, 512, 1, 8, 128), (3, 64, 2, 2, 256),
    (2, 300, 4, 7, 128), (2, 512, 8, 1, 80), (1, 100, 2, 2, 16),
])
@pytest.mark.parametrize("cap,window", [(0.0, 0), (50.0, 0), (50.0, 40)])
def test_decode_attn_kernel_matches_plain_on_card(card, b, s, hkv, g, hd, cap, window):
    from repro_torch.kernels.decode_attn import ops as da_ops

    q, k, v = _attn_inputs(b, s, hkv, g, hd, torch.float32, b + s + hd, card)
    kw = dict(length=s - 7, pos=s - 8, window=window, cap=cap)
    before = da_ops.decode_attention.launches
    out = da_ops.decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert da_ops.decode_attention.launches == before + 1
    torch.testing.assert_close(out, da_ops.decode_attention_plain(q, k, v, **kw),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("pos,length", [(40, 41), (63, 64), (64, 65), (100, 101),
                                        (200, 201)])
@pytest.mark.parametrize("g,hd", [(2, 32), (1, 80)])
def test_decode_attn_kernel_ring_matches_plain_on_card(card, pos, length, g, hd):
    from repro_torch.kernels.decode_attn import ops as da_ops

    q, k, v = _attn_inputs(2, 64, 2, g, hd, torch.float32, pos, card)
    kw = dict(length=length, pos=pos, window=64, ring=True)
    torch.testing.assert_close(da_ops.decode_attention(q, k, v, **kw),
                               da_ops.decode_attention_plain(q, k, v, **kw),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_decode_attn_kernel_bf16_on_card(card):
    from repro_torch.kernels.decode_attn import ops as da_ops

    q, k, v = _attn_inputs(2, 4096, 32, 1, 80, torch.bfloat16, 5, card)
    kw = dict(length=4097, pos=4096, window=4096, ring=True)
    out = da_ops.decode_attention(q, k, v, **kw)
    assert out.dtype == torch.bfloat16
    # Both sides round a float32 result to bf16 once: they differ by at most one
    # bf16 unit in the last place (2^-7 of the value), which rtol 1e-2 covers.
    torch.testing.assert_close(out.float(), da_ops.decode_attention_plain(q, k, v, **kw).float(),
                               atol=1e-5, rtol=1e-2)


@pytest.mark.cuda
def test_decode_attn_wrapper_refuses_what_the_kernel_does_not_take(card):
    from repro_torch.kernels.decode_attn import ops as da_ops

    q, k, v = _attn_inputs(1, 64, 2, 2, 32, torch.float32, 1, card)
    kw = dict(length=10, pos=9)
    with pytest.raises(ValueError, match="k_cache is on cpu"):
        da_ops.decode_attention(q, k.cpu(), v, **kw)
    with pytest.raises(ValueError, match="share one type"):
        da_ops.decode_attention(q.half(), k.half(), v.half(), **kw)
    with pytest.raises(ValueError, match="share one type"):
        da_ops.decode_attention(q, k.bfloat16(), v.bfloat16(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        da_ops.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, **kw)
    with pytest.raises(ValueError, match="G <= 8"):
        q9, k9, v9 = _attn_inputs(1, 64, 1, 9, 32, torch.float32, 2, card)
        da_ops.decode_attention(q9, k9, v9, **kw)
    with pytest.raises(ValueError, match="hd <= 256"):
        qb, kb, vb = _attn_inputs(1, 16, 1, 1, 320, torch.float32, 3, card)
        da_ops.decode_attention(qb, kb, vb, **kw)
    for bad in (dict(length=0, pos=0), dict(length=0, pos=5, ring=True),
                dict(length=10, pos=40, window=8)):
        with pytest.raises(ValueError, match="no cache slot is valid"):
            da_ops.decode_attention(q, k, v, **bad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,pos,length,window,ring", [
    (2, 4096, 1000, 1001, 4096, True),   # Zamba2's ring before the wrap: later partitions masked
    (2, 4096, 4095, 4096, 4096, True),   # at the wrap
    (2, 4096, 5000, 5001, 4096, True),   # past the wrap
    (2, 4096, 100, 101, 4096, True),     # a ring written to one partition
    (2, 1000, 990, 991, 0, False),       # S not divisible by P * T
    (2, 3000, 2990, 2991, 700, False),   # a window inside the cache
    (1, 4096, 512, 513, 4096, True),     # B = 1 (the served 1 x 512 wave): its own split
    (1, 4096, 5000, 5001, 4096, True),   # B = 1 past the wrap
])
def test_decode_attn_split_matches_plain_on_card(card, dtype, b, s, pos, length, window, ring):
    """Zamba2's decode shape (B 1 or 2, Hkv 32, hd 80) split over P > 1
    partitions."""
    from repro_torch.kernels.decode_attn import ops as da_ops

    q, k, v = _attn_inputs(b, s, 32, 1, 80, dtype, pos, card)
    pl = da_ops.plan(b, s, 32, 80, q.element_size())
    assert pl.parts > 1 and pl.launches == 2
    kw = dict(length=length, pos=pos, window=window, ring=ring)
    before = da_ops.decode_attention.launches
    out = da_ops.decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert da_ops.decode_attention.launches == before + 1  # one a call, two CUDA launches
    want = da_ops.decode_attention_plain(q, k, v, **kw)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), want.float(), atol=1e-5, rtol=1e-2)
    else:
        torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,offset", [(21, 0), (36, 0), (64, 1)])
def test_decode_attn_scalar_copies_on_card(card, dtype, hd, offset):
    """Rows that are not whole 16-byte units (hd 21; hd 36 in bf16) and a
    cache view that starts off 16-byte alignment take the kernel's scalar
    copies instead of its tensor copies."""
    from repro_torch.kernels.decode_attn import ops as da_ops

    q, k, v = _attn_inputs(2, 300, 4, 2, hd, dtype, hd + offset, card)
    if offset:  # the same values, one element into a larger buffer
        k = torch.cat([k.new_zeros(offset), k.flatten()])[offset:].view(k.shape)
        v = torch.cat([v.new_zeros(offset), v.flatten()])[offset:].view(v.shape)
        assert k.data_ptr() % 16 and k.is_contiguous()
    for kw in (dict(length=290, pos=289), dict(length=331, pos=330, window=300, ring=True)):
        out = da_ops.decode_attention(q, k, v, **kw)
        want = da_ops.decode_attention_plain(q, k, v, **kw)
        if dtype == torch.bfloat16:
            torch.testing.assert_close(out.float(), want.float(), atol=1e-5, rtol=1e-2)
        else:
            torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("parts", [2, 3, 8, 43])
def test_decode_attn_merge_kernel_matches_merge_partials_on_card(card, dtype, parts):
    """The merge kernel alone over plain partials (some partitions with no
    valid slot) against `merge_partials`."""
    from repro_torch.kernels.decode_attn import kernel as da_kernel
    from repro_torch.kernels.decode_attn import ops as da_ops

    q, k, v = _attn_inputs(2, 512, 4, 7, 128, torch.float32, parts, card)
    m, l, acc = da_ops.partials_plain(q, k, v, length=200, pos=199, parts=parts,
                                      slots_per_part=-(-512 // parts))
    ws = torch.cat([acc, m[..., None], l[..., None]], -1).contiguous()
    out = torch.empty(2, 28, 128, device=card, dtype=dtype)
    da_kernel.launch_merge(ws, out)
    torch.cuda.synchronize()
    want = da_ops.merge_partials(m, l, acc)
    assert torch.isfinite(out.float()).all()
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), want.to(dtype).float(), atol=1e-5, rtol=1e-2)
    else:
        torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("s,hkv,g,hd,pos,length", [
    (448, 8, 1, 64, 130, 131),       # whisper-base's self cache (448 slots), its last step
    (1500, 8, 1, 64, 1500, 1500),    # whisper-base's encoder cache: every slot, 1500 % 64 = 28
    (2048, 8, 8, 128, 542, 543),     # llama-3.2-vision's self cache after a 512-token prompt
    (1024, 8, 8, 128, 1024, 1024),   # llama-3.2-vision's image cache: every slot, G = MAX_G
])
def test_decode_attn_served_cross_family_shapes_on_card(card, dtype, b, s, hkv, g, hd, pos,
                                                        length):
    """The four decode_attn shapes the audio and VLM decode steps give the
    kernel, self (`length = pos + 1`) and cross (`length = pos = S`)."""
    from repro_torch.kernels.decode_attn import ops as da_ops

    q, k, v = _attn_inputs(b, s, hkv, g, hd, dtype, s + pos + b, card)
    kw = dict(length=length, pos=pos)
    before = da_ops.decode_attention.launches
    out = da_ops.decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert da_ops.decode_attention.launches == before + 1
    want = da_ops.decode_attention_plain(q, k, v, **kw)
    assert torch.isfinite(out.float()).all()
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), want.float(), atol=1e-5, rtol=1e-2)
    else:
        torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)


# -- the serving paths ---------------------------------------------------------


@pytest.mark.cuda
def test_hybrid_prefill_and_decode_on_card_match_the_cpu(card):
    """The reduced Zamba2 on the card (both kernels) against the port on the
    CPU (their plain versions): same weights, same tokens."""
    from repro_torch import configs
    from repro_torch.kernels.chunk_scan import ops as cs_ops
    from repro_torch.kernels.decode_attn import ops as da_ops
    from repro_torch.models import model as M

    cfg = configs.get("zamba2-2.7b").reduced()
    params = M.init_model(cfg, seed=0, device=card)
    cpu_params = _to(params, "cpu")
    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 66)).astype(np.int32))
    before = (cs_ops.chunk_scan.launches, da_ops.decode_attention.launches)
    cache, logits = M.prefill(params, cfg, {"tokens": toks[:, :62].to(card)}, 64)
    cache_c, logits_c = M.prefill(cpu_params, cfg, {"tokens": toks[:, :62]}, 64)
    rels = [_rel(logits, logits_c)]
    for i in range(3):  # the third step wraps the 64-slot ring
        cache, logits = M.decode_step(params, cfg, cache, toks[:, 62 + i].to(card), 62 + i)
        cache_c, logits_c = M.decode_step(cpu_params, cfg, cache_c, toks[:, 62 + i], 62 + i)
        rels.append(_rel(logits, logits_c))
    torch.cuda.synchronize()
    assert (cs_ops.chunk_scan.launches, da_ops.decode_attention.launches) == (
        before[0] + cfg.num_layers, before[1] + 3 * cfg.num_layers // cfg.hybrid_attn_every)
    assert max(rels) < 0.04, rels


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _rel(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b"])
def test_cross_families_on_card_match_the_cpu(card, arch):
    """The reduced audio and VLM models on the card (decode_attn, self and
    cross) against the port on the CPU (its plain version): same weights
    (the VLM's gates set to 0.5, so its cross blocks count), same tokens and
    frames or patches; one kernel call a self and a cross layer a step."""
    from repro_torch import configs
    from repro_torch.kernels.decode_attn import ops as da_ops
    from repro_torch.models import model as M

    cfg = configs.get(arch).reduced()
    params = M.init_model(cfg, seed=0, device=card)
    if "xblk" in params:
        for gate in ("gate_attn", "gate_mlp"):
            params["xblk"][gate].fill_(0.5)
    cpu_params = _to(params, "cpu")
    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 15)).astype(np.int32))
    name, n = (("frames", cfg.encoder_tokens) if cfg.arch_type == "audio"
               else ("patches", cfg.num_frontend_tokens))
    src = torch.tensor(rng.standard_normal((2, n, cfg.d_model)).astype(np.float32) * 0.02)
    src = src.to(torch.bfloat16)
    before = da_ops.decode_attention.launches
    cache, logits = M.prefill(params, cfg, {"tokens": toks[:, :12].to(card),
                                            name: src.to(card)}, 32)
    cache_c, logits_c = M.prefill(cpu_params, cfg, {"tokens": toks[:, :12], name: src}, 32)
    rels = [_rel(logits, logits_c)]
    for i in range(3):
        cache, logits = M.decode_step(params, cfg, cache, toks[:, 12 + i].to(card), 12 + i)
        cache_c, logits_c = M.decode_step(cpu_params, cfg, cache_c, toks[:, 12 + i], 12 + i)
        rels.append(_rel(logits, logits_c))
    torch.cuda.synchronize()
    per_step = 2 * cfg.num_layers if cfg.arch_type == "audio" else cfg.num_layers
    assert da_ops.decode_attention.launches == before + 3 * per_step
    assert max(rels) < 0.04, rels
    for key in cache:
        assert _rel(cache[key], cache_c[key]) < 0.04, key


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,pos", [(2, 4126), (8, 542), (1, 542)])
@pytest.mark.parametrize("g", [7, 5])  # arctic-480b's 56 / 8 heads, llama4-maverick's 40 / 8
def test_decode_attn_served_moe_shapes_on_card(card, dtype, b, pos, g):
    """The decode_attn shapes the MoE decode steps give the kernel: Hkv 8,
    hd 128, an 8,192-slot cache, at the served waves' batches and last
    positions (2 x 4096, 8 x 512, 1 x 512 prompts, 32 new tokens)."""
    from repro_torch.kernels.decode_attn import ops as da_ops

    q, k, v = _attn_inputs(b, 8192, 8, g, 128, dtype, pos + b + g, card)
    kw = dict(length=pos + 1, pos=pos)
    before = da_ops.decode_attention.launches
    out = da_ops.decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert da_ops.decode_attention.launches == before + 1
    want = da_ops.decode_attention_plain(q, k, v, **kw)
    assert torch.isfinite(out.float()).all()
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), want.float(), atol=1e-5, rtol=1e-2)
    else:
        torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["arctic-480b", "llama4-maverick-400b-a17b"])
def test_moe_family_on_card_matches_the_cpu(card, arch):
    """The reduced MoE models, holding expert shard 1 of 2, on the card
    (decode_attn once a layer a step) against the port on the CPU: same
    weights, same tokens; logits and caches within 4%, the routing picks of
    the first MoE layer equal on both."""
    from repro_torch import configs
    from repro_torch.kernels.decode_attn import ops as da_ops
    from repro_torch.models import model as M
    from repro_torch.models import moe

    cfg = configs.expert_share(configs.get(arch).reduced(), 1, 2)
    params = M.init_model(cfg, seed=0, device=card)
    cpu_params = _to(params, "cpu")
    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 15)).astype(np.int32))
    before = da_ops.decode_attention.launches
    cache, logits = M.prefill(params, cfg, {"tokens": toks[:, :12].to(card)}, 32)
    cache_c, logits_c = M.prefill(cpu_params, cfg, {"tokens": toks[:, :12]}, 32)
    rels = [_rel(logits, logits_c)]
    for i in range(3):
        cache, logits = M.decode_step(params, cfg, cache, toks[:, 12 + i].to(card), 12 + i)
        cache_c, logits_c = M.decode_step(cpu_params, cfg, cache_c, toks[:, 12 + i], 12 + i)
        rels.append(_rel(logits, logits_c))
    torch.cuda.synchronize()
    assert da_ops.decode_attention.launches == before + 3 * cfg.num_layers
    assert max(rels) < 0.04, rels
    for key in cache:
        assert _rel(cache[key], cache_c[key]) < 0.04, key
    stack = "moe_blk" if "moe_blk" in params else "blk"
    router = params[stack]["moe"]["router"][0]
    x = torch.tensor(rng.standard_normal((24, cfg.d_model)).astype(np.float32))
    picks = [moe.route(moe.router_probs(x.to(dev), r.to(dev))[0], cfg.experts_per_token)[1]
             for dev, r in ((card, router), ("cpu", router))]
    assert torch.equal(picks[0].cpu(), picks[1])


@pytest.mark.cuda
def test_chunk_scan_kernels_refuse_a_gradient_on_card(card):
    """The kernels have no backward: under grad mode, with a CUDA input that
    requires grad, both entries raise (never a detached result); under
    `torch.no_grad` and `torch.inference_mode` they launch and match their
    plain versions."""
    from repro_torch.kernels.chunk_scan import ops as cs_ops

    w, k, v, q, u, _ = _scan_inputs(1, 64, 2, 32, 32, torch.float32, 3, card)
    wm, km, qm = w[..., 0].contiguous(), k[:, :, 0].contiguous(), q[:, :, 0].contiguous()
    calls = {
        "general": (lambda: cs_ops.chunk_scan(w, k, v, q, u, include_current=False, chunk=32),
                    lambda: cs_ops.chunk_scan_plain(w, k, v, q, u, include_current=False,
                                                    chunk=32)),
        "mamba2": (lambda: cs_ops.chunk_scan_mamba2(wm, km, qm, v, chunk=32),
                   lambda: cs_ops.chunk_scan_mamba2_plain(wm, km, qm, v, chunk=32)),
    }
    for name, (call, plain) in calls.items():
        for t in (v, k if name == "general" else km):
            t.requires_grad_(True)
            before = cs_ops.chunk_scan.launches
            with pytest.raises(RuntimeError, match="no backward"):
                call()
            assert cs_ops.chunk_scan.launches == before, name
            t.requires_grad_(False)
        v.requires_grad_(True)
        for mode in (torch.no_grad, torch.inference_mode):
            with mode():
                before = cs_ops.chunk_scan.launches
                y, st = call()
                assert cs_ops.chunk_scan.launches == before + 1
                y_p, st_p = plain()
            torch.testing.assert_close(y, y_p, atol=3e-5, rtol=3e-5)
            torch.testing.assert_close(st, st_p, atol=3e-5, rtol=3e-5)
        v.requires_grad_(False)
        # No input that requires grad: the kernel runs under grad mode too.
        before = cs_ops.chunk_scan.launches
        call()
        assert cs_ops.chunk_scan.launches == before + 1


def _train_step(cfg, params, batch, device):
    """One AdamW step of a copy of `params` on `device`: (loss, grad_norm,
    the gradients as float32 CPU tensors by path)."""
    from repro_torch.models.params import leaves
    from repro_torch.train.optim import OptConfig, make_optimizer
    from repro_torch.train.step import make_train_step

    opt = make_optimizer(OptConfig(name=cfg.optimizer, warmup_steps=1))
    seen = {}

    class Filing:
        def update(self, grads, state, p, step):
            seen.update({path: g.float().cpu() for path, g in leaves(grads)})
            return opt.update(grads, state, p, step)

    p = _copy(params, device)  # the step updates its parameters in place
    p, _, metrics = make_train_step(cfg, Filing())(
        p, opt.init(p), {k: torch.as_tensor(a, device=device) for k, a in batch.items()}, 0)
    return float(metrics["loss"]), float(metrics["grad_norm"]), seen


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-7b", "rwkv6-1.6b"])
def test_train_step_on_card_matches_the_cpu(card, arch):
    """A reduced train step on the card (the plain scans under grad, no
    kernel launched) against the port on the CPU: same weights, same bigram
    batch; the loss within 2e-3, grad_norm within 1e-2 of it and every
    gradient leaf within 0.1 of its scale with cosine >= 0.998, or, where
    bf16 noise is past those bounds on the CPU itself (its bf16 gradient
    against its float32 one), within twice that noise of the float32
    gradient."""
    from repro_torch import configs
    from repro_torch.data.lm import batches_for
    from repro_torch.kernels.chunk_scan import ops as cs_ops
    from repro_torch.models import model as M

    cfg = configs.get(arch).reduced()
    params = M.init_model(cfg, seed=0, device="cpu")
    batch = next(batches_for(cfg, 64, 2))
    before = cs_ops.chunk_scan.launches
    loss, gnorm, g = _train_step(cfg, params, batch, card)
    assert cs_ops.chunk_scan.launches == before
    loss_c, gnorm_c, g_c = _train_step(cfg, params, batch, "cpu")
    assert abs(loss - loss_c) < 2e-3, (loss, loss_c)
    assert abs(gnorm - gnorm_c) <= 1e-2 * gnorm_c, (gnorm, gnorm_c)
    g32 = None

    def rel_cos(a, b):
        a, b = a.double(), b.double()
        return (float((a - b).abs().max() / b.abs().max()),
                float((a * b).sum() / ((a * a).sum() * (b * b).sum()).sqrt()))

    for path, want in g_c.items():
        r, c = rel_cos(g[path], want)
        if r <= 0.1 and c >= 0.998:
            continue
        if g32 is None:
            wide = _copy(params, "cpu")
            for key, t in list(_flat(wide)):
                if t.dtype == torch.bfloat16:
                    _set(wide, key, t.float())
            g32 = _train_step(cfg, wide, batch, "cpu")[2]
        r_cpu, c_cpu = rel_cos(want, g32[path])
        r_card, c_card = rel_cos(g[path], g32[path])
        assert r_cpu > 0.1 or c_cpu < 0.998, (path, r, c)
        assert r_card <= 2 * r_cpu and 1 - c_card <= 2 * (1 - c_cpu), (path, r_card, r_cpu)


def _copy(tree, device):
    if isinstance(tree, dict):
        return {k: _copy(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _production_block(n, seed, device, w_bits):
    """n tokens of the production RLDA corpus (K 256, V 250,000, D 200,000)
    with its initial state's tables: int32 fixed point with `w_bits`, else
    decoded to float32 as `core.gibbs.sweep` hands them to a block."""
    from repro_torch.launch import dryrun_rlda

    cfg = dryrun_rlda.production_lda_config()
    gen = torch.Generator(device=device).manual_seed(seed)
    corpus = dryrun_rlda.synthetic_corpus(cfg, 1 << 20, gen)
    state = codec.encode_state(cfg, types.init_state(cfg, corpus, gen))
    tables = ((state.n_dt, state.n_wt, state.n_t) if w_bits is not None
              else codec.decode_counts(cfg, state))
    ids = (corpus.docs[:n], corpus.words[:n], state.z[:n], corpus.weights[:n])
    noise = ops.gumbel((n, cfg.num_topics), gen, device)
    return cfg, (*ids, *tables, noise)


@pytest.mark.cuda
@pytest.mark.parametrize("w_bits", [None, 8])
def test_production_block_matches_plain_on_card(card, w_bits):
    """Row 1's K > 32 body at the production sweep's block, (8192, K 256),
    on the production corpus's tables, in both noise modes."""
    cfg, args = _production_block(8192, 5, card, w_bits)
    hp = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta_bar, w_bits=w_bits)
    key = (2 ** 63 + 77, 2 ** 20)
    for kernel_noise, kernel_key, plain_noise in (
            (args[7], None, args[7]), (None, key, ops.philox_noise(args[2], args[6], key))):
        before = ops.resample.launches
        got = ops.resample(*args[:7], kernel_noise, philox=kernel_key, **hp)
        torch.cuda.synchronize()
        assert ops.resample.launches == before + 1
        want = ops.resample_plain(*args[:7], plain_noise, **hp)
        scores = ops.perturbed_scores(*args[:7], plain_noise, **hp)
        _assert_same_but_near_ties(got, want, scores)


@pytest.mark.cuda
def test_production_sweep_at_2_20_tokens_on_card(card, tmp_path):
    """`dryrun_rlda.run_one` at 2^20 tokens of the production config: 128
    launches a sweep of (8192, K 256) blocks, the invariants hold."""
    from repro_torch.launch import dryrun_rlda

    rec = dryrun_rlda.run_one(False, num_tokens=1 << 20, device="cuda", outdir=str(tmp_path))
    assert rec["invariants"]["ok"], rec["invariants"]
    assert rec["launches_per_sweep"] == (1 << 20) // 8192
    assert rec["peak_bytes"] > 0 and rec["sweep_ms"] > 0
