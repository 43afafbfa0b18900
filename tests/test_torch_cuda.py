"""The Hopper kernels (lda_gibbs, alias_mh, single-model and batched) on
the card, against their plain versions.

Every test here needs a CUDA card (marker `cuda`) and skips without one;
this file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: each kernel's topics equal its plain version's on every token
except near-ties, where CUDA's `logf` and PyTorch's `log` could differ by
an ulp: a top-2 margin of score + noise below 1e-5 for lda_gibbs, an
accept margin |log u - log a| below 1e-5 in some round for alias_mh.
A batched launch equals the single-model launches on each model's own
rows exactly: both entries run the same kernel body.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import alias, codec, types  # noqa: E402
from repro_torch.kernels.alias_mh import ops as alias_ops  # noqa: E402
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

