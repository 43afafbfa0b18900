"""The Hopper kernels (lda_gibbs, alias_mh) on the card, against their
plain versions.

Every test here needs a CUDA card (marker `cuda`) and skips without one;
this file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: each kernel's topics equal its plain version's on every token
except near-ties, where CUDA's `logf` and PyTorch's `log` could differ by
an ulp: a top-2 margin of score + noise below 1e-5 for lda_gibbs, an
accept margin |log u - log a| below 1e-5 in some round for alias_mh.
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
