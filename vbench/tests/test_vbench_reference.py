"""The plain reference agrees with the port's plain CPU path on a tiny
corpus, and its bfloat16 control does not."""

import pytest
import torch

from repro_torch.core import alias as port_alias
from repro_torch.core import codec
from repro_torch.core.types import Corpus, LDAConfig
from repro_torch.kernels.alias_mh import ops as alias_ops
from repro_torch.kernels.lda_gibbs import ops as gibbs_ops
from vbench.check import TIE
from vbench.reference import alias as ref_alias
from vbench.reference import counts as ref_counts
from vbench.reference import gibbs as ref_gibbs
from vbench.reference import philox as ref_philox

BIG = (1 << 63) + 12345  # a seed past 63 bits


def _i64(x):
    return x - (1 << 64) if x >= 1 << 63 else x


def _model(m, n, d, v, k, seed=5):
    gen = torch.Generator().manual_seed(seed)
    docs = torch.randint(0, d, (m, n), generator=gen, dtype=torch.int32)
    words = torch.randint(0, v, (m, n), generator=gen, dtype=torch.int32)
    z = torch.randint(0, k, (m, n), generator=gen, dtype=torch.int32)
    w = torch.rand((m, n), generator=gen)
    w[:, ::7] = 0.0
    n_dt = torch.randint(0, 4000, (m, d, k), generator=gen, dtype=torch.int32)
    n_wt = torch.randint(0, 4000, (m, v, k), generator=gen, dtype=torch.int32)
    return docs, words, z, w, n_dt, n_wt, n_wt.sum(1).to(torch.int32)


def test_noise_is_the_ports():
    for seed, offset in ((0, 0), (BIG, 8), (2**31 + 7, 2**40 + 4)):
        want = gibbs_ops.philox_gumbel_plain(seed, offset, 37, 13, start=5)
        got = ref_philox.gibbs_noise(torch.tensor([_i64(seed)]), torch.tensor([_i64(offset)]),
                                     5, 42, 13)[0]
        assert torch.equal(got, want)


@pytest.mark.parametrize("m,k", [(1, 256), (1, 40), (3, 12)])
def test_gibbs_reference_is_the_ports_plain_path(m, k):
    v = 300
    docs, words, z, w, n_dt, n_wt, n_t = _model(m, 3001, 50, v, k)
    seeds = torch.tensor([_i64(BIG) + i for i in range(m)])
    offsets = torch.tensor([8 * i for i in range(m)])
    hp = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * v)
    want = gibbs_ops.resample_many(docs, words, z, w, n_dt, n_wt, n_t, w_bits=8,
                                   philox=torch.stack([seeds, offsets], 1).contiguous(), **hp)
    got, margin = ref_gibbs.resample(
        docs, words, z, w, n_dt, n_wt, n_t,
        lambda a, b, dt: ref_philox.gibbs_noise(seeds, offsets, a, b, k, dt), scale=2.0**-9, **hp)
    assert torch.equal(got, want)
    assert bool((margin[w > 0] >= 0).all()) and bool(torch.isinf(margin[w == 0]).all())
    if m == 1:
        single = gibbs_ops.resample(docs[0], words[0], z[0], w[0], n_dt[0], n_wt[0], n_t[0],
                                    philox=(BIG, 0), w_bits=8, **hp)
        assert torch.equal(single, got[0])


def test_alias_reference_is_the_ports_plain_path():
    k, v, d = 40, 300, 50
    docs, words, z, w, n_dt, n_wt, n_t = (x[0] for x in _model(1, 5000, d, v, k, seed=9))
    cfg = LDAConfig(num_topics=k, vocab_size=v, num_docs=d, w_bits=8)
    sc = codec.codec_for(cfg)
    tables = port_alias.sweep_tables(cfg, sc.decode_array(n_dt), sc.decode_array(n_wt))
    want = alias_ops.mh_resample(docs, words, z, w, n_dt, n_wt, n_t, *tables, alpha=0.1,
                                 beta=0.01, beta_bar=0.01 * v, w_bits=8, philox=(BIG, 4),
                                 mh_steps=4)
    got, _ = ref_alias.resample(
        docs, words, z, w, n_dt, n_wt, n_t,
        lambda a, b: ref_alias.philox_draws(_i64(BIG), 4, a, b, 4, k, "cpu"),
        alpha=0.1, beta=0.01, beta_bar=0.01 * v, scale=2.0**-9)
    assert torch.equal(got, want)
    for mine, theirs in zip(ref_alias.tables(sc.decode_array(n_wt) + 0.01), tables[:2]):
        assert torch.equal(mine, theirs)


def test_rebuild_deviation_holds_the_ports_rebuild():
    k, v, d = 12, 300, 50
    docs, words, z, w, *_ = (x[0] for x in _model(1, 20000, d, v, k, seed=3))
    cfg = LDAConfig(num_topics=k, vocab_size=v, num_docs=d, w_bits=8)
    state = codec.rebuild_state(cfg, Corpus(docs, words, w), z)
    ref = ref_counts.rebuild(docs[None], words[None], z[None], w[None], d, v, k)
    stacked = type(state)(*(getattr(state, f)[None] for f in ("z", "n_dt", "n_wt", "n_t")))
    assert ref_counts.deviation(stacked, ref, 8) <= 1.0
    stacked.n_wt[0, 3, 2] += 2  # two stored units off
    assert ref_counts.deviation(stacked, ref, 8) > 2.0


@pytest.mark.parametrize("k", [256, 12])
def test_the_bfloat16_control_fails_the_gibbs_comparison(k):
    """The control at a test's size: the reference in bfloat16 in the
    program's place leaves many tokens off the float32 reference."""
    v = 300
    docs, words, z, w, n_dt, n_wt, n_t = _model(2, 5000, 50, v, k, seed=11)
    keys = (torch.tensor([_i64(BIG), 3]), torch.tensor([0, 4]))
    hp = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * v, scale=2.0**-9)

    def noise(a, b, dt):
        return ref_philox.gibbs_noise(*keys, a, b, k, dt)

    want, margin = ref_gibbs.resample(docs, words, z, w, n_dt, n_wt, n_t, noise, **hp)
    low, _ = ref_gibbs.resample(docs, words, z, w, n_dt, n_wt, n_t, noise,
                                dtype=torch.bfloat16, **hp)
    assert int(((low != want) & (w > 0) & (margin >= TIE)).sum()) > 50


def test_the_bfloat16_control_fails_the_alias_comparison():
    k, v, d = 256, 300, 50
    docs, words, z, w, n_dt, n_wt, n_t = (x[0] for x in _model(1, 5000, d, v, k, seed=13))

    def draws(a, b):
        return ref_alias.philox_draws(7, 4, a, b, 4, k, "cpu")

    hp = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * v, scale=2.0**-9)
    want, margin = ref_alias.resample(docs, words, z, w, n_dt, n_wt, n_t, draws, **hp)
    low, _ = ref_alias.resample(docs, words, z, w, n_dt, n_wt, n_t, draws,
                                dtype=torch.bfloat16, **hp)
    assert int(((low != want) & (w > 0) & (margin >= TIE)).sum()) > 20


# The hybrid language model (`reference.hybrid`) against the port's
# serving path on the CPU, at zamba2-2.7b's smoke-test widths.


def _hybrid(seed=5):
    import json
    from pathlib import Path

    from _tiny import TINY

    from vbench import harness

    home = Path(harness.__file__).parent
    cfg = json.loads((home / "configs" / "zamba2-2.7b.json").read_text())
    cfg.update(TINY["zamba2.serve.docqa"])
    lm = harness.load_module(home / "inputs" / "lm_weights.py").make(cfg, seed, "cpu")
    return cfg, lm


def _served_logits(lm, params, tokens, plen, cache_len=64):
    """The port's prefill of tokens[:, :plen] and its decode steps through
    the cache over the rest: the logits before each token from plen on."""
    from repro_torch.models import model as lm_model

    cache, logits = lm_model.prefill(params, lm.cfg, {"tokens": tokens[:, :plen].int()},
                                     cache_len)
    out = [logits]
    for pos in range(plen, tokens.shape[1] - 1):
        cache, logits = lm_model.decode_step(params, lm.cfg, cache, tokens[:, pos].int(), pos)
        out.append(logits)
    return torch.stack(out, 1)


def _dev(got, want):
    return float(((got - want).abs().max(-1).values / want.std(-1)).max())


@pytest.mark.parametrize("plen", [30, 58])  # inside the 64-slot window, and past it at decode
def test_hybrid_reference_matches_prefill_then_decode(plen):
    """Float32 weights on both sides, so only the order of sums differs
    (the chunked scans, the blocked attention, the ring): the logits agree
    to 1e-4 of each row's standard deviation (5e-6 measured)."""
    from vbench.reference import hybrid

    from repro_torch.models import params as plib

    cfg, lm = _hybrid()
    params = plib.map_tree(lambda t: t.float(), lm.params)
    tokens = torch.randint(0, cfg["vocab_size"], (3, plen + 8),
                           generator=torch.Generator().manual_seed(3))
    got = _served_logits(lm, params, tokens, plen)
    want = hybrid.logits(params, cfg, tokens[:, :-1], got.shape[1])
    assert _dev(got, want) < 1e-4


def test_hybrid_mixer_matches_the_ports_mamba2_layer():
    """One Mamba2 layer from a normed input, float32 on both sides: the
    reference's mixer and the port's `ssm.mamba2_mix` (the plain scan at
    chunk 20) give the same output and last state to 1e-5 of their norms;
    the bfloat16-state control does not."""
    from vbench.reference import hybrid

    from repro_torch.models import params as plib
    from repro_torch.models import ssm

    cfg, lm = _hybrid()
    params = plib.map_tree(lambda t: t.float(), lm.params)
    p = hybrid.layer(params["blk"], 0, 1)
    gen = torch.Generator().manual_seed(5)
    h = torch.randn(2, 300, cfg["d_model"], generator=gen)
    y, (state, _) = ssm.mamba2_mix(p, h, None, None, lm.cfg, chunk=20, use_kernel=False)
    want_y, want_s = hybrid.mixer(p, h, cfg)
    rel = lambda got, want: float((got - want).norm() / want.norm())  # noqa: E731
    assert rel(y, want_y) < 1e-5 and rel(state, want_s) < 1e-5
    low_y, low_s = hybrid.mixer(p, h, cfg, state_dtype=torch.bfloat16)
    assert rel(low_s, want_s) > 1e-3


def test_hybrid_control_is_far_from_the_reference():
    """The fp8 control lies an order of magnitude further from the float32
    reference than the port's bfloat16 path does."""
    from vbench.reference import hybrid

    cfg, lm = _hybrid()
    tokens = torch.randint(0, cfg["vocab_size"], (3, 48), generator=torch.Generator().manual_seed(4))
    want = hybrid.logits(lm.params, cfg, tokens[:, :-1], 8)
    port = _dev(_served_logits(lm, lm.params, tokens, 40), want)
    fp8 = _dev(hybrid.logits(lm.params, cfg, tokens[:, :-1], 8,
                             matmul_dtype=torch.float8_e4m3fn), want)
    assert 0 < port < 0.3 and fp8 > 5 * port


def test_hybrid_scans_agree():
    """The chunked scan, the token-by-token one and the port's plain Mamba2
    scan evaluate one recurrence (float32: 1e-5 of the largest output)."""
    from vbench.reference import hybrid

    from repro_torch.kernels.chunk_scan import ops as scan_ops

    gen = torch.Generator().manual_seed(6)
    b, t, h, n, p = 2, 100, 3, 8, 5
    a = torch.rand(b, t, h, generator=gen) * 0.5 + 0.5
    k, q = torch.randn(b, t, n, generator=gen), torch.randn(b, t, n, generator=gen)
    v = torch.randn(b, t, h, p, generator=gen)
    chunked, last = hybrid.scan(a, k, q, v, chunk=16)
    stepwise, step_last = hybrid.scan_stepwise(a, k, q, v)
    port, _ = scan_ops.chunk_scan_mamba2_plain(a, k, q, v, chunk=20)
    scale = float(stepwise.abs().max())
    assert float((chunked - stepwise).abs().max()) < 1e-5 * scale
    assert float((last - step_last).abs().max()) < 1e-5 * float(step_last.abs().max())
    assert float((port - stepwise).abs().max()) < 1e-5 * scale
    low, _ = hybrid.scan_stepwise(a, k, q, v, torch.bfloat16)
    assert float((low - stepwise).abs().max()) > 1e-3 * scale
