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
