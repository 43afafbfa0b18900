"""On the card: the Gibbs kernel's Philox launches against the reference
(marked `cuda`; they skip without a card)."""

import pytest
import torch

from vbench.reference import gibbs as ref_gibbs
from vbench.reference import philox as ref_philox

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tables(gen, m, n, d, v, k, dev):
    docs = torch.randint(0, d, (m, n), generator=gen, device=dev, dtype=torch.int32)
    words = torch.randint(0, v, (m, n), generator=gen, device=dev, dtype=torch.int32)
    z = torch.randint(0, k, (m, n), generator=gen, device=dev, dtype=torch.int32)
    w = torch.rand((m, n), generator=gen, device=dev)
    w[:, ::7] = 0.0
    n_dt = torch.randint(0, 4000, (m, d, k), generator=gen, device=dev, dtype=torch.int32)
    n_wt = torch.randint(0, 4000, (m, v, k), generator=gen, device=dev, dtype=torch.int32)
    return docs, words, z, w, n_dt, n_wt, n_wt.sum(1).to(torch.int32)


@pytest.mark.parametrize("m,k", [(1, 256), (1, 12), (4, 12), (2, 40)])
def test_kernel_matches_reference(card, m, k):
    from repro_torch.kernels.lda_gibbs import ops

    gen = torch.Generator(device=card).manual_seed(5)
    n, d, v = 200_003, 500, 3000
    docs, words, z, w, n_dt, n_wt, n_t = _tables(gen, m, n, d, v, k, card)
    hp = dict(alpha=0.1, beta=0.01, beta_bar=0.01 * v, w_bits=8)
    seeds = torch.tensor([(1 << 63) + 12345 - (1 << 64) + i for i in range(m)], device=card)
    offsets = torch.tensor([8 * i for i in range(m)], device=card)
    if m == 1:
        got = ops.resample(docs[0], words[0], z[0], w[0], n_dt[0], n_wt[0], n_t[0],
                           philox=((1 << 63) + 12345, 0), **hp)[None]
    else:
        got = ops.resample_many(docs, words, z, w, n_dt, n_wt, n_t,
                                philox=torch.stack([seeds, offsets], 1).contiguous(), **hp)
    want, _ = ref_gibbs.resample(
        docs, words, z, w, n_dt, n_wt, n_t,
        lambda a, b, dt: ref_philox.gibbs_noise(seeds, offsets, a, b, k, dt),
        alpha=0.1, beta=0.01, beta_bar=0.01 * v, scale=2.0 ** -9)
    assert int((got != want).sum()) == 0
