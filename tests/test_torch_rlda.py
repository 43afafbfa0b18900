"""Port corpus preparation vs the JAX reference.

`prepare` is deterministic, so ids, hard tiers and the config must be
equal. ψ and the token weights are computed in float32 through erf,
log1p, exp and a sigmoid; XLA's and PyTorch's float32 versions of these
may differ by an ulp, so they are held to rtol 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import quality as ref_quality  # noqa: E402
from repro.core import rlda as ref_rlda  # noqa: E402
from repro.data import reviews as ref_reviews  # noqa: E402
from repro_torch.core import quality, rlda  # noqa: E402
from repro_torch.data import reviews  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


SPEC = dict(num_reviews=120, vocab_size=200, seed=3)


def test_synthetic_reviews_are_identical():
    a = ref_reviews.generate(ref_reviews.SyntheticSpec(**SPEC))
    b = reviews.generate(reviews.SyntheticSpec(**SPEC))
    assert len(a.reviews) == len(b.reviews)
    for ra, rb in zip(a.reviews, b.reviews):
        np.testing.assert_array_equal(ra.tokens, rb.tokens)
        assert (ra.rating, ra.user, ra.helpful, ra.unhelpful, ra.writing_quality) == \
            (rb.rating, rb.user, rb.helpful, rb.unhelpful, rb.writing_quality)
    np.testing.assert_array_equal(a.relevant, b.relevant)


@pytest.mark.parametrize("w_bits", [None, 8])
def test_prepare_matches_reference(w_bits):
    revs = reviews.generate(reviews.SyntheticSpec(**SPEC)).reviews
    ref_revs = ref_reviews.generate(ref_reviews.SyntheticSpec(**SPEC)).reviews
    want = ref_rlda.prepare(ref_revs, base_vocab=200, num_topics=6, w_bits=w_bits)
    got = rlda.prepare(revs, base_vocab=200, num_topics=6, w_bits=w_bits, device="cpu")

    for f in ("docs", "words"):
        g = getattr(got.corpus, f)
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want.corpus, f)))
    np.testing.assert_array_equal(got.tiers, want.tiers)
    assert got.cfg.__dict__ == want.cfg.__dict__ | {"quant": None}
    assert got.base_vocab == want.base_vocab
    for f in ("ratings", "helpful", "unhelpful"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    # float32 transcendental functions: an ulp apart at most.
    np.testing.assert_allclose(got.psi, want.psi, rtol=1e-6)
    # Each tier probability is a difference of two CDF values in [0, 1]:
    # an ulp of the CDF near 1 (1.2e-7) on each side bounds it absolutely.
    np.testing.assert_allclose(got.tier_probs, want.tier_probs, rtol=0, atol=2.4e-7)
    assert got.corpus.weights.dtype == torch.float32
    np.testing.assert_allclose(got.corpus.weights.numpy(),
                               np.asarray(want.corpus.weights), rtol=1e-6)


def test_tier_probabilities_match_reference():
    rng = np.random.default_rng(0)
    r = rng.integers(1, 6, 300).astype(np.float64)
    b = rng.normal(0, 0.5, 300)
    v = rng.gamma(1.0, 0.3, 300)
    want = np.asarray(ref_rlda.tier_probabilities(jnp.asarray(r), jnp.asarray(b), jnp.asarray(v)))
    got = rlda.tier_probabilities(r, b, v)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, rtol=1e-6)


def test_user_bias_stats_and_augmentation_match_reference():
    rng = np.random.default_rng(1)
    ratings = rng.integers(1, 6, 200).astype(np.float64)
    users = rng.integers(0, 30, 200)
    for g, w in zip(rlda.user_bias_stats(ratings, users),
                    ref_rlda.user_bias_stats(ratings, users)):
        np.testing.assert_array_equal(g, w)
    words = rng.integers(0, 50, 40)
    tiers = rng.integers(0, 5, 40)
    aug = rlda.augment_word(words, tiers)
    np.testing.assert_array_equal(aug, ref_rlda.augment_word(words, tiers))
    base, tier = rlda.strip_rating(aug)
    np.testing.assert_array_equal(base, words)
    np.testing.assert_array_equal(tier, tiers)


def test_quality_model_matches_reference():
    rng = np.random.default_rng(2)
    nu = rng.uniform(0, 1, 80)
    u = rng.poisson(2, 80)
    h = rng.poisson(3, 80)
    labels = (nu + 0.1 * h - 0.1 * u + rng.normal(0, 0.2, 80) > 0.6).astype(np.float64)
    np.testing.assert_allclose(
        quality.predict(quality.default_model(), nu, u, h).numpy(),
        np.asarray(ref_quality.predict(ref_quality.default_model(), nu, u, h)), rtol=1e-6)
    # 200 full-batch steps in float32: the analytic gradient and the
    # reference's autodiff round differently, by float32 ulps a step.
    got = quality.train(nu, u, h, labels, steps=200)
    want = ref_quality.train(nu, u, h, labels, steps=200)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got.b), float(want.b), rtol=1e-5, atol=1e-6)
    assert quality.accuracy(got, nu, u, h, labels) == \
        ref_quality.accuracy(want, nu, u, h, labels)
