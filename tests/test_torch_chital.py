"""The port's Chital marketplace (`repro_torch.chital`) vs the JAX package.

The marketplace leaves are host code that imports no jax; the port keeps
its own copies. Held here, on the same inputs made from a numpy seed:
  * `simulator.run` equals the reference's field for field, task record
    for task record, and credit for credit, for every matcher;
  * Eq. (6) (`verification_probability`), its sole-submission case,
    `evaluate`, the credit ledger and the lottery give equal results;
  * a `Marketplace` with a deterministic runtime gives the same records
    and ledger;
  * `client_runtime` and `release_losers` against a port server: the cases
    of the reference's `tests/test_chital_runtime.py`.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.chital.credit as ref_credit  # noqa: E402
import repro.chital.lottery as ref_lottery  # noqa: E402
import repro.chital.marketplace as ref_marketplace  # noqa: E402
import repro.chital.matching as ref_matching  # noqa: E402
import repro.chital.simulator as ref_simulator  # noqa: E402
import repro.chital.verification as ref_verification  # noqa: E402
from repro_torch.api import VedaliaClient  # noqa: E402
from repro_torch.chital import credit, lottery, marketplace, matching, simulator  # noqa: E402
from repro_torch.chital import verification  # noqa: E402
from repro_torch.chital.runtime import client_runtime, release_losers  # noqa: E402
from repro_torch.data import reviews as reviews_data  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


SIM_FIELDS = ("honest_credit", "malicious_credit", "honest_verification_rate",
              "malicious_involved_verification_rate", "mean_time_saved", "mean_speedup",
              "rejected_rate", "matched_rate")


def _records(mp):
    return [dataclasses.asdict(r) for r in mp.history]


@pytest.mark.parametrize("spec", [
    dict(num_sellers=30, num_queries=150, malicious_frac=0.2, seed=0),
    dict(num_sellers=6, num_queries=80, malicious_frac=0.5, arrival_rate=20.0, seed=3),
], ids=["default_mix", "scarce_sellers"])
@pytest.mark.parametrize("matcher", sorted(matching.MATCHERS))
def test_simulator_equals_the_reference(matcher, spec):
    port = simulator.run(simulator.SimSpec(matcher=matcher, **spec))
    ref = ref_simulator.run(ref_simulator.SimSpec(matcher=matcher, **spec))
    for field in SIM_FIELDS:
        assert getattr(port, field) == getattr(ref, field), field
    assert _records(port.marketplace) == _records(ref.marketplace)
    assert dict(port.marketplace.ledger.credits) == dict(ref.marketplace.ledger.credits)
    assert dict(port.marketplace.lottery.tickets) == dict(ref.marketplace.lottery.tickets)
    assert port.marketplace.verification_rate() == ref.marketplace.verification_rate()


def test_eq6_and_sole_submission_equal_the_reference():
    rng = np.random.default_rng(0)
    for c1, c2, p1, p2 in zip(rng.uniform(-10, 10, 200), rng.uniform(-10, 10, 200),
                              rng.uniform(1, 1e4, 200), rng.uniform(1, 1e4, 200)):
        assert verification.verification_probability(c1, c2, p1, p2) \
            == ref_verification.verification_probability(c1, c2, p1, p2)
        assert verification.sole_submission_verification_probability(c1, c2) \
            == ref_verification.sole_submission_verification_probability(c1, c2)


def _submissions(module, rng, n):
    """n random submission pairs (some invalid, some with a far-off
    converged perplexity) of `module`'s `Submission` class."""
    out = []
    for i in range(n):
        pair = []
        for j in range(2):
            ppx = float(rng.uniform(50, 500))
            pair.append(module.Submission(
                seller_id=2 * i + j, perplexity=ppx, tokens_processed=int(rng.integers(1, 5000)),
                iterations=int(rng.integers(1, 50)), valid=bool(rng.random() > 0.15),
                converged_perplexity=ppx * float(rng.choice([1.0, 1.01, 1.5]))))
        out.append(pair)
    return out


def test_evaluate_equals_the_reference():
    port_subs = _submissions(verification, np.random.default_rng(1), 300)
    ref_subs = _submissions(ref_verification, np.random.default_rng(1), 300)
    credits = np.random.default_rng(2).uniform(-3, 3, (300, 2))
    port_rng, ref_rng = np.random.default_rng(5), np.random.default_rng(5)
    reasons = set()
    for (a, b), (ra, rb), (c1, c2) in zip(port_subs, ref_subs, credits):
        got = verification.evaluate(a, b, c1, c2, port_rng, deviation_tol=0.05)
        want = ref_verification.evaluate(ra, rb, c1, c2, ref_rng, deviation_tol=0.05)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        reasons.add(got.reason.split(":")[0])
    # Every stage of the pipeline was reached.
    assert {"accepted unverified", "accepted verified", "rejected",
            "both failed validation"} <= reasons


def test_credit_and_lottery_equal_the_reference():
    rng = np.random.default_rng(3)
    ops = [(int(a), int(b), float(x)) for a, b, x in zip(
        rng.integers(0, 12, 500), rng.integers(0, 12, 500), rng.uniform(0, 3, 500))]
    port, ref = credit.CreditLedger(), ref_credit.CreditLedger()
    for a, b, x in ops:
        port.transfer(a, b, x)
        ref.transfer(a, b, x)
        port.settle_pair(b, a)
        ref.settle_pair(b, a)
    assert dict(port.credits) == dict(ref.credits)
    assert port.total() == ref.total()

    port_lot, ref_lot = lottery.Lottery(), ref_lottery.Lottery()
    for seller, tokens, iters in zip(rng.integers(0, 9, 60), rng.integers(1, 4000, 60),
                                     rng.integers(1, 40, 60)):
        assert port_lot.award(int(seller), int(tokens), int(iters)) \
            == ref_lot.award(int(seller), int(tokens), int(iters))
    assert dict(port_lot.tickets) == dict(ref_lot.tickets)
    assert port_lot.draw(np.random.default_rng(7), 10.0) \
        == ref_lot.draw(np.random.default_rng(7), 10.0)
    assert not port_lot.tickets and not ref_lot.tickets
    assert lottery.tickets_for(123, 7) == ref_lottery.tickets_for(123, 7)


def _deterministic_runtime(module):
    """A runtime that is a function of (seller, buyer) alone: honest sellers
    report their converged perplexity, dishonest ones a phony low one."""

    def runtime(seller, buyer):
        true = 200.0 + (buyer.buyer_id * 37 % 101) + seller.seller_id % 7
        reported = true if seller.honest else 0.6 * true
        return module.Submission(
            seller_id=seller.seller_id, perplexity=reported,
            tokens_processed=buyer.task_tokens, iterations=10,
            converged_perplexity=true)

    return runtime


@pytest.mark.parametrize("matcher", sorted(matching.MATCHERS))
def test_marketplace_with_a_deterministic_runtime_equals_the_reference(matcher):
    rng = np.random.default_rng(11)
    speeds = rng.uniform(2000, 20000, 10)
    sides = {}
    for name, match_mod, mp_mod, ver in (
            ("port", matching, marketplace, verification),
            ("ref", ref_matching, ref_marketplace, ref_verification)):
        sellers = [match_mod.Seller(seller_id=i, speed=float(s), honest=i >= 3)
                   for i, s in enumerate(speeds)]
        mp = mp_mod.Marketplace(matcher=match_mod.MATCHERS[matcher](),
                                runtime=_deterministic_runtime(ver), sellers=sellers[:8],
                                seed=4)
        mp.opt_in(sellers[8])
        mp.opt_in(sellers[9])
        now = 0.0
        for q in range(120):
            now += 0.05
            rec = mp.submit(match_mod.BuyerRequest(
                buyer_id=10_000 + q, task_tokens=1000 + 37 * q, arrival=now,
                local_speed=1500.0), now=now)
            assert rec is mp.history[-1]  # submit always returns its record
        sides[name] = mp
    port, ref = sides["port"], sides["ref"]
    assert _records(port) == _records(ref)
    assert dict(port.ledger.credits) == dict(ref.ledger.credits)
    assert abs(port.ledger.total()) < 1e-9
    for metric in ("matched_rate", "verification_rate", "mean_time_saved"):
        assert getattr(port, metric)() == getattr(ref, metric)()
    assert 0.0 < port.matched_rate() < 1.0  # both fallbacks and matches seen


# -- client_runtime / release_losers against a port server ---------------------


def _reviews(n=25, vocab=120, seed=0):
    return reviews_data.generate(reviews_data.SyntheticSpec(
        num_reviews=n, vocab_size=vocab, num_topics=4, mean_tokens=25, seed=seed)).reviews


@pytest.fixture()
def client():
    return VedaliaClient(device="cpu", backend="jnp", num_sweeps=4, update_sweeps=1)


@pytest.fixture()
def corpus_ids(client):
    prep = client.prepare(_reviews(seed=0), base_vocab=120, num_topics=4)
    return {7: prep.corpus_id}


def _buyer(buyer_id=7, task_tokens=1234):
    return matching.BuyerRequest(buyer_id=buyer_id, task_tokens=task_tokens, arrival=0.0,
                                 local_speed=100.0)


def test_runtime_fits_by_reference(client, corpus_ids):
    runtime = client_runtime(client, corpus_ids, max_sweeps=6, min_sweeps=2)
    sub = runtime(matching.Seller(seller_id=3, speed=2000.0), _buyer())
    assert isinstance(sub, verification.Submission)
    assert sub.seller_id == 3
    assert sub.iterations == 5  # speed/400, inside the clamp
    assert sub.tokens_processed == 1234
    assert np.isfinite(sub.perplexity) and sub.perplexity > 0
    assert sub.converged_perplexity == sub.perplexity  # honest seller
    # The payload is a *served* handle: the model lives server-side.
    assert sub.payload in client.server.service.handles
    assert client.sync_view(sub.payload).valid


def test_sweep_budget_clamps_to_device_speed(client, corpus_ids):
    runtime = client_runtime(client, corpus_ids, max_sweeps=6, min_sweeps=2)
    slow = runtime(matching.Seller(seller_id=1, speed=100.0), _buyer())
    fast = runtime(matching.Seller(seller_id=2, speed=1e7), _buyer())
    assert slow.iterations == 2  # floor: even a phone finishes the task
    assert fast.iterations == 6  # ceiling: no free extra convergence
    assert slow.payload != fast.payload  # distinct served handles


def test_distinct_sellers_fit_distinct_handles(client, corpus_ids):
    runtime = client_runtime(client, corpus_ids, max_sweeps=4, min_sweeps=2)
    a = runtime(matching.Seller(seller_id=1, speed=1600.0), _buyer())
    b = runtime(matching.Seller(seller_id=2, speed=1600.0), _buyer())
    assert a.payload != b.payload  # seeded per seller -> separate models
    assert a.perplexity != pytest.approx(b.perplexity, rel=1e-9)


def _result(winner, loser):
    return verification.EvaluationResult(winner=winner, loser=loser, verification_prob=0.1,
                                         verified=False, rejected=False, reason="selection")


def test_release_losers_frees_exactly_the_loser(client, corpus_ids):
    runtime = client_runtime(client, corpus_ids, max_sweeps=4, min_sweeps=2)
    a = runtime(matching.Seller(seller_id=1, speed=1600.0), _buyer())
    b = runtime(matching.Seller(seller_id=2, speed=800.0), _buyer())
    release_losers(client, _result(winner=a, loser=b))
    handles = client.server.service.handles
    assert a.payload in handles
    assert b.payload not in handles
    assert client.sync_view(a.payload).valid  # the winner still serves


def test_release_losers_tolerates_missing_loser(client, corpus_ids):
    runtime = client_runtime(client, corpus_ids, max_sweeps=4, min_sweeps=2)
    a = runtime(matching.Seller(seller_id=1, speed=1600.0), _buyer())
    release_losers(client, _result(winner=a, loser=None))  # no-op
    payloadless = verification.Submission(seller_id=9, perplexity=1.0, tokens_processed=1,
                                          iterations=1, payload=None)
    release_losers(client, _result(winner=a, loser=payloadless))  # no-op
    assert a.payload in client.server.service.handles


def test_marketplace_settles_real_fits_through_a_port_server(client, corpus_ids):
    """The runtime inside a `Marketplace`: two real fits by reference, the
    lower perplexity wins, the loser's handle is freed, credit moves."""
    mp = marketplace.Marketplace(
        matcher=matching.GreedyGainMatcher(),
        runtime=client_runtime(client, corpus_ids, max_sweeps=4, min_sweeps=2),
        sellers=[matching.Seller(seller_id=i, speed=1600.0 * (i + 1)) for i in range(3)],
        seed=0)
    rec = mp.submit(_buyer())
    assert rec.matched and rec.result.winner is not None
    release_losers(client, rec.result)
    assert rec.result.winner.payload in client.server.service.handles
    assert rec.result.loser.payload not in client.server.service.handles
    assert mp.ledger.get(rec.result.winner.seller_id) == 1.0
    assert mp.ledger.total() == 0.0
