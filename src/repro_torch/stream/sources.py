"""Replayable review event streams — the ingestion side of `repro_torch.stream`.

The Vedalia network serves *live* review traffic: reviews arrive per
product, timestamped, at rates that are anything but uniform (launch-day
bursts, day/night cycles). This module produces that traffic as a flat,
replayable sequence of :class:`ReviewEvent`s:

  * `synthetic_events` — timestamped events over the synthetic Amazon-like
    corpus (`repro_torch.data.reviews`), with three traffic shapes: ``uniform``
    (homogeneous Poisson), ``burst`` (periodic launch spikes), ``diurnal``
    (sinusoidal day/night cycle). Product popularity is Zipf-skewed, so a
    few hot products dominate — the sharding workload the router exists for.
  * `save_events` / `load_events` — JSONL file replay. A captured stream
    replays bit-identically, which is what makes streaming bugs and the
    drift-vs-always-refit comparison reproducible.

Arrival times come from Poisson thinning against the shape's rate function,
so the same seed always yields the same (t, product, review) sequence.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Iterator, Optional

import numpy as np

from repro_torch.api import protocol
from repro_torch.core.rlda import Review
from repro_torch.data import reviews as reviews_data

SHAPES = ("uniform", "burst", "diurnal")


@dataclasses.dataclass(frozen=True)
class ReviewEvent:
    """One review arriving on the stream at (event-)time `t`."""

    seq: int  # global arrival order
    t: float  # event time, seconds from stream start
    product_id: int
    review: Review


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Shape of a synthetic review stream."""

    num_products: int = 4
    duration: float = 120.0  # seconds of event time
    rate: float = 2.0  # baseline events/sec across all products
    shape: str = "uniform"  # one of SHAPES
    # burst: every `burst_every` s, `burst_len` s at `burst_factor`× rate
    # (between bursts traffic idles at a fraction of the baseline).
    burst_every: float = 30.0
    burst_len: float = 5.0
    burst_factor: float = 6.0
    idle_factor: float = 0.25
    # diurnal: rate · (1 + amp · sin(2πt / period))
    diurnal_period: float = 120.0
    diurnal_amp: float = 0.8
    # review content (per-product synthetic corpora share one vocabulary)
    vocab_size: int = 120
    num_topics: int = 4
    mean_tokens: int = 30
    zipf_s: float = 1.2  # product popularity skew (1 => near-uniform)
    # Concept drift: events after `shift_at` (event seconds) draw their
    # tokens from a half-vocabulary-rotated distribution — genuinely new
    # topics, the thing the scheduler's drift trigger exists to catch.
    # None => stationary stream.
    shift_at: Optional[float] = None
    seed: int = 0


def rate_at(spec: StreamSpec, t: float) -> float:
    """The shape's instantaneous arrival rate λ(t) in events/sec."""
    if spec.shape == "uniform":
        return spec.rate
    if spec.shape == "burst":
        in_burst = (t % spec.burst_every) < spec.burst_len
        return spec.rate * (spec.burst_factor if in_burst else spec.idle_factor)
    if spec.shape == "diurnal":
        return spec.rate * (
            1.0 + spec.diurnal_amp
            * float(np.sin(2.0 * np.pi * t / spec.diurnal_period)))
    raise ValueError(f"unknown stream shape {spec.shape!r}; shapes: {SHAPES}")


def _peak_rate(spec: StreamSpec) -> float:
    if spec.shape == "burst":
        return spec.rate * spec.burst_factor
    if spec.shape == "diurnal":
        return spec.rate * (1.0 + spec.diurnal_amp)
    return spec.rate


def synthetic_events(spec: StreamSpec) -> list[ReviewEvent]:
    """Generate the full event sequence for `spec` (deterministic in seed).

    Arrival times by Poisson thinning at the peak rate; product ids drawn
    from a Zipf-skewed popularity distribution; review content generated
    per product from `repro_torch.data.reviews` so each product has its own
    planted topic structure over a shared vocabulary.
    """
    rng = np.random.default_rng(spec.seed)
    lam_max = max(_peak_rate(spec), 1e-9)

    # Zipf-ish popularity over products.
    pop = 1.0 / np.arange(1, spec.num_products + 1) ** spec.zipf_s
    pop /= pop.sum()

    arrivals: list[tuple[float, int]] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / lam_max))
        if t >= spec.duration:
            break
        if rng.random() < rate_at(spec, t) / lam_max:
            arrivals.append((t, int(rng.choice(spec.num_products, p=pop))))

    # One synthetic corpus per product, sized to its arrival count, over the
    # shared vocabulary. Seeds are product-scoped so adding products never
    # perturbs existing ones.
    counts = np.bincount([p for _, p in arrivals], minlength=spec.num_products)
    pools: dict[int, list[Review]] = {}
    for pid in range(spec.num_products):
        if counts[pid] == 0:
            continue
        pools[pid] = reviews_data.generate(reviews_data.SyntheticSpec(
            num_reviews=int(counts[pid]),
            vocab_size=spec.vocab_size,
            num_topics=spec.num_topics,
            mean_tokens=spec.mean_tokens,
            seed=spec.seed * 7919 + pid,
        )).reviews

    events, cursor = [], dict.fromkeys(pools, 0)
    for seq, (when, pid) in enumerate(arrivals):
        review = pools[pid][cursor[pid]]
        cursor[pid] += 1
        if spec.shift_at is not None and when >= spec.shift_at:
            # Rotate tokens half a vocabulary: the planted topic blocks of
            # `data.reviews` are position-based, so this is a hard concept
            # shift (new word co-occurrence structure), not relabeling.
            review = dataclasses.replace(
                review,
                tokens=((np.asarray(review.tokens, np.int64)
                         + spec.vocab_size // 2) % spec.vocab_size
                        ).astype(np.int32))
        events.append(ReviewEvent(
            seq=seq, t=when, product_id=pid, review=review))
    return events


# -- file replay --------------------------------------------------------------


def encode_event(e: ReviewEvent) -> dict:
    return {
        "seq": e.seq,
        "t": e.t,
        "product_id": e.product_id,
        "review": protocol.encode_review(e.review),
    }


def decode_event(d: dict) -> ReviewEvent:
    return ReviewEvent(
        seq=int(d["seq"]),
        t=float(d["t"]),
        product_id=int(d["product_id"]),
        review=protocol.decode_review(d["review"]),
    )


def save_events(events: Iterable[ReviewEvent], path: str) -> int:
    """Write one JSON line per event; returns the number written."""
    n = 0
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(encode_event(e)) + "\n")
            n += 1
    return n


def load_events(path: str) -> list[ReviewEvent]:
    with open(path) as f:
        return [decode_event(json.loads(line)) for line in f if line.strip()]


def replay(path: str, *, limit: Optional[int] = None) -> Iterator[ReviewEvent]:
    """Stream events back from a capture file in arrival order."""
    with open(path) as f:
        for i, line in enumerate(f):
            if limit is not None and i >= limit:
                return
            if line.strip():
                yield decode_event(json.loads(line))
