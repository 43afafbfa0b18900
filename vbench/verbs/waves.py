"""Request verb `waves`: one wave of the served engine at each of the
mix's prompt lengths, in an order drawn from the request's seed; a wave
is `batch` prompts of one length, each answered with `max_new` greedy
tokens.

  {"verb": "waves", "batch": n, "max_new": n, "lengths": [n, ...]}

Every request sends every length once, so every request of every seed
does the same work; the seed draws the order and the prompts' tokens
(uniform over the vocabulary). The warm-up is a request like the others.

A wave's time to its first token is the benchmark's host clock from its
submit to the engine's first decode step: by then the engine has
synchronized after the prefill and enqueued the first token's argmax. A
wave of one new token (no decode step) takes its whole time.
"""

import contextlib
import time

import numpy as np

from repro_torch.models import model as M
from repro_torch.serving.engine import Request

from vbench.loop import Done, Wave


@contextlib.contextmanager
def _first_decode_step(stamp: list):
    """Stamp the host clock at the first `decode_step` call."""
    orig = M.decode_step

    def decode_step(*args, **kwargs):
        if not stamp:
            stamp.append(time.perf_counter())
        return orig(*args, **kwargs)

    M.decode_step = decode_step
    try:
        yield
    finally:
        M.decode_step = orig


def _wave(engine, rng, rows: int, plen: int, max_new: int):
    """(prompts (rows, plen), tokens (rows, max_new), seconds to the first
    token)."""
    prompts = rng.integers(0, engine.cfg.vocab_size, (rows, plen), dtype=np.int32)
    stamp: list = []
    t0 = time.perf_counter()
    for uid, prompt in enumerate(prompts):
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new))
    with _first_decode_step(stamp):
        results = engine.run()
    t1 = time.perf_counter()
    tokens = np.stack([r.tokens for r in sorted(results, key=lambda r: r.uid)])
    return prompts, tokens, (stamp[0] if stamp else t1) - t0


def issue(session, spec: dict, seed: int, keep: bool) -> Done:
    rng = np.random.default_rng(seed)
    rows, new = spec["batch"], spec["max_new"]
    waves, kept = [], []
    for plen in rng.permutation(spec["lengths"]).tolist():
        prompts, tokens, first_s = _wave(session.served, rng, rows, plen, new)
        waves.append(Wave(rows, plen, new, first_s))
        if keep:
            kept.append({"prompts": prompts, "tokens": tokens})
    return Done(0, sum(w.rows * (w.prompt + w.new) for w in waves), 0,
                kept if keep else None, waves=tuple(waves))
