"""The one traffic generator: a closed loop of one client.

A traffic mix (`traffic/<mix>.json`) is data that this module reads:

  serve    what set-up serves before the window (null: nothing):
           {"verb": name, ...}
  request  one request of the loop: {"verb": name, "sweeps": n, ...}

A verb is a file of its own, `verbs/<name>.py`, found by name. A serve
verb defines `serve(session, spec, seed)`; a request verb defines
`issue(session, spec, seed, keep) -> Done`, and with `keep` puts what it
served in `Done.kept` for the cell's check (the sweep check's
`check.Product` of each model; each served wave's prompts and tokens).
The rest of each spec is the verb's own. A serve verb either serves
models through the session's `VedaliaService` (cells whose inputs are
corpora) or builds the system it serves and keeps it in `session.served`
(an `Engine`, say).

The client sends its next request when the last one has ended on the
device (a synchronize), so a request's latency is its whole device time
and the load follows the system's pace. Each request takes its own seed.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple, Optional

import torch

from vbench import yardstick


class Wave(NamedTuple):
    """A served wave: its rows, each row's prompt and new tokens, and the
    host-clock seconds from its submit to its first token."""

    rows: int
    prompt: int
    new: int
    first_token_s: float


@dataclasses.dataclass
class Done:
    """What a request verb did."""

    sweeps: int  # sweeps of every served model
    tokens: int  # tokens resampled; the served waves' prompt and output tokens
    models: int  # models fitted
    kept: Optional[object] = None  # with `keep`: what the cell's check reads
    waves: tuple = ()  # the served waves (`Wave`), in order


@dataclasses.dataclass
class Request:
    index: int
    start: float  # host clock, s
    end: float
    sweeps: int
    tokens: int
    models: int
    error: Optional[str] = None
    waves: tuple = ()


def are_corpora(inputs) -> bool:
    """Whether a generator's output is a list of corpora (RLDA products),
    which the session serves through a `VedaliaService`."""
    return isinstance(inputs, list) and all(hasattr(p, "corpus") for p in inputs)


class Session:
    """A cell's served state: the device, the service (None where the
    inputs are no corpora), the inputs, the handles or the system a serve
    verb built (`served`), and the verbs (modules) of the mix's steps."""

    def __init__(self, service, inputs, mix: dict, verbs: dict, *, device):
        self.service, self.inputs, self.mix, self.verbs = service, inputs, mix, verbs
        self.device = torch.device(device)
        self.handles = []
        self.served = None

    @functools.cached_property
    def live_tokens(self) -> int:
        """Real tokens one sweep of every input's model resamples."""
        return yardstick.live_tokens(p.corpus for p in self.inputs)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def serve(self, seed: int) -> None:
        if self.mix.get("serve"):
            self.verbs["serve"].serve(self, self.mix["serve"], seed)
            self._sync()

    def issue(self, index: int, seed: int, keep: bool = False):
        """One request; returns it and, with `keep`, what it served for
        the check, else None."""
        t0 = time.perf_counter()
        try:
            done = self.verbs["request"].issue(self, self.mix["request"], seed, keep)
            self._sync()
            error = None
        except RuntimeError as exc:  # a refused launch or a failed op: counted, not fatal
            done, error = Done(0, 0, 0), f"{type(exc).__name__}: {exc}"
        t1 = time.perf_counter()
        return (Request(index, t0, t1, done.sweeps, done.tokens, done.models, error,
                        done.waves), done.kept)

    def close(self) -> None:
        """Release every served model, and drop the system a serve verb
        built."""
        for h in self.handles:
            self.service.release(h)
        self.handles = []
        self.served = None


def run(session: Session, seconds: float, seed_of, tap, tapped: set) -> tuple[list, dict, float]:
    """Requests until `seconds` have passed: (the requests, the products of
    the tapped ones, the window's seconds from the first start to the
    last end)."""
    requests, products = [], {i: [] for i in tapped}
    mark = f"vbench.{session.mix['request']['verb']}"
    t_start = time.perf_counter()
    i = 0
    while time.perf_counter() - t_start < seconds:
        keep = i in tapped
        tap.request = i if keep else None
        with torch.profiler.record_function(mark):
            req, kept = session.issue(i, seed_of(i), keep=keep)
        tap.request = None
        requests.append(req)
        if kept is not None:
            products[i] = kept
        if sum(r.error is not None for r in requests[-3:]) == 3:
            break  # three failures in a row: the system is down
        i += 1
    window = (requests[-1].end - requests[0].start) if requests else 0.0
    return requests, products, window
