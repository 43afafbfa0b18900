"""`DeviceFleet` — N simulated phones that run *real* fits (paper §2.5).

Every device is a `VedaliaClient` over the ordinary wire protocol: it
checks a served model out (`export_model`), continues the Gibbs chain
locally with a real sampler backend (`sparse` is the paper's phone-side
sampler, numpy on the host; `torch` — the reference's `jnp` — models a
device with an accelerated runtime and runs on the fleet's `device`, the
card unless the caller asks for the CPU), computes real perplexity on the
exported corpus, and hands the state back as its marketplace submission
payload. Nothing analytic rides the adopted path.

The fleet also models everything that makes a real fleet unpleasant:

  heterogeneous speed   per-device tokens/sec, drawn from `speed_range`;
  stragglers            a fraction of devices runs `straggler_factor`x
                        slower than their advertised speed (thermal
                        throttling, background load) — they miss lease
                        deadlines the matcher thought they would make;
  churn                 each lease independently disconnects with
                        `churn_prob` (the device walked out of coverage);
  malicious devices     "fabricate": skips the sweeps and claims an
                        implausibly good perplexity for the unimproved
                        state (caught deterministically by the server's
                        recompute-vs-claim check);
                        "corrupt": submits a tampered state whose counts
                        disagree with its own assignments (caught by the
                        server's scatter-rebuild consistency check).

All randomness is derived from `(spec.seed, device_id, task_id)` so a
fleet run is exactly replayable: the population comes from the same numpy
draws as the JAX package's fleet (the same devices for the same spec), and
each lease's sampler generator is seeded from the same hash the reference
feeds its per-lease key.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.api.backends import Sampler, backend_capabilities, get_backend
from repro_torch.api.client import VedaliaClient
from repro_torch.chital.matching import Seller
from repro_torch.chital.verification import Submission
from repro_torch.core import perplexity as perplexity_lib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import trace

#: Device behaviors. Honest devices run the task as leased; the two
#: malicious behaviors mirror the attack surface of §2.5.5.
HONEST = "honest"
FABRICATE = "fabricate"
CORRUPT = "corrupt"
BEHAVIORS = (HONEST, FABRICATE, CORRUPT)

#: A fabricator claims this fraction of the true perplexity — far outside
#: any honest tolerance, exactly the "implausibly good model" of §2.5.5.
FABRICATE_CLAIM_RATIO = 0.55


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Shape of the simulated device population."""

    num_devices: int = 100
    malicious_frac: float = 0.2
    # Split of the malicious population between the two behaviors.
    fabricate_frac: float = 0.5
    speed_range: tuple[float, float] = (2000.0, 20000.0)  # token-sweeps/sec
    churn_prob: float = 0.05  # per-lease disconnect probability
    straggler_frac: float = 0.1
    straggler_factor: float = 8.0  # effective slowdown of a straggler
    # The device-local sampler: "sparse" (numpy, the phone) or "torch" (an
    # accelerated runtime; the reference's name "jnp" is its alias).
    backend: str = "sparse"
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class SimDevice:
    """One simulated phone."""

    device_id: int
    speed: float  # advertised token-sweeps/sec (what the matcher sees)
    behavior: str
    straggler_factor: float  # 1.0 for a healthy device
    backend: str

    @property
    def honest(self) -> bool:
        return self.behavior == HONEST


@dataclasses.dataclass(frozen=True)
class OffloadTask:
    """One leased full-refit: re-Gibbs a served handle's whole corpus."""

    task_id: int
    shard_id: int
    handle_id: int
    product_id: int
    tokens: int  # corpus tokens (the unit of sweep-work accounting)
    num_sweeps: int


@dataclasses.dataclass(frozen=True)
class DeviceRun:
    """What one device did with one lease."""

    submission: Submission
    compute_time: float  # simulated seconds the device needed
    completed: bool  # produced a state before the deadline
    churned: bool
    timed_out: bool


class DeviceFleet:
    """Host `spec.num_devices` simulated phones against shard transports.

    `device` is where a device with an accelerated runtime runs its fit
    (`resolve_device`: the card unless the caller asks for the CPU). The
    exported model arrives as CPU tensors; a `sparse` device samples them
    in numpy on the host, as a phone would.
    """

    def __init__(self, spec: FleetSpec, *, device: DeviceLike = None):
        self.spec = spec
        self.device = resolve_device(device)
        rng = np.random.default_rng(spec.seed)
        n_mal = int(round(spec.num_devices * spec.malicious_frac))
        n_fab = int(round(n_mal * spec.fabricate_frac))
        n_straggle = int(round(spec.num_devices * spec.straggler_frac))
        behaviors = [FABRICATE] * n_fab + [CORRUPT] * (n_mal - n_fab) \
            + [HONEST] * (spec.num_devices - n_mal)
        # Straggling is independent of honesty: spread it over the whole
        # population (a shuffled index set, deterministic from the seed).
        stragglers = set(
            rng.permutation(spec.num_devices)[:n_straggle].tolist())
        self.devices: dict[int, SimDevice] = {}
        for i in range(spec.num_devices):
            self.devices[i] = SimDevice(
                device_id=i,
                speed=float(rng.uniform(*spec.speed_range)),
                behavior=behaviors[i],
                straggler_factor=(spec.straggler_factor
                                  if i in stragglers else 1.0),
                backend=spec.backend,
            )
        self.min_speed = float(min(
            (d.speed for d in self.devices.values()), default=1.0))
        self._samplers: dict[str, Sampler] = {}
        # device_id -> its VedaliaClient per transport identity: each phone
        # speaks the wire protocol itself, it never touches server objects.
        self._clients: dict[tuple[int, int], VedaliaClient] = {}

    # -- wiring --------------------------------------------------------------

    def sellers(self) -> list[Seller]:
        """Fresh marketplace `Seller` rows for the whole fleet (advertised
        speed; honesty flag is ground truth for metrics, the marketplace
        never reads it)."""
        return [
            Seller(seller_id=d.device_id, speed=d.speed, honest=d.honest)
            for d in self.devices.values()
        ]

    def _sampler(self, name: str) -> Sampler:
        if name not in self._samplers:
            self._samplers[name] = get_backend(name)
        return self._samplers[name]

    def _client(
        self, device_id: int, transport: Callable[[str], str]
    ) -> VedaliaClient:
        key = (device_id, id(transport))
        if key not in self._clients:
            self._clients[key] = VedaliaClient(transport=transport)
        return self._clients[key]

    # -- execution -----------------------------------------------------------

    def execute(
        self,
        device_id: int,
        task: OffloadTask,
        transport: Callable[[str], str],
        *,
        deadline: Optional[float] = None,
    ) -> DeviceRun:
        """Run one lease on one device. Returns the device's submission:
        a state-carrying one when it finished, a payload-less invalid one
        when it churned or missed the deadline (the marketplace's
        validation stage then routes around it)."""
        device = self.devices[device_id]
        rng = np.random.default_rng(
            (self.spec.seed, device_id, task.task_id))
        work = float(task.tokens) * task.num_sweeps
        compute_time = work / device.speed * device.straggler_factor

        def failed(timed_out: bool, churned: bool) -> DeviceRun:
            return DeviceRun(
                submission=Submission(
                    seller_id=device_id, perplexity=float("inf"),
                    tokens_processed=task.tokens, iterations=0,
                    payload=None, valid=False),
                compute_time=compute_time, completed=False,
                churned=churned, timed_out=timed_out)

        if rng.random() < self.spec.churn_prob:
            return failed(timed_out=False, churned=True)
        if deadline is not None and compute_time > deadline:
            # The device would not have finished: the lease expires with no
            # upload (so no fit is actually run for it).
            return failed(timed_out=True, churned=False)

        client = self._client(device_id, transport)
        exported = client.export_model(task.handle_id)

        # The device's own work (its sweeps, or a cheat's shortcut), timed
        # apart from the export before it and the server's checks after it.
        with trace.span("offload.device_fit", device=device_id,
                        behavior=device.behavior):
            if device.behavior == FABRICATE:
                # The lazy cheat: skip the sweeps entirely, upload the state
                # exactly as exported, and claim an implausibly good
                # perplexity for it (§2.5.5's "phony result").
                state = exported.state
                true_ppx = float(perplexity_lib.perplexity(
                    exported.cfg, state, exported.corpus))
                claimed = true_ppx * FABRICATE_CLAIM_RATIO
            elif device.behavior == CORRUPT:
                # Tampered upload: permute the word-topic table so the counts
                # no longer agree with the assignments, but claim the honest-
                # looking perplexity of the *untampered* state.
                state = exported.state
                true_ppx = float(perplexity_lib.perplexity(
                    exported.cfg, state, exported.corpus))
                perm = rng.permutation(int(state.n_wt.shape[0]))
                state = dataclasses.replace(
                    state, n_wt=state.n_wt[torch.as_tensor(perm)])
                claimed = true_ppx
            else:
                # The real fit: continue the exported chain locally, on the
                # host for a sampler built for the phone, else on `self.device`.
                phone = backend_capabilities(device.backend).device_kind == "phone"
                run_on = torch.device("cpu") if phone else self.device
                corpus = exported.corpus.to(run_on)
                gen = torch.Generator(device=run_on).manual_seed(
                    hash((self.spec.seed, device_id, task.task_id)) & 0x7FFFFFFF)
                state = self._sampler(device.backend).run(
                    exported.cfg, corpus, gen, task.num_sweeps,
                    state=exported.state.to(run_on))
                claimed = float(perplexity_lib.perplexity(
                    exported.cfg, state, corpus))

        return DeviceRun(
            submission=Submission(
                seller_id=device_id, perplexity=claimed,
                tokens_processed=task.tokens,
                iterations=task.num_sweeps, payload=state, valid=True),
            compute_time=compute_time, completed=True,
            churned=False, timed_out=False)
