"""repro_torch.offload — the Chital offload tier (paper §2.2 + §2.5, joined up).

Drives the stream scheduler's full-refit queue through the Chital
marketplace with *real* fits on simulated client devices:

  `DeviceFleet`         N simulated phones, each a `VedaliaClient` over the
                        ordinary wire protocol running a real sampler
                        backend — with churn, stragglers, and the §2.5.5
                        malicious behaviors (fabricate / corrupt);
  `OffloadCoordinator`  a `stream.RefitExecutor` that leases due re-fits
                        into `chital.Marketplace` pairs, validates and
                        Eq.(6)-verifies the uploads with real server-side
                        spot checks, adopts the winner into the serving
                        handle, and falls back to a server-side `refine`
                        whenever the fleet produces nothing adoptable.

`chip_smoke.py`'s `offload` phase measures the fraction of server
sweep-work the tier eliminates on the card, gated on held-out perplexity
parity and zero adopted-but-phony models (the JAX package's
`benchmarks/offload_bench.py` config and gates). Everything here is host
logic over the wire; the card runs the servers' sweeps (fits, updates,
spot checks, fallback refines) and the fits of `torch` fleet devices.
"""

from repro_torch.offload.coordinator import (
    BUYER_ID_BASE,
    VALIDATION_COST_SWEEPS,
    OffloadCoordinator,
    OffloadStats,
)
from repro_torch.offload.fleet import (
    BEHAVIORS,
    CORRUPT,
    FABRICATE,
    FABRICATE_CLAIM_RATIO,
    HONEST,
    DeviceFleet,
    DeviceRun,
    FleetSpec,
    OffloadTask,
    SimDevice,
)

__all__ = [
    "BEHAVIORS",
    "BUYER_ID_BASE",
    "CORRUPT",
    "DeviceFleet",
    "DeviceRun",
    "FABRICATE",
    "FABRICATE_CLAIM_RATIO",
    "FleetSpec",
    "HONEST",
    "OffloadCoordinator",
    "OffloadStats",
    "OffloadTask",
    "SimDevice",
    "VALIDATION_COST_SWEEPS",
]
