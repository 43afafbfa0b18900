"""`repro_torch.stream` — sharded streaming ingestion with online refitting.

The continuously-updating face of the Vedalia service: review events flow
from a replayable source, through a consistent-hash router onto
`VedaliaServer` shards, where an incremental scheduler micro-batches them
into warm updates and drift-triggered full re-fits, under a staleness
budget. Killed shards recover from codec-exact snapshots and clients
resync through the existing cursor path.

    sources    timestamped review events (file replay, burst/diurnal shapes)
    router     `StreamRouter`: consistent hashing, bounded queues,
               drop-oldest/block backpressure
    scheduler  `IncrementalScheduler`: micro-batching, drift + held-out
               perplexity refit triggers, staleness accounting
    snapshot   codec-based shard snapshot/restore

Every module is host code over the port's client and server: the sweeps
they trigger (fits, drain-updates, coalesced `refine_batch` refits) run the
kernels of `repro_torch.kernels` on the servers' device. `chip_smoke.py`'s
`stream` phase drives it end to end on one card.
"""

from repro_torch.stream.router import RouterStats, StreamRouter
from repro_torch.stream.scheduler import (
    IncrementalScheduler,
    ProductStatus,
    SchedulerStats,
    pump,
)
from repro_torch.stream.snapshot import (
    restore_from_json,
    restore_server,
    snapshot_server,
    snapshot_to_json,
)
from repro_torch.stream.sources import (
    ReviewEvent,
    StreamSpec,
    load_events,
    replay,
    save_events,
    synthetic_events,
)

__all__ = [
    "IncrementalScheduler",
    "ProductStatus",
    "ReviewEvent",
    "RouterStats",
    "SchedulerStats",
    "StreamRouter",
    "StreamSpec",
    "load_events",
    "pump",
    "replay",
    "restore_from_json",
    "restore_server",
    "save_events",
    "snapshot_server",
    "snapshot_to_json",
    "synthetic_events",
]
