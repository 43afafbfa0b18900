"""Parameter-server fit tier: sharded topic-count state on a worker grid.

The scale-out rendering of "High Performance Latent Variable Models"
(Li, Li, Ahmed et al.; PAPERS.md) for the Vedalia fit path. Where
`repro_torch.core.distributed` replicates the whole (V, K) word-topic
table on every worker and sums it whole per sync, this tier:

  * doc-shards tokens and doc-topic counts across every worker of a
    (data, model) grid (all workers act on disjoint docs),
  * vocab-shards the authoritative word-topic table across the `model`
    axis (`psum_scatter` assembly),
  * gives each worker a bounded-staleness *support cache*: only the rows
    for words that actually occur in its documents (`topology.cap` rows,
    typically << V), kept fresh for the worker's own deltas and stale for
    remote ones inside a `staleness`-sweep window,
  * syncs by exchanging per-worker *delta rows* (an all-gather of
    (cap, K) deltas + their global row ids) instead of the whole model —
    see `sync.sync_bytes_per_device` for the accounting.

Module map: `comm` (the worker seam: W workers stacked in one process, or
one a `torch.distributed` rank), `topology` (host-side placement plan),
`sync` (delta exchange + bytes accounting), `sweep` (the program factory
and the local sweep engines), `sampler` (the backend-shaped driver the
`pserver` registry entry in `repro_torch.api.backends` delegates to).
"""

from repro_torch.pserver.sampler import PServerFit
from repro_torch.pserver.topology import PServerPlan, build_plan

__all__ = ["PServerFit", "PServerPlan", "build_plan"]
