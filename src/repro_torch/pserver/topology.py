"""Host-side placement plan for the parameter-server fit tier.

A mesh of shape (data=d, model=m) has W = d*m workers; the plan decides,
once per (corpus, mesh) pair and entirely in numpy:

  * the contiguous doc partition: worker w owns docs
    [w*d_local, (w+1)*d_local), d_local = ceil(D / W) — flat worker index
    is row-major over (data, model), the layout of `pserver.comm`'s seams;
  * the permuted token layout: per-worker slabs of `t_local` slots
    (zero-weight padding), with `perm`/`inv` mapping between original
    token order and slots — identity at W=1, which keeps single-worker
    runs bit-exact vs the unsharded oracle;
  * the per-worker vocab *support*: the sorted distinct word ids occurring
    in the worker's docs, padded to a common width `cap` with the sentinel
    `v_pad` (one past the model-padded vocab, so sentinel gathers fill 0
    and sentinel scatters drop). Worker-local word ids (`words_l`) index
    the support row, so the local cache is (cap, K) instead of (V, K) —
    `cap << V` is the whole memory/bytes win of the tier;
  * the vocab padding `v_pad = ceil(V / m) * m` for the `psum_scatter`
    assembly of the authoritative table across the model axis.

The doc-partition primitives are shared with the replicated oracle
(`core.distributed.partition_by_doc`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.distributed import partition_by_doc
from repro_torch.core.types import LDAConfig


@dataclasses.dataclass(frozen=True)
class PServerPlan:
    """Immutable host-side plan; arrays are numpy (copied to the corpus's
    device by `sampler`, once a plan)."""

    n_data: int
    n_model: int
    d_local: int  # docs per worker (ceil)
    t_local: int  # token slots per worker (max shard population)
    cap: int      # support width (max distinct words per worker, padded)
    v_pad: int    # vocab padded to a multiple of n_model
    perm: np.ndarray     # (W*t_local,) original token index; N = padding
    inv: np.ndarray      # (N,) slot of original token i
    support: np.ndarray  # (W, cap) sorted global word ids; v_pad sentinel
    docs_l: np.ndarray   # (W*t_local,) worker-local doc ids (0 on pads)
    words_l: np.ndarray  # (W*t_local,) index into the worker's support row

    @property
    def n_workers(self) -> int:
        return self.n_data * self.n_model

    @property
    def v_shard(self) -> int:
        return self.v_pad // self.n_model


def build_plan(
    cfg: LDAConfig,
    docs: np.ndarray,
    words: np.ndarray,
    n_data: int,
    n_model: int,
    cap: int | None = None,
) -> PServerPlan:
    """Build the placement plan for a corpus on a (n_data, n_model) mesh.

    `cap` overrides the support width (it must cover the densest worker);
    the default rounds the measured maximum up to a multiple of 8.
    """
    docs = np.asarray(docs)
    words = np.asarray(words)
    n = docs.shape[0]
    w_count = n_data * n_model
    v_pad = -(-cfg.vocab_size // n_model) * n_model

    d_local, t_local, perm, inv = partition_by_doc(
        cfg.num_docs, docs, w_count)

    valid = perm < n
    perm_safe = np.minimum(perm, max(n - 1, 0))
    slot_worker = np.arange(w_count * t_local, dtype=np.int64) // t_local
    docs_l = np.where(
        valid, docs[perm_safe] - slot_worker * d_local, 0).astype(np.int32)

    # Per-worker sorted distinct vocab support.
    sup_rows = []
    for w in range(w_count):
        seg = slice(w * t_local, (w + 1) * t_local)
        sup_rows.append(np.unique(words[perm_safe[seg]][valid[seg]]))
    need = max((len(u) for u in sup_rows), default=1)
    auto_cap = max(8, -(-need // 8) * 8)
    if cap is None:
        cap = auto_cap
    elif cap < need:
        raise ValueError(
            f"cap={cap} below the densest worker's {need} distinct words")
    support = np.full((w_count, cap), v_pad, np.int32)
    words_l = np.zeros(w_count * t_local, np.int32)
    for w, u in enumerate(sup_rows):
        support[w, : len(u)] = u
        seg = slice(w * t_local, (w + 1) * t_local)
        v = valid[seg]
        loc = np.zeros(t_local, np.int32)
        loc[v] = np.searchsorted(u, words[perm_safe[seg]][v]).astype(np.int32)
        words_l[seg] = loc

    return PServerPlan(
        n_data=n_data, n_model=n_model, d_local=d_local, t_local=t_local,
        cap=int(cap), v_pad=int(v_pad), perm=perm, inv=inv,
        support=support, docs_l=docs_l, words_l=words_l)
