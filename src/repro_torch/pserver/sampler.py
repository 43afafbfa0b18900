"""Backend-shaped driver for the parameter-server fit tier.

`PServerFit` owns the host-side lifecycle: build/cache the placement plan
(`topology.build_plan`, with its tensors on the corpus's device) per
(corpus, grid), build/cache the program (`sweep.make_pserver_program`)
per shape class, shuffle state/corpus into the plan's padded worker
layout, and translate back at the boundary. Counts cross the boundary in
*stored* units (fixed point when ``cfg.w_bits`` is set) exactly like every
other backend; internally everything is real-valued float32.

Generator discipline matches `gibbs.run` (the init draw, then each sweep
in turn), and with one worker the whole pipeline — identity token
permutation, the caller's generator kept as the worker's, `local="gibbs"`
— reproduces the oracle bit for bit from one generator state (see
`sweep.py`). Several workers each draw from their own generator
(`comm.generators`). On the w_bits path a multi-sweep `run` loops
single-sweep programs so the per-sweep quantization round-trip matches
the oracle chain too.

The workers default to one, a `comm.Stacked` (1, 1) grid; pass
``workers=(n_data, n_model)`` for W stacked workers on the device (the
card runs them all in one process, on a leading (W,) axis) or a
`comm.ProcessGroup` for one worker a rank. Callers hand over a *flat*
corpus with global doc ids — the plan does the partitioning.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import torch

from repro_torch.core import codec
from repro_torch.core.distributed import take_padded
from repro_torch.core.types import Corpus, LDAConfig, LDAState, init_state
from repro_torch.obs import metrics, timers
from repro_torch.pserver import comm as comm_lib
from repro_torch.pserver import sync as sync_lib
from repro_torch.pserver import topology
from repro_torch.pserver.sweep import engine_name, make_pserver_program

#: Sync accounting happens here, at the host-side launch boundary. Bytes
#: are the analytic per-device cost of `pserver.sync` (what a wire between
#: workers would carry), not a measured transport.
_SYNCS = metrics.counter(
    "vedalia_pserver_syncs_total",
    "Stale-synchronous model syncs executed (full windows only).")
_SYNC_BYTES = metrics.counter(
    "vedalia_pserver_sync_bytes_total",
    "Analytic per-device bytes moved by pserver syncs.")
_STALENESS = metrics.gauge(
    "vedalia_pserver_staleness",
    "Configured sweeps-per-sync window of the last launch.")
_FIT_SECONDS = metrics.histogram(
    "vedalia_pserver_fit_seconds",
    "Wall time of one pserver program launch (device-synced).",
    labels=("local",))


class _Layout:
    """A plan's tensors on one device, this process's workers' rows."""

    def __init__(self, plan: topology.PServerPlan, comm, device):
        w, t = plan.n_workers, plan.t_local

        def on(x, shape):
            return comm.local(torch.as_tensor(x, device=device).reshape(shape))

        self.perm = torch.as_tensor(plan.perm, device=device)
        self.inv = torch.as_tensor(plan.inv, device=device)
        self.support = on(plan.support, (w, plan.cap)).contiguous()
        self.docs_l = on(plan.docs_l, (w, t)).contiguous()
        self.words_l = on(plan.words_l, (w, t)).contiguous()


class PServerFit:
    """Stale-synchronous sharded fit engine (see module docstring)."""

    # Plans and programs are cached per shape class; streaming updates
    # grow corpora every round, so bound both caches (LRU).
    _MAX_CACHED = 8

    def __init__(self, workers=(1, 1), block: int = 4096, staleness: int = 1,
                 local: str = "auto", cap: Optional[int] = None, mh_steps: int = 4):
        if local != "auto":
            engine_name(local)  # raises on an unknown engine
        if staleness < 1:
            raise ValueError(f"staleness must be >= 1, got {staleness}")
        self.comm = comm_lib.make(workers)
        self.block = block
        self.staleness = staleness
        self.local = local
        self.cap = cap
        self.mh_steps = mh_steps
        self._plans: dict[tuple, tuple] = {}
        self._programs: dict[tuple, object] = {}
        self._digest_memo: Optional[tuple] = None

    # -- caches -------------------------------------------------------------

    def _local(self, device) -> str:
        """The engine: `auto` is "cuda" on the card and "gibbs" on the CPU
        (the reference's "pallas on TPU, gibbs elsewhere")."""
        if self.local == "auto":
            return "cuda" if torch.device(device).type == "cuda" else "gibbs"
        return engine_name(self.local)

    @staticmethod
    def _lru_get(cache, key, build):
        val = cache.pop(key, None)
        if val is None:
            val = build()
        cache[key] = val  # re-insert: dict order is recency order
        while len(cache) > PServerFit._MAX_CACHED:
            cache.pop(next(iter(cache)))
        return val

    def _digest(self, corpus: Corpus) -> str:
        """sha1 of the corpus's doc and word ids; remembered for the same
        two tensors at the same versions (the w_bits loop asks once a
        sweep)."""
        memo = self._digest_memo
        versions = (corpus.docs._version, corpus.words._version)
        if memo is not None and memo[0] is corpus.docs and memo[1] is corpus.words \
                and memo[2] == versions:
            return memo[3]
        digest = hashlib.sha1(corpus.docs.cpu().numpy().tobytes()
                              + corpus.words.cpu().numpy().tobytes()).hexdigest()
        self._digest_memo = (corpus.docs, corpus.words, versions, digest)
        return digest

    def _plan(self, cfg: LDAConfig, corpus: Corpus):
        """(plan, its tensors on the corpus's device)."""
        c = self.comm
        key = (cfg.num_docs, cfg.vocab_size, c.n_data, c.n_model, self.cap,
               corpus.num_tokens, self._digest(corpus), str(corpus.device))

        def build():
            plan = topology.build_plan(cfg, corpus.docs.cpu().numpy(),
                                       corpus.words.cpu().numpy(), c.n_data, c.n_model,
                                       cap=self.cap)
            return plan, _Layout(plan, c, corpus.device)

        return self._lru_get(self._plans, key, build)

    def _program(self, cfg: LDAConfig, plan: topology.PServerPlan, num_sweeps: int,
                 staleness: int, local: str):
        key = (cfg, id(self.comm), plan.d_local, plan.t_local, plan.cap, plan.v_pad,
               num_sweeps, staleness, self.block, local, self.mh_steps)
        return self._lru_get(
            self._programs, key,
            lambda: make_pserver_program(
                cfg, self.comm, plan, num_sweeps=num_sweeps, staleness=staleness,
                block=self.block, local=local, mh_steps=self.mh_steps))

    def plan(self, cfg: LDAConfig, corpus: Corpus) -> topology.PServerPlan:
        """The placement plan this engine uses for a corpus."""
        return self._plan(cfg, corpus)[0]

    # -- boundary -----------------------------------------------------------

    def worker_inputs(self, cfg: LDAConfig, real: LDAState, corpus: Corpus):
        """(plan, the program's inputs) for real-valued state: this
        process's workers' token slabs, doc rows, support caches gathered
        from `real.n_wt` and totals, in the plan's padded layout — the
        shapes every local engine's kernel sees."""
        c, k = self.comm, cfg.num_topics
        plan, lay = self._plan(cfg, corpus)
        w, t = plan.n_workers, plan.t_local

        def slabs(x):  # original token order -> (W_local, t_local), pads 0
            return c.local(take_padded(x, lay.perm, 0).view(w, t)).contiguous()

        # Sentinel support ids (v_pad) and vocab padding read zero rows, so
        # unused cache rows start (and stay) empty.
        n_wt_z = torch.cat([real.n_wt, real.n_wt.new_zeros((plan.v_pad + 1 - cfg.vocab_size, k))])
        n_dt_p = torch.cat([real.n_dt, real.n_dt.new_zeros((w * plan.d_local - cfg.num_docs, k))])
        return plan, dict(docs=lay.docs_l, words=lay.words_l, z=slabs(real.z.to(torch.int32)),
                          wts=slabs(corpus.weights), support=lay.support,
                          n_dt=c.local(n_dt_p.view(w, plan.d_local, k)).contiguous(),
                          cache=n_wt_z[lay.support],
                          n_t=real.n_t.expand(c.w_local, k).contiguous())

    def _fit(self, cfg: LDAConfig, real: LDAState, corpus: Corpus,
             gen: Optional[torch.Generator], num_sweeps: int, staleness: int,
             noise: Optional[Sequence[torch.Tensor]] = None) -> LDAState:
        """Run one program over real-valued state."""
        c, dev, k = self.comm, corpus.device, cfg.num_topics
        plan, inputs = self.worker_inputs(cfg, real, corpus)
        inv = self._plan(cfg, corpus)[1].inv
        local = self._local(dev)
        prog = self._program(cfg, plan, num_sweeps, staleness, local)

        timer = timers.DeviceTimer(_FIT_SECONDS, local=local).start()
        z_l, n_dt_l, nwt_l, nt_l = prog(**inputs, gens=c.generators(gen, dev), noise=noise)
        # Every process assembles the whole state: the workers' slabs in
        # order, and the model shards of one data row.
        z_all = c.all_gather(z_l).reshape(-1)
        n_dt = c.all_gather(n_dt_l).reshape(-1, k)[: cfg.num_docs]
        n_wt = c.all_gather(nwt_l)[: plan.n_model].reshape(plan.v_pad, k)[: cfg.vocab_size]
        timer.sync(n_wt)
        # Sync accounting mirrors the program's schedule: one model sync
        # per *full* staleness window (tail sweeps run on stale reads and
        # never pay a trailing sync).
        num_syncs = num_sweeps // staleness
        if num_syncs:
            _SYNCS.inc(num_syncs)
            _SYNC_BYTES.inc(num_syncs * sync_lib.sync_bytes_per_device(
                plan.n_workers, plan.cap, k))
        _STALENESS.set(staleness)
        return LDAState(z=z_all[inv], n_dt=n_dt.contiguous(), n_wt=n_wt.contiguous(),
                        n_t=nt_l[0].contiguous())

    # -- Sampler protocol ---------------------------------------------------

    def sweep(self, cfg: LDAConfig, state: LDAState, corpus: Corpus,
              gen: Optional[torch.Generator], noise: Optional[torch.Tensor] = None
              ) -> LDAState:
        """One sweep (one sync); `noise` replaces its draw (see
        `sweep.make_pserver_program`)."""
        real = codec.decode_state(cfg, state)
        out = self._fit(cfg, real, corpus, gen, 1, 1, None if noise is None else [noise])
        return codec.encode_state(cfg, out)

    def run(self, cfg: LDAConfig, corpus: Corpus, gen: Optional[torch.Generator],
            num_sweeps: int, state: Optional[LDAState] = None,
            noise: Optional[Sequence[torch.Tensor]] = None) -> LDAState:
        """`num_sweeps` sweeps from scratch (the init draw from `gen` first)
        or a warm state; `noise[s]`, when given, is sweep s's draw."""
        if state is None:
            state = codec.encode_state(cfg, init_state(cfg, corpus, gen))
        if num_sweeps <= 0:
            return state
        if cfg.quant_spec.live_fixed:
            # Stored-unit quantization between sweeps must match the
            # oracle chain (encode/decode round-trip per sweep), so the
            # fused multi-sweep program only serves the float32 path.
            for s in range(num_sweeps):
                state = self.sweep(cfg, state, corpus, gen,
                                   None if noise is None else noise[s])
            return state
        real = codec.decode_state(cfg, state)
        out = self._fit(cfg, real, corpus, gen, num_sweeps, self.staleness, noise)
        return codec.encode_state(cfg, out)

    def __repr__(self):
        return (f"PServerFit(workers={self.comm!r}, staleness={self.staleness}, "
                f"local={self.local!r})")
