"""A tap on the program's sweep entries, for the check of `correct`.

A request runs its sweeps inside the service, so the state between two
sweeps never leaves the program. While armed, `SweepTap` keeps, for each
call of a sweep entry, what went in (the config, the corpus, the stored
state and the noise key) and the state that came out. It keeps references
and copies nothing but the key, so an armed request costs no device work:
the program builds a new state each sweep and changes none in place. The
check (`vbench.check`) then recomputes each sweep with the reference from
the state that went in.

The entries are the program's sweep functions, looked up by the samplers
at call time:

  single  `repro_torch.kernels.lda_gibbs.ops.sweep` (the `cuda` route)
  many    `repro_torch.kernels.lda_gibbs.ops.sweep_many` (the `batched`
          route, M stacked models)
  alias   `repro_torch.kernels.alias_mh.ops.mh_sweep` (the `alias` route)

The key is read where the sweep takes it: a CUDA generator's (seed,
offset) before the call (the sweep draws its Philox key from it), the
(M, 2) key table or the injected noise it is handed, or, on the CPU, the
generator's state (the CPU sweep draws `torch.rand` noise from it).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional

ENTRIES = {
    "single": ("repro_torch.kernels.lda_gibbs.ops", "sweep"),
    "many": ("repro_torch.kernels.lda_gibbs.ops", "sweep_many"),
    "alias": ("repro_torch.kernels.alias_mh.ops", "mh_sweep"),
}


@dataclasses.dataclass
class SweepRecord:
    """One sweep as the program ran it."""

    entry: str  # a key of ENTRIES
    request: int  # the index of the request it ran in
    cfg: Any
    corpus: Any  # Corpus; stacked (M, N) for "many"
    state_in: Any  # LDAState, stored units
    state_out: Any
    key: tuple  # ("philox", seed, offset) | ("philox_table", (M, 2)) | ("noise", t) | ("cpu_rand", state)
    rounds: int = 0  # the alias route's MH rounds


def _gen_key(gen) -> tuple:
    if gen.device.type == "cuda":
        return ("philox", gen.initial_seed(), gen.get_offset())
    return ("cpu_rand", gen.get_state())


class SweepTap:
    """Wraps the sweep entries while installed; records while armed."""

    def __init__(self):
        self.records: list[SweepRecord] = []
        self.request: Optional[int] = None  # armed while not None
        self._saved: dict[str, tuple] = {}

    def install(self) -> "SweepTap":
        for entry, (mod_name, attr) in ENTRIES.items():
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            self._saved[entry] = (mod, attr, orig)
            setattr(mod, attr, getattr(self, f"_wrap_{entry}")(orig))
        return self

    def uninstall(self) -> None:
        for mod, attr, orig in self._saved.values():
            setattr(mod, attr, orig)
        self._saved.clear()

    def _wrap_single(self, orig):
        def sweep(cfg, state, corpus, gen, noise=None):
            if self.request is None:
                return orig(cfg, state, corpus, gen, noise)
            key = ("noise", noise.clone()) if noise is not None else _gen_key(gen)
            out = orig(cfg, state, corpus, gen, noise)
            self.records.append(SweepRecord("single", self.request, cfg, corpus, state, out, key))
            return out
        return sweep

    def _wrap_many(self, orig):
        def sweep_many(cfg, states, corpora, noise=None, *, philox=None):
            if self.request is None:
                return orig(cfg, states, corpora, noise, philox=philox)
            key = (("noise", noise.clone()) if noise is not None
                   else ("philox_table", philox.clone()))
            out = orig(cfg, states, corpora, noise, philox=philox)
            self.records.append(SweepRecord("many", self.request, cfg, corpora, states, out, key))
            return out
        return sweep_many

    def _wrap_alias(self, orig):
        def mh_sweep(cfg, state, corpus, gen, mh_steps=4, draws=None, tables=None):
            if self.request is None or draws is not None or tables is not None:
                return orig(cfg, state, corpus, gen, mh_steps, draws, tables)
            key = _gen_key(gen)
            out = orig(cfg, state, corpus, gen, mh_steps)
            self.records.append(SweepRecord("alias", self.request, cfg, corpus, state, out, key,
                                            mh_steps))
            return out
        return mh_sweep
