"""Shared state codec (paper §4.3) for sampler backends, built on `QuantSpec`.

Every sampler and every consumer of counts (perplexity, views,
incremental update) needs the same two conversions:

  decode:  stored counts -> real-valued counts
           (int32 fixed point / 2^(w_bits+1) on the ``fixed`` live mode,
            identity on the float32 path);
  encode:  real-valued counts -> stored counts (round to nearest).

The branch on the representation exists exactly once, inside
:class:`StateCodec`, constructed from one `QuantSpec`. The module-level
functions (`decode_counts`, `encode_state`, ...) are thin wrappers over
``codec_for(cfg)`` so all backends speak "stored state" at the boundary.

  * live mutable state (what samplers scatter-add): ``f32`` or ``fixed``
    — `StateCodec.encode_state`/`decode_state`;
  * read-only packed tables (wire payloads): ``int8`` / ``int4_packed``
    codes + per-row scales — `StateCodec.pack_table`/`unpack_table`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fractional, quant
from repro_torch.core.quant import QuantSpec, spec_for
from repro_torch.core.types import Corpus, LDAConfig, LDAState, build_counts
from repro_torch.obs import metrics, trace

__all__ = [
    "QuantSpec",
    "StateCodec",
    "codec_for",
    "spec_for",
    "decode_array",
    "decode_counts",
    "decode_counts_np",
    "decode_state",
    "encode_state",
    "rebuild_state",
    "as_numpy",
]


_REBUILD_S = metrics.counter(
    "vedalia_rebuild_device_seconds_total",
    "Device seconds of count rebuilds (`codec.rebuild` spans).")


def as_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like -> numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class StateCodec:
    """All stored-state conversions for one :class:`QuantSpec`."""

    def __init__(self, spec: QuantSpec):
        self.spec = spec

    def __repr__(self):
        return f"StateCodec({self.spec!r})"

    # -- live state: stored units <-> real units ----------------------------

    def decode_array(self, x):
        """One stored count array -> real units."""
        if self.spec.live_fixed:
            return fractional.from_fixed(x, self.spec.w_bits)
        return x

    def decode_array_np(self, x) -> np.ndarray:
        """One stored count array -> float64 numpy (host-side serving)."""
        out = np.asarray(as_numpy(x), np.float64)
        if self.spec.live_fixed:
            out = out / float(fractional.scale(self.spec.w_bits))
        return out

    def encode_array(self, x):
        """One real-valued count array -> stored units."""
        if self.spec.live_fixed:
            return fractional.to_fixed(x, self.spec.w_bits)
        return x

    def decode_counts(self, state: LDAState):
        """Stored ``(n_dt, n_wt, n_t)`` -> real-valued float32 tensors."""
        return (
            self.decode_array(state.n_dt),
            self.decode_array(state.n_wt),
            self.decode_array(state.n_t),
        )

    def decode_counts_np(self, state: LDAState):
        """Stored counts -> float64 numpy arrays (the view/serving path)."""
        return (
            self.decode_array_np(state.n_dt),
            self.decode_array_np(state.n_wt),
            self.decode_array_np(state.n_t),
        )

    def decode_state(self, state: LDAState) -> LDAState:
        """Full state with counts in real units (z passes through)."""
        n_dt, n_wt, n_t = self.decode_counts(state)
        return LDAState(z=state.z, n_dt=n_dt, n_wt=n_wt, n_t=n_t)

    def encode_state(self, state: LDAState) -> LDAState:
        """Real-valued state -> stored representation."""
        if not self.spec.live_fixed:
            return state
        return LDAState(
            z=state.z,
            n_dt=self.encode_array(state.n_dt),
            n_wt=self.encode_array(state.n_wt),
            n_t=self.encode_array(state.n_t),
        )

    def rebuild_state(self, cfg: LDAConfig, corpus: Corpus, z) -> LDAState:
        """Scatter-rebuild counts from assignments and store (rebuild in
        real units, encode once): the `codec.rebuild` span, device-timed
        into `vedalia_rebuild_device_seconds_total`."""
        with trace.span("codec.rebuild", on=corpus.device, counter=_REBUILD_S):
            return self.encode_state(build_counts(cfg, corpus, z))

    # -- read-only packed tables (int8 / int4_packed modes) -----------------

    def pack_table(self, x) -> tuple[np.ndarray, np.ndarray]:
        """A *real-valued* table -> (codes, per-row scales) in this spec's
        packed width (requires a packed mode)."""
        return quant.quantize_rows(np.asarray(as_numpy(x), np.float32), self.spec.bits)

    def unpack_table(self, codes, scales, k: int) -> np.ndarray:
        """(codes, scales) -> real-valued float32 table."""
        return quant.dequantize_rows(codes, scales, self.spec.bits, k)


_CODEC_CACHE: dict[QuantSpec, StateCodec] = {}


def codec_for(cfg) -> StateCodec:
    """The (cached) `StateCodec` of a config's resolved `QuantSpec`."""
    spec = spec_for(cfg)
    got = _CODEC_CACHE.get(spec)
    if got is None:
        got = _CODEC_CACHE[spec] = StateCodec(spec)
    return got


# -- cfg-threading wrappers (the sampler-facing names) ------------------------


def decode_array(cfg: LDAConfig, x):
    """One stored count array -> real units (see `StateCodec`)."""
    return codec_for(cfg).decode_array(x)


def decode_counts(cfg: LDAConfig, state: LDAState):
    """Stored ``(n_dt, n_wt, n_t)`` -> real-valued float32 tensors."""
    return codec_for(cfg).decode_counts(state)


def decode_counts_np(cfg: LDAConfig, state: LDAState):
    """Stored counts -> float64 numpy arrays (the host-side samplers'
    input, equal to the reference's `decode_counts_np`)."""
    return codec_for(cfg).decode_counts_np(state)


def decode_state(cfg: LDAConfig, state: LDAState) -> LDAState:
    """Full state with counts in real units (z passes through)."""
    return codec_for(cfg).decode_state(state)


def encode_state(cfg: LDAConfig, state: LDAState) -> LDAState:
    """Real-valued state -> stored representation."""
    return codec_for(cfg).encode_state(state)


def rebuild_state(cfg: LDAConfig, corpus: Corpus, z) -> LDAState:
    """Scatter-rebuild counts from assignments and store."""
    return codec_for(cfg).rebuild_state(cfg, corpus, z)

