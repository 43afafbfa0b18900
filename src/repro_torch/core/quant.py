"""`QuantSpec` — the one description of how count tables are represented.

Before this module every tier re-derived the storage story from
``cfg.w_bits`` (an ``if cfg.w_bits is not None`` branch per call site); the
spec object replaces that with a single value threaded everywhere a
representation decision is made:

  mode ``f32``          real-valued float32 counts (identity codec);
  mode ``fixed``        the paper §4.3 fixed point: int32 counts at scale
                        ``2^(w_bits+1)`` — bit-identical to the legacy
                        ``w_bits`` path;
  mode ``int8``         read-only tables additionally *pack* to one byte
                        per entry: unsigned 8-bit codes with one float32
                        scale per row (praxis ``quantization/linears.py``
                        style per-channel scaling);
  mode ``int4_packed``  as ``int8`` but 4-bit codes, two per byte — a
                        16-level table at a quarter of the f32 footprint.

The packed modes describe *tables at rest*: wire payloads (`view`,
`export_model`, `adopt_state`) and snapshots. The *live*
mutable state a sampler scatter-adds into stays ``f32`` or ``fixed`` —
``live_mode`` says which — so every existing sampler keeps speaking stored
`LDAState` at the boundary and ``fixed``-mode fits stay bit-exact with the
pre-spec ``w_bits`` path.

Packing layout (row = the trailing axis):

    scale_r = max(row_r) / (2^bits - 1)         one float32 per row
    code    = round(x / scale_r)  in [0, 2^bits - 1]   (unsigned: counts
              are non-negative; negatives clip to 0)
    int4    = two codes per byte, low nibble first; odd row lengths pad
              one zero nibble

All-zero rows store ``scale = 0`` and decode to exact zeros (no epsilon
floors). Round-trip error is bounded by ``scale / 2`` per entry — the
packed analogue of §4.3's ``1/2^(w_bits+2)`` rounding bound.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

#: Valid `QuantSpec.mode` values, in increasing compression order.
MODES = ("f32", "fixed", "int8", "int4_packed")

#: Modes whose read-only tables pack to sub-f32 codes + per-row scales.
PACKED_MODES = ("int8", "int4_packed")


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """How counts are stored, shipped, and read.

    `mode` picks the table representation (see module docstring);
    `w_bits` is the §4.3 fixed-point precision of the *live* mutable
    state and is required for mode "fixed" (it is also honored by the
    packed modes, whose live state stays fixed point when set).

    The spec is frozen and hashable so it can ride inside `LDAConfig`
    unchanged into hashed caches (`codec_for`).
    """

    mode: str = "f32"
    w_bits: Optional[int] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"unknown quant mode {self.mode!r}; modes: {MODES}")
        if self.mode == "fixed" and self.w_bits is None:
            raise ValueError("mode 'fixed' requires w_bits")
        if self.mode == "f32" and self.w_bits is not None:
            raise ValueError("mode 'f32' must not carry w_bits")

    # -- constructors --------------------------------------------------------

    @staticmethod
    def f32() -> "QuantSpec":
        return QuantSpec(mode="f32")

    @staticmethod
    def fixed(w_bits: int) -> "QuantSpec":
        return QuantSpec(mode="fixed", w_bits=int(w_bits))

    @staticmethod
    def int8(w_bits: Optional[int] = None) -> "QuantSpec":
        return QuantSpec(mode="int8", w_bits=w_bits)

    @staticmethod
    def int4(w_bits: Optional[int] = None) -> "QuantSpec":
        return QuantSpec(mode="int4_packed", w_bits=w_bits)

    @staticmethod
    def from_w_bits(w_bits: Optional[int]) -> "QuantSpec":
        """The legacy knob, spelled as a spec: None -> f32, else fixed."""
        return QuantSpec.f32() if w_bits is None else QuantSpec.fixed(w_bits)

    # -- derived properties --------------------------------------------------

    @property
    def packed(self) -> bool:
        """Do read-only tables pack to sub-f32 codes + per-row scales?"""
        return self.mode in PACKED_MODES

    @property
    def bits(self) -> int:
        """Code width of the packed table representation (8 or 4)."""
        if not self.packed:
            raise ValueError(f"mode {self.mode!r} has no packed code width")
        return 4 if self.mode == "int4_packed" else 8

    @property
    def live_mode(self) -> str:
        """Representation of the live mutable state: 'fixed' or 'f32'."""
        return "fixed" if self.w_bits is not None else "f32"

    @property
    def live_fixed(self) -> bool:
        return self.w_bits is not None

    def to_wire(self) -> str:
        """The mode token stamped into wire payloads."""
        return self.mode

    @staticmethod
    def from_wire(mode: str) -> "QuantSpec":
        """A wire mode token -> table-packing spec (live w_bits is a
        server-side concern and never crosses the wire here)."""
        if mode not in PACKED_MODES:
            raise ValueError(
                f"wire quant mode must be one of {PACKED_MODES}, "
                f"got {mode!r}")
        return QuantSpec(mode=mode)


def spec_for(cfg) -> QuantSpec:
    """Resolve the spec of an `LDAConfig`: its explicit `quant` field when
    set, else the legacy `w_bits` mapping."""
    spec = getattr(cfg, "quant", None)
    if spec is not None:
        return spec
    return QuantSpec.from_w_bits(getattr(cfg, "w_bits", None))


# -- row packing (numpy: the wire / snapshot / host paths) --------------------


def _levels(bits: int) -> int:
    if bits not in (4, 8):
        raise ValueError(f"packed code width must be 4 or 8, got {bits}")
    return (1 << bits) - 1


def pack_nibbles(codes: np.ndarray) -> np.ndarray:
    """(..., K) uint8 codes in [0, 15] -> (..., ceil(K/2)) packed bytes,
    low nibble first; odd K pads one zero nibble."""
    codes = np.asarray(codes, np.uint8)
    k = codes.shape[-1]
    if k % 2:
        pad = [(0, 0)] * (codes.ndim - 1) + [(0, 1)]
        codes = np.pad(codes, pad)
    low = codes[..., 0::2]
    high = codes[..., 1::2]
    return (low | (high << 4)).astype(np.uint8)


def unpack_nibbles(packed: np.ndarray, k: int) -> np.ndarray:
    """(..., ceil(K/2)) packed bytes -> (..., K) uint8 codes in [0, 15]."""
    packed = np.asarray(packed, np.uint8)
    low = packed & 0x0F
    high = packed >> 4
    out = np.stack([low, high], axis=-1).reshape(packed.shape[:-1] + (-1,))
    return out[..., :k]


def quantize_rows(x, bits: int) -> tuple[np.ndarray, np.ndarray]:
    """Non-negative (..., K) float table -> (codes, scales).

    codes: uint8, (..., K) for bits=8 or (..., ceil(K/2)) nibble-packed
    for bits=4; scales: float32 (...,) with scale 0 for all-zero rows.
    Negative entries (not meaningful for counts) clip to 0.
    """
    x = np.maximum(np.asarray(x, np.float32), 0.0)
    levels = _levels(bits)
    scales = (x.max(axis=-1) / levels).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)[..., None]
    codes = np.clip(np.rint(x / safe), 0, levels).astype(np.uint8)
    if bits == 4:
        codes = pack_nibbles(codes)
    return codes, scales


def dequantize_rows(
    codes: np.ndarray, scales: np.ndarray, bits: int, k: int
) -> np.ndarray:
    """(codes, scales) -> float32 (..., K) table (inverse of
    `quantize_rows` up to the scale/2 rounding bound)."""
    _levels(bits)  # validate width
    if bits == 4:
        codes = unpack_nibbles(codes, k)
    codes = np.asarray(codes, np.float32)
    if codes.shape[-1] != k:
        raise ValueError(
            f"packed table has {codes.shape[-1]} columns, expected {k}")
    return codes * np.asarray(scales, np.float32)[..., None]
