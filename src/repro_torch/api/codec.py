"""`repro_torch.api.codec` — the one documented home of Vedalia's two codecs.

1. **State codec** (`repro_torch.core.codec`): stored-unit count tables <->
   real units — the paper §4.3 fixed-point story, described by
   :class:`QuantSpec` (modes ``f32`` / ``fixed`` / ``int8`` /
   ``int4_packed``) and applied by :class:`StateCodec` (resolve one per
   config with :func:`codec_for`).
2. **Wire array codec** (`repro_torch.api.protocol`): tensor or ndarray <->
   JSON-safe dict — raw b64 bytes, or the versioned quantized form (dtype
   tag + per-row scales + packed payload) when a packed spec is passed.

This module re-exports both under distinct names; the implementations stay
where the layering puts them (core below the samplers; protocol beside the
envelopes).
"""

from repro_torch.core.codec import (  # noqa: F401
    QuantSpec,
    StateCodec,
    codec_for,
    decode_array,
    decode_counts,
    decode_state,
    encode_state,
    rebuild_state,
    spec_for,
)

# Wire array codec (JSON-dict form; raw or quantized — see protocol.py).
from repro_torch.api.protocol import (  # noqa: F401
    QUANT_STATE_FIELDS,
    STATE_FIELDS,
    decode_array as decode_wire_array,
    decode_state_arrays,
    encode_array as encode_wire_array,
    encode_state_arrays,
    state_arrays_quantized,
)

__all__ = [
    # state codec
    "QuantSpec",
    "StateCodec",
    "codec_for",
    "spec_for",
    "decode_array",
    "decode_counts",
    "decode_state",
    "encode_state",
    "rebuild_state",
    # wire array codec
    "encode_wire_array",
    "decode_wire_array",
    "encode_state_arrays",
    "decode_state_arrays",
    "state_arrays_quantized",
    "STATE_FIELDS",
    "QUANT_STATE_FIELDS",
]
