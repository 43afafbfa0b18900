"""Logical-axis -> mesh-axis rules, as the reference's `repro.sharding.specs`.

Weight sharding is 2D "FSDP x TP": the d_model (embed) dim shards over
'data' and the head/ff/vocab/expert dims over 'model'; the 'pod' axis (when
present) carries pure data parallelism. Rules are per config: a logical dim
whose size is not divisible by its mesh axis replicates (`build_rules`).

A spec is a plain tuple, one entry a dim: None (replicated), an axis name,
or a tuple of axis names (the dim split over their product). It stands
where the reference has a jax `PartitionSpec`; `tuple(P(...))` of the
reference's equals the port's spec. `shard_shape` gives the shape one
device of the mesh holds.

The reference's `use_activation_specs` / `constrain` have no counterpart:
on one card a sharding constraint is the identity, and the port's model
never calls one. `activation_specs` stays, as the dry run's description of
the layout a pod would constrain to.
"""

from __future__ import annotations

import math
from typing import Optional, Union

Spec = tuple[Union[None, str, tuple[str, ...]], ...]

# Logical weight axes -> preferred mesh axis (None = replicate).
BASE_RULES: dict[Optional[str], Optional[str]] = {
    "layers": None,
    "embed": "data",  # FSDP-ish weight sharding
    "qkv": "model",  # flattened num_heads*head_dim
    "kv": "model",  # flattened num_kv_heads*head_dim
    "ff": "model",
    "vocab": "model",
    "experts": "model",  # expert parallelism
    # Per-expert weights are (experts, embed, ff): experts x embed already
    # give the full 256-way sharding; a second 'data' entry would collide.
    "expert_ff": None,
    None: None,
}


def build_rules(cfg, mesh) -> dict[Optional[str], Optional[str]]:
    """Specialize BASE_RULES to a config + mesh, dropping non-divisible axes."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    dims = {
        "embed": cfg.d_model,
        "qkv": cfg.qkv_dim,
        "kv": cfg.kv_dim,
        "ff": cfg.d_ff,
        "vocab": cfg.vocab_size,
        "experts": cfg.num_experts,
        "expert_ff": cfg.d_ff,
    }
    rules = dict(BASE_RULES)
    for axis, dim in dims.items():
        mesh_axis = rules.get(axis)
        if mesh_axis is None:
            continue
        if mesh_axis not in sizes or dim == 0 or dim % sizes[mesh_axis] != 0:
            rules[axis] = None
    return rules


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes carrying the batch dim: ('pod','data') multi-pod else ('data',)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec(mesh, global_batch: int = 0):
    """The batch dim's spec entry: the batch axes (one name, or a tuple of
    two), or None when `global_batch` is given and does not divide over
    them (long_500k's batch of 1): activations, batches and caches alike."""
    b = batch_axes(mesh)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if global_batch and global_batch % math.prod(sizes[a] for a in b) != 0:
        b = ()
    return b if len(b) > 1 else (b[0] if b else None)


def activation_specs(cfg, mesh, kind: str, global_batch: int = 0) -> dict[str, Spec]:
    """Named activation specs for a (config, mesh, step kind): the layout a
    pod's step would constrain each activation to. A `global_batch` not
    divisible by the batch axes replicates the batch dim."""
    bspec = batch_spec(mesh, global_batch)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))

    def model_ok(dim):
        return bool(dim) and "model" in sizes and dim % sizes["model"] == 0

    specs = {
        "residual": (bspec, None, None),  # (B, S, D)
        "logits": (bspec, None, "model" if model_ok(cfg.vocab_size) else None),
        "ffh": (bspec, None, "model" if model_ok(cfg.d_ff) else None),
        # (E, cap, D) MoE dispatch buffers: experts over 'model', capacity
        # over the batch axes in training; replicated capacity at inference
        # (dispatch positions come from a global cumsum).
        "moe_buf": ("model" if model_ok(cfg.num_experts) else None,
                    bspec if kind == "train" else None, None),
        # KV cache (B, S, Hkv, hd): batch over data; decode caches shard the
        # sequence dim over 'model' (flash-decode partial softmax).
        "kv_cache": (bspec, "model" if kind == "decode" else None, None, None),
    }
    # Attention heads shard over 'model' only when divisible.
    specs["heads"] = (bspec, None, "model" if model_ok(cfg.num_heads) else None, None)
    return specs


def _ways(entry, sizes: dict[str, int]) -> int:
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    return math.prod(sizes[a] for a in names)


def shard_shape(shape, spec: Spec, mesh) -> tuple[int, ...]:
    """The per-device shape of an array of `shape` laid out by `spec` on
    `mesh` (trailing dims past the spec replicate). Raises if a dim does not
    divide over its axes: the rules drop every such axis, so a spec they
    built always divides."""
    shape = tuple(shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} is longer than shape {shape}")
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    for i, dim in enumerate(shape):
        ways = _ways(spec[i], sizes) if i < len(spec) else 1
        if dim % ways:
            raise ValueError(f"dim {i} of {shape} ({dim}) does not split {ways} ways "
                             f"({spec[i]!r} on {dict(sizes)})")
        out.append(dim // ways)
    return tuple(out)
