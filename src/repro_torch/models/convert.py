"""Carry weights and caches between the reference package and the port.

Arrays cross as numpy: the reference's trees (`jax.tree.map(np.asarray,
...)` of `repro.models.model.init_model` / `prefill` outputs) become the
port's trees of tensors with the same keys, shapes and types (bf16 stays
bf16, float32 stays float32), and back. numpy has no bfloat16 of its own
(the reference's arrays use `ml_dtypes.bfloat16`), so a bf16 array goes
through float32, which holds every bf16 value exactly; `cache_to_numpy`
returns float32 arrays for bf16 tensors for the same reason.
`expert_shard_tree` cuts a tree's expert weights to one card's share, so a
share of a MoE model (`configs.base.expert_share`) runs on the reference's
own weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(dev).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_reference(tree, *, device: DeviceLike = None) -> dict:
    """The reference's parameter tree (numpy leaves) as the port's."""
    dev = resolve_device(device)
    return _tree(tree, lambda a: _tensor(a, dev))


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")  # (..., E, D, F) / (..., E, F, D)


def expert_shard_tree(tree, shard: int, shards: int):
    """A parameter tree (numpy arrays or tensors) with every MoE layer's
    expert weights cut to experts [shard * E / shards, (shard + 1) * E /
    shards) along their experts axis (the third from last); the router and
    every other leaf as they are (shared, not copied)."""
    def cut(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = cut(v)
            elif k in EXPERT_LEAVES:
                e = v.shape[-3]
                if e % shards or not 0 <= shard < shards:
                    raise ValueError(f"shard {shard} of {shards} over {e} experts")
                per = e // shards
                out[k] = v[..., shard * per:(shard + 1) * per, :, :]
            else:
                out[k] = v
        return out
    return cut(tree)


def cache_from_reference(cache, *, device: DeviceLike = None) -> dict:
    """The reference's decode cache (numpy leaves) as the port's."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in cache.items()}


def cache_to_numpy(cache) -> dict:
    """The port's cache (or parameter) tree as numpy copies: float32 for
    bf16 tensors (exact), the tensor's own type otherwise. Copies, because
    `decode_step` updates a cache's tensors in place."""
    def conv(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    return _tree(cache, conv)
