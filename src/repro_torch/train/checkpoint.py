"""Checkpointing: flat-key npz snapshots of (params, opt_state, step).

The reference's `repro.train.checkpoint` format, so a checkpoint written by
either package restores in the other: every leaf stored under its
'/'-joined key path (`params/...`, `opt/...`), bf16 stored as float32
(npz has no bf16; float32 holds every bf16 value exactly), the step as an
int64 scalar. The write is atomic (a temporary file renamed into place).
Restores check every leaf's shape against a template tree and return
tensors of the template's type on its device, so a config change is caught
at load time instead of producing silently wrong training.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    else:
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:  # npz has no bf16: store as f32
            t = t.float()
        out[prefix[:-1]] = t.numpy()
    return out


def save(path: str, params, opt_state=None, step: int = 0) -> None:
    flat = {f"params/{k}": v for k, v in _flatten(params).items()}
    if opt_state is not None:
        flat.update({f"opt/{k}": v for k, v in _flatten(opt_state).items()})
    flat["step"] = np.asarray(step, np.int64)
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    # Atomic write: tmp + rename, so a crash never leaves a torn checkpoint.
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _unflatten(flat: dict, template):
    def rec(node, prefix):
        if isinstance(node, dict):
            return {k: rec(v, f"{prefix}{k}/") for k, v in node.items()}
        key = prefix[:-1]
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(node.shape)}")
        return torch.from_numpy(np.array(arr)).to(device=node.device, dtype=node.dtype)

    return rec(template, "")


def restore(path: str, params_template, opt_template=None):
    """Returns (params, opt_state | None, step)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    params = _unflatten(
        {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")},
        params_template,
    )
    opt_state = None
    if opt_template is not None:
        opt_state = _unflatten(
            {k[len("opt/"):]: v for k, v in flat.items() if k.startswith("opt/")},
            opt_template,
        )
    return params, opt_state, int(flat["step"])
