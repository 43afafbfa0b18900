"""Optimizers: AdamW (fp32 moments) and Adafactor (factored second moment).

The reference's `repro.train.optim` over the port's nested dict trees.
AdamW is the default; the 400B-class MoE configs name Adafactor, whose
state is row and column statistics only (AdamW's is 8 bytes a parameter).
State is laid out per parameter leaf: the parameter tree with each leaf
replaced by its dict of moments (`m`, `v`; or `vr`, `vc` for a factored
leaf of 2+ dims, `v` otherwise), so a checkpoint's keys are the
reference's.

Each update works in float32 and rounds back to the parameter's type once,
step for step as the reference's: the gradient clipped by the global norm
and rounded back to its own type, the moments, the update, the decoupled
weight decay on leaves of 2+ dims, the new parameter. The schedule and the
bias corrections are computed in float32 on 0-d tensors, so they round as
the reference's do. One card holds one copy of a model: `update` writes
the new parameters and state into their tensors in place (under
`torch.no_grad`) and returns the same trees. `abstract_state` (the dry
run's: `init` of `meta` parameters) and `state_pspecs` (a pod's layout,
`sharding.specs` tuples) are the reference's, leaf for leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.models.params import leaves


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    eps2: float = 1e-30  # adafactor


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac: a float32 0-d tensor
    on the CPU. `step`: an int or a 0-d tensor."""
    step = torch.as_tensor(step).to(torch.float32).cpu()
    # (step+1)/warmup so the very first step takes a (small) real update.
    warm = (step + 1.0) / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares in float32 (0-d, on the
    leaves' device), the leaves in sorted-path order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for _, x in leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)


def _clipped(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x scaled in float32 and rounded back to its own type."""
    return (x.float() * scale).to(x.dtype)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def clip_by_global_norm(tree, max_norm: float):
    """(the tree scaled by min(1, max_norm / norm), each leaf rounded back to
    its type; the norm)."""
    g = global_norm(tree)
    scale = _clip_scale(g, max_norm)
    return _map(lambda x: _clipped(x, scale), tree), g


def _f32(x: float) -> float:
    """The float32 rounding of x, as a Python float (exact)."""
    return torch.tensor(x, dtype=torch.float32).item()


# ---------------------------------------------------------------------------
# Per-leaf update rules: gf is the leaf's float32 gradient (a copy the rule
# may overwrite), s its state (updated in place), p the parameter (written
# in place); lr and t (step + 1) float32 0-d CPU tensors.
# ---------------------------------------------------------------------------


def _adamw_leaf_init(p):
    return {"m": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            "v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}


def _adamw_leaf(cfg, gf, s, p, lr, t):
    m, v = s["m"], s["v"]
    bc1 = (1 - cfg.b1 ** t).item()
    bc2 = (1 - cfg.b2 ** t).item()
    m.mul_(cfg.b1).add_(gf * (1 - cfg.b1))
    v.mul_(cfg.b2).add_((gf * (1 - cfg.b2)).mul_(gf))
    denom = torch.div(v, bc2).sqrt_().add_(cfg.eps)
    u = torch.div(m, bc1, out=gf).div_(denom)
    del denom
    _apply(cfg, u, p, lr)


def _adafactor_leaf_init(p):
    z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)  # noqa: E731
    if p.dim() >= 2:
        return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
    return {"v": z(p.shape)}


def _adafactor_leaf(cfg, gf, s, p, lr, t):
    beta2 = 1.0 - t ** -0.8  # standard Adafactor second-moment schedule
    b, nb = beta2.item(), (1 - beta2).item()
    g2 = (gf * gf).add_(cfg.eps2)
    if p.dim() >= 2:
        vr = s["vr"].mul_(b).add_(g2.mean(dim=-1).mul_(nb))
        vc = s["vc"].mul_(b).add_(g2.mean(dim=-2).mul_(nb))
        del g2
        denom = torch.clamp_min(vr.mean(dim=-1, keepdim=True), cfg.eps2)
        vhat = (vr / denom)[..., None] * vc[..., None, :]
        u = gf.div_(vhat.add_(cfg.eps2).sqrt_())
        del vhat
    else:
        v = s["v"].mul_(b).add_(g2.mul_(nb))
        u = gf.div_((v + cfg.eps2).sqrt_())
    rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
    u.div_(torch.clamp_min(rms, 1.0))  # Adafactor update clipping (RMS <= 1)
    _apply(cfg, u, p, lr)


def _apply(cfg, u, p, lr):
    """p <- p - lr * (u + decay * p) (decay on 2+ dim leaves), in float32,
    rounded to p's type once; u is overwritten."""
    pf = p.to(torch.float32, copy=True)
    if p.dim() >= 2:  # decoupled weight decay on matrices only
        u.add_(pf * cfg.weight_decay)
    p.copy_(pf.sub_(u.mul_(lr.item())))


# ---------------------------------------------------------------------------
# Optimizer facade
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Optimizer:
    cfg: OptConfig
    _leaf_init: Callable
    _leaf: Callable

    def init(self, params):
        """The state tree: each parameter leaf replaced by its float32
        moments, on the parameter's device."""
        return _map(self._leaf_init, params)

    @torch.no_grad()
    def update(self, grads, state, params, step):
        """One step: writes the new parameters and state into their tensors
        (in place) and returns (params, state)."""
        scale = None
        if self.cfg.grad_clip > 0:
            scale = _clip_scale(global_norm(grads), self.cfg.grad_clip)
        lr = schedule(self.cfg, step)
        t = torch.as_tensor(step).to(torch.float32).cpu() + 1.0
        for path, g in leaves(grads):
            gf = (_clipped(g, scale).float() if scale is not None
                  else g.to(torch.float32, copy=True))
            self._leaf(self.cfg, gf, _at(state, path), _at(params, path), lr, t)
        return params, state

    def abstract_state(self, abstract_params):
        """The state tree as `meta` tensors, all float32: `init` of the
        dry run's `meta` parameters (`models.params.abstract_params`)."""
        return self.init(abstract_params)

    def state_pspecs(self, param_pspecs):
        """The state's specs: each moment takes its parameter's spec; a
        factored statistic drops the spec entry of the dim it averages."""
        def conv(spec):
            if self._leaf is _adamw_leaf:
                return {"m": spec, "v": spec}
            if len(spec) >= 2:
                return {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
            return {"v": spec}

        return _map(conv, param_pspecs)


def make_optimizer(cfg: OptConfig) -> Optimizer:
    if cfg.name == "adamw":
        return Optimizer(cfg, _adamw_leaf_init, _adamw_leaf)
    if cfg.name == "adafactor":
        return Optimizer(cfg, _adafactor_leaf_init, _adafactor_leaf)
    raise ValueError(cfg.name)


def for_arch(arch_cfg, **overrides) -> Optimizer:
    return make_optimizer(OptConfig(name=arch_cfg.optimizer, **overrides))
