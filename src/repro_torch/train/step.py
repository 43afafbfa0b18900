"""Train step factory: loss and gradients, microbatch accumulation, optimizer.

The reference's `repro.train.step`. `make_train_step(cfg, opt)` returns

    (params, opt_state, batch, step) -> (params, opt_state, metrics)

with the parameters and state updated in place (`Optimizer.update`) and
the metrics under the reference's keys (`loss`, `nll`, `load_balance`,
`router_z`, `grad_norm`; float32 0-d tensors on the parameters' device, not
synchronized). Gradients come from `torch.autograd.grad` of
`models.model.forward_loss` with respect to detached views of the
parameters, so the caller's tensors keep `requires_grad` as they were.

`train_step.grads(params, batch)` -> (loss, aux, gradient tree) and
`train_step.apply(params, opt_state, grads, step)` -> (params, opt_state,
grad_norm) are its two halves (the dry run measures them apart).

`cfg.microbatch` > 1 splits the batch into that many sequential
microbatches: each one's gradients are added into buffers of
`cfg.grad_accum_dtype` (float32 buffers when it is "float32", not bf16
gradients summed in their own type), then divided by the count, the loss
and aux averaged. `use_kernel` defaults to False, as the reference's: the
RWKV6 and Mamba2 scans then take their differentiable plain versions. The
chunk_scan kernels have no backward, so `use_kernel=True` on CUDA for an
ssm or hybrid arch raises.
"""

from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.params import leaves
from repro_torch.train.optim import Optimizer, global_norm

ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} does not split into {n} microbatches")
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


def _tree(paths, values) -> dict:
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def make_train_step(cfg, opt: Optimizer, *, use_kernel: bool = False):
    accum_dtype = ACCUM_DTYPES[cfg.grad_accum_dtype]

    def loss_and_grads(params, batch):
        """(loss, aux, gradients as a list in sorted-path order)."""
        paths, ps = zip(*leaves(params))
        free = [p.detach().requires_grad_(p.is_floating_point()) for p in ps]
        with torch.enable_grad():
            loss, aux = M.forward_loss(_tree(paths, free), cfg, batch, use_kernel=use_kernel)
            grads = torch.autograd.grad(loss, free, allow_unused=True, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, paths, list(grads)

    def grads_of(params, batch):
        """(loss, aux, the gradient tree): summed over the microbatches in
        `accum_dtype` buffers and divided by their count when
        `cfg.microbatch` > 1."""
        if cfg.microbatch > 1:
            loss_sum, aux_sum, acc = 0.0, None, None
            for mb in _split_microbatches(batch, cfg.microbatch):
                loss, aux, paths, grads = loss_and_grads(params, mb)
                if acc is None:
                    acc = [torch.zeros(g.shape, dtype=accum_dtype, device=g.device)
                           for g in grads]
                for a, g in zip(acc, grads):
                    a.add_(g.to(accum_dtype))
                del grads
                loss_sum = loss_sum + loss
                aux_sum = aux if aux_sum is None else {k: aux_sum[k] + aux[k] for k in aux}
            return (loss_sum / cfg.microbatch,
                    {k: v / cfg.microbatch for k, v in aux_sum.items()},
                    _tree(paths, [a.div_(cfg.microbatch) for a in acc]))
        loss, aux, paths, grads = loss_and_grads(params, batch)
        return loss, aux, _tree(paths, grads)

    def apply(params, opt_state, grads, step):
        """The gradient's global norm, then the optimizer's in-place update:
        (params, opt_state, grad_norm)."""
        gnorm = global_norm(grads)
        params, opt_state = opt.update(grads, opt_state, params, step)
        return params, opt_state, gnorm

    def train_step(params, opt_state, batch, step):
        loss, aux, grads = grads_of(params, batch)
        params, opt_state, gnorm = apply(params, opt_state, grads, step)
        return params, opt_state, dict(aux, loss=loss, grad_norm=gnorm)

    # The step's two halves, for the dry run to measure apart.
    train_step.grads = grads_of
    train_step.apply = apply
    return train_step
