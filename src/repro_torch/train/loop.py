"""Training loop: data -> train_step -> metrics/checkpoints.

The reference's `repro.train.loop` on one device: seeded weights
(`models.model.init_model`, the port's own draws), `data.lm.batches_for`'s
bigram batches (the reference's, array for array), one `make_train_step`
call a step, and the reference's history records (the metrics as floats,
`step`, and `wall_s` from `obs.timers.now`). On the card a logged step's
metrics are read after `torch.cuda.synchronize`, so `wall_s` counts the
device's work.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.data.lm import batches_for
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.obs import timers
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optim import OptConfig, make_optimizer
from repro_torch.train.step import make_train_step


def train(
    cfg,
    *,
    num_steps: int,
    seq_len: int,
    global_batch: int,
    opt_cfg: Optional[OptConfig] = None,
    seed: int = 0,
    log_every: int = 10,
    ckpt_path: Optional[str] = None,
    ckpt_every: int = 0,
    on_metrics: Optional[Callable[[int, dict], None]] = None,
    device: DeviceLike = None,
):
    """Train `cfg` on the synthetic bigram stream on `device` (default
    CUDA). Returns (params, history)."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or OptConfig(name=cfg.optimizer, warmup_steps=min(20, num_steps))
    opt = make_optimizer(opt_cfg)

    params = M.init_model(cfg, seed=seed, device=dev)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt)

    data = batches_for(cfg, seq_len, global_batch, seed=seed)
    history = []
    t0 = timers.now()  # monotonic: wall_s can't go negative on an NTP step
    for step, batch in zip(range(num_steps), data):
        # numpy arrays in their own types: the model casts the stub's float32
        # patches or frames to the activations' type, as the reference's does
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        if step % log_every == 0 or step == num_steps - 1:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = timers.now() - t0
            history.append(m)
            if on_metrics:
                on_metrics(step, m)
        if ckpt_path and ckpt_every and step and step % ckpt_every == 0:
            ckpt_lib.save(ckpt_path, params, opt_state, step)
    if ckpt_path:
        ckpt_lib.save(ckpt_path, params, opt_state, num_steps)
    return params, history
