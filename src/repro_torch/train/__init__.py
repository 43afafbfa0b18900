"""Training: optimizers, the train step (microbatch accumulation), the loop
and npz checkpoints (the reference's format)."""

from repro_torch.train.optim import OptConfig, Optimizer, make_optimizer  # noqa: F401
from repro_torch.train.step import make_train_step  # noqa: F401
