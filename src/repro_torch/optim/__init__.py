"""Functional optimizers over param dicts, plus LR schedules."""
from repro_torch.optim.optimizers import (
    Optimizer,
    OPTIMIZERS,
    make_optimizer,
    sgd,
    sgd_momentum,
    adam,
    adamw,
    apply_updates,
    masked_update,
)
from repro_torch.optim.schedules import (constant_lr, cosine_decay,
                                         linear_warmup_cosine)

__all__ = [
    "Optimizer",
    "OPTIMIZERS",
    "make_optimizer",
    "sgd",
    "sgd_momentum",
    "adam",
    "adamw",
    "apply_updates",
    "masked_update",
    "constant_lr",
    "cosine_decay",
    "linear_warmup_cosine",
]
