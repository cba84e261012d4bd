"""Optimizers of the port (``repro.optim``): the flat-buffer optimizers of
the federated hot path, the tree optimizers (the plain reference of LM
training) and the learning-rate schedules."""
from repro_torch.optim.flat import (
    FlatOptimizer,
    flat_adam,
    flat_momentum,
    flat_sgd,
    server_average_state,
)
from repro_torch.optim.optimizers import (
    Optimizer,
    adamw,
    clip_by_global_norm,
    momentum,
    sgd,
)
from repro_torch.optim.schedules import constant_lr, cosine_lr, warmup_cosine_lr

__all__ = [
    "FlatOptimizer",
    "Optimizer",
    "adamw",
    "clip_by_global_norm",
    "constant_lr",
    "cosine_lr",
    "flat_adam",
    "flat_momentum",
    "flat_sgd",
    "momentum",
    "server_average_state",
    "sgd",
    "warmup_cosine_lr",
]
