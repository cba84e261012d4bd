"""Flat-buffer optimizers of the port (``repro.optim.flat``)."""
from repro_torch.optim.flat import (
    FlatOptimizer,
    flat_adam,
    flat_momentum,
    flat_sgd,
    server_average_state,
)

__all__ = [
    "FlatOptimizer",
    "flat_adam",
    "flat_momentum",
    "flat_sgd",
    "server_average_state",
]
