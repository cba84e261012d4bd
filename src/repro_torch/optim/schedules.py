"""Learning-rate schedules (``repro.optim.schedules``): callables
``step -> lr`` returning a 0-d fp32 tensor, in fp32 as the JAX package's
jnp forms compute them. A Python-number step is divided in float64 and
rounded once, as Python divides it before jnp sees the quotient; a tensor
step is divided in fp32, as a traced step is."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _ratio(step, n: int) -> torch.Tensor:
    if isinstance(step, (int, float)):
        return _f32(step / n)
    return _f32(step) / n


def constant_lr(lr: float):
    return lambda step: _f32(lr)


def cosine_lr(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        frac = torch.clamp(_ratio(step, max(total_steps, 1)), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(_f32(math.pi) * frac))
        return lr * (final_frac + (1 - final_frac) * cos)
    return f


def warmup_cosine_lr(lr: float, warmup: int, total_steps: int,
                     final_frac: float = 0.1):
    cos = cosine_lr(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        w = torch.clamp(_ratio(step, max(warmup, 1)), 0.0, 1.0)
        return torch.where(_f32(step) < warmup, lr * w, cos(step - warmup))
    return f
