"""Decay functions D(s) for the decay-based method (paper §V-C, A3, eq. 21).

The counterpart of ``repro.core.decay``: each family maps within-period
offsets j = s - t0 to weights, computed in fp32 with the same operations as
the JAX package (CPU tensors; the tables are host data). A3 requires D
periodic with period tau, D(t0) = 1, and D non-increasing over a period with
values in [0, 1].
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

DecayFn = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class _Named:
    fn: DecayFn
    name: str

    def __call__(self, j):
        return self.fn(torch.as_tensor(j, dtype=torch.float32))


def exponential_decay(lam: float) -> DecayFn:
    """The paper's eq. (21): D(s) = lambda^{s/2} with s the period offset."""
    if not (0.0 < lam <= 1.0):
        raise ValueError(f"decay constant must be in (0, 1], got {lam}")
    base = torch.tensor(lam, dtype=torch.float32)
    return _Named(lambda j: torch.pow(base, j / 2.0), f"exp(lam={lam})")


def linear_decay(tau: int, floor: float = 0.0) -> DecayFn:
    """D(j) = 1 - (1 - floor) * j / tau (never reaches floor inside a period)."""
    if tau < 1:
        raise ValueError("tau >= 1 required")
    return _Named(
        lambda j: torch.clamp(1.0 - (1.0 - floor) * j / float(tau), floor, 1.0),
        f"linear(tau={tau},floor={floor})",
    )


def cosine_decay(tau: int, floor: float = 0.0) -> DecayFn:
    """Half-cosine from 1 to floor over a period."""
    if tau < 1:
        raise ValueError("tau >= 1 required")

    def fn(j):
        frac = torch.clamp(j / float(max(tau, 1)), 0.0, 1.0)
        return floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))

    return _Named(fn, f"cosine(tau={tau},floor={floor})")


def step_decay(drop_at: int, low: float = 0.5) -> DecayFn:
    """D = 1 for j < drop_at else low."""
    if not (0.0 <= low <= 1.0):
        raise ValueError("low must be in [0, 1]")
    return _Named(
        lambda j: torch.where(j < drop_at, torch.tensor(1.0),
                              torch.tensor(low, dtype=torch.float32)),
        f"step({drop_at},{low})",
    )


def no_decay() -> DecayFn:
    """Identity weight (reduces the decay-based method to plain periodic avg)."""
    return _Named(lambda j: torch.ones_like(j), "none")


def exponential_decay_table(lam, tau: int) -> np.ndarray:
    """Eq. (21) tabulated for many decay constants at once: ``lam^(j/2)``
    for j in 0..tau-1 in fp32, shaped ``lam.shape + (tau,)`` — ``(tau,)``
    for one constant, ``(m, tau)`` for one per agent, ``(S, tau)`` /
    ``(S, m, tau)`` for one (or one per agent) per run. Each entry is the
    fp32 ``torch.pow`` of :func:`exponential_decay`, so a table row equals
    that function's weights bitwise."""
    lam = torch.as_tensor(np.asarray(lam, np.float32))
    offs = torch.arange(tau, dtype=torch.float32) / 2.0
    return torch.pow(lam[..., None], offs).numpy()


def decay_sq_prefix_sum(decay: DecayFn, j: int) -> float:
    """Z(j) = sum_{s=0}^{j-1} D^2(s) (T3, T4): the fp32 squares added left
    to right in fp32, the order XLA's CPU reduction takes for up to 32
    terms, so that Z and T3 are the JAX package's bits there."""
    w = decay(torch.arange(j))
    sq = (w * w).numpy()
    return float(np.cumsum(sq, dtype=np.float32)[-1]) if j > 0 else 0.0
