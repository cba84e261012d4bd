"""Variation-aware local-update schedules (paper §IV, eq. 6; A2).

The counterpart of ``repro.core.variation``, in numpy: the schedules are host
data, and the same inputs give the same arrays as the JAX package's.

Agent i performs tau_i = floor(tau * E[x_1] / E[x_i]) local updates in a
period; the synchronous loop simulates this with per-agent indicator masks
I(tau_i > s - t0) that zero the contributions of agents which have already
used up their budget for the period.
"""
from __future__ import annotations

import numpy as np


def tau_schedule(tau: int, mean_times: np.ndarray) -> np.ndarray:
    """Eq. (6): tau_i = floor(tau * E[x_1] / E[x_i]) with E[x] sorted ascending."""
    t = np.asarray(mean_times, np.float64)
    if np.any(t <= 0):
        raise ValueError("mean step times must be positive")
    if np.any(np.diff(t) < 0):
        raise ValueError("paper orders agents by E[x_1] <= ... <= E[x_N]")
    # epsilon guards fp rounding: floor(7 * 0.1/0.1) must be 7, not 6
    taus = np.floor(tau * t[0] / t + 1e-9).astype(int)
    return np.maximum(taus, 1)  # tau_i in N^+ (A2.1 lower end)


def uniform_taus(tau_lo: int, tau_hi: int, m: int, seed: int = 0) -> np.ndarray:
    """The paper's 'tau = a~b' notation: tau_i ~ Uniform{a..b}, tau_1 = b.

    A2.3 requires at least one agent with tau_i = tau (the pacing agent), so
    agent 0 is pinned to tau_hi and the schedule sorted descending per A2.2.
    """
    rng = np.random.default_rng(seed)
    taus = rng.integers(tau_lo, tau_hi + 1, size=m)
    taus[0] = tau_hi
    return np.sort(taus)[::-1].copy()


def tau_stats(taus: np.ndarray) -> tuple[float, float]:
    """(nu, omega^2): mean and variance of {tau_i} (A2.4/A2.5)."""
    taus = np.asarray(taus, np.float64)
    return float(taus.mean()), float(taus.var())


def indicator_mask(taus, period_offsets) -> np.ndarray:
    """I(tau_i > s - t0) as an (m, len(offsets)) float32 mask; a batch of
    schedules ``(S, m)`` gives ``(S, m, len(offsets))``."""
    taus = np.asarray(taus)[..., None]
    offs = np.asarray(period_offsets)
    return (taus > offs).astype(np.float32)


def mask_from_taus(taus, tau: int) -> np.ndarray:
    """The strategy-shaped (m, tau) variation mask from a tau_i vector, or
    the ``(S, m, tau)`` masks of S schedules ``(S, m)`` (one per run of a
    sweep). Integer schedules given as float32 (the sweep's axis points)
    compare exactly, so the mask is the static constructor's."""
    return indicator_mask(taus, np.arange(tau))


def masked_update_counts(taus, n_offsets: int) -> np.ndarray:
    """Per-agent local-update counts within the first ``n_offsets`` offsets:
    ``min(tau_i, n_offsets)``, the sum of the first mask columns."""
    return np.minimum(np.asarray(taus), int(n_offsets))


def validate_a2(taus: np.ndarray, tau: int) -> None:
    """Assert the A2 conditions; raises ValueError on violation."""
    taus = np.asarray(taus)
    if np.any((taus < 1) | (taus > tau)):
        raise ValueError("A2.1: tau_i in {1..tau}")
    if np.any(np.diff(taus) > 0):
        raise ValueError("A2.2: tau_i sorted non-increasing")
    if not np.any(taus == tau):
        raise ValueError("A2.3: at least one agent with tau_i = tau")
