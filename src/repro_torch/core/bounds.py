"""Closed-form convergence bounds and the utility function (paper §IV-§V).

The counterpart of ``repro.core.bounds``: the executable oracles for T1,
T2, T3 (numeric), T4, T5, the learning-rate condition (14), the resource
costs (7)/(27) and the system utility (13). Plain float and numpy math, the
JAX module's own operations in its own order, so that every function gives
the JAX package's bits on the same inputs (tests/test_torch_bounds.py). It
needs no device: the port's ``decay_sq_prefix_sum`` (T3) and
``spectral_gap_factor`` (T5) are host code too.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.decay import DecayFn, decay_sq_prefix_sum
from repro_torch.core.topology import Topology, spectral_gap_factor


@dataclasses.dataclass(frozen=True)
class SgdConstants:
    """A1 constants + run geometry shared by every bound."""

    L: float            # Lipschitz smoothness
    sigma2: float       # gradient-variance constant sigma^2
    beta: float         # gradient-variance slope beta
    eta: float          # learning rate
    K: int              # total iterations
    m: int              # participating agents
    f0_minus_finf: float  # F(theta_0) - F_inf


def eta_condition(c: SgdConstants, tau: int) -> float:
    """LHS of eq. (14); feasible iff <= 0."""
    eL = c.eta * c.L
    return (
        eL * (c.beta / c.m + 1.0)
        - 1.0
        + 2.0 * eL * eL * tau * c.beta
        + eL * eL * tau * (tau + 1.0)
    )


def max_feasible_eta(c: SgdConstants, tau: int, tol: float = 1e-12) -> float:
    """Largest eta satisfying (14) (bisection; the LHS is increasing in eta)."""
    lo, hi = 0.0, 1.0 / max(c.L, 1e-30)
    base = dataclasses.asdict(c)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        base["eta"] = mid
        if eta_condition(SgdConstants(**base), tau) <= 0.0:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol:
            break
    return lo


def _common_terms(c: SgdConstants) -> float:
    """First two RHS terms shared by (15), (17), (22), (26)."""
    return 2.0 * c.f0_minus_finf / (c.eta * c.K) + c.eta * c.L * c.sigma2 / c.m


def periodic_bound_t1(c: SgdConstants, tau: int) -> float:
    """Eq. (15): psi_1 under classic periodic averaging (tau_i = tau)."""
    return _common_terms(c) + (c.eta * c.L) ** 2 * c.sigma2 * (tau + 1.0)


def variation_bound_t2(c: SgdConstants, tau: int, nu: float, omega2: float) -> float:
    """Eq. (17): psi_1 under variation-aware periodic averaging."""
    if not (1.0 <= nu <= tau):
        raise ValueError(f"A2 implies 1 <= nu <= tau, got nu={nu}, tau={tau}")
    bracket = -(nu**2) + (2.0 * tau + 1.0) * nu - omega2
    return _common_terms(c) + (c.eta * c.L) ** 2 * c.sigma2 / tau * bracket


def variation_bound_t2_empirical(c: SgdConstants, tau: int, taus) -> float:
    """Finite-m version of (17) from the proof: (1/m)sum(tau_i + 2*tau*tau_i - tau_i^2)/tau."""
    taus = np.asarray(taus, np.float64)
    bracket = float(np.mean(taus + 2.0 * tau * taus - taus**2))
    return _common_terms(c) + (c.eta * c.L) ** 2 * c.sigma2 / tau * bracket


def decay_bound_numeric(c: SgdConstants, tau: int, taus, decay: DecayFn) -> float:
    """T3's psi_3 evaluated numerically for an arbitrary A3 decay function.

    Third term = (2 eta^2 L^2 sigma^2 / (m tau)) * sum_i sum_{j=1..tau}
    min{Z(tau_i), Z(j)} with Z(j) = sum_{s<j} D^2(s)  (proof of T3/T4).
    """
    taus = np.asarray(taus, int)
    z = np.array([decay_sq_prefix_sum(decay, j) for j in range(tau + 1)])
    tot = 0.0
    for ti in taus:
        for j in range(1, tau + 1):
            tot += min(z[ti], z[j])
    third = 2.0 * (c.eta * c.L) ** 2 * c.sigma2 / (len(taus) * tau) * tot
    return _common_terms(c) + third


def decay_bound_t4(c: SgdConstants, tau: int, lam: float) -> float:
    """Eq. (22): psi_3 for D(s) = lam^{s/2} with tau_i ~ Uniform{1..tau}."""
    if not (0.0 < lam < 1.0):
        raise ValueError("T4 closed form needs lam in (0,1); lam=1 reduces to T2")
    one = 1.0 - lam
    bracket = (
        tau / one
        - 2.0 * lam / one**2
        + lam * (lam + 1.0) * (1.0 - lam**tau) / (tau * one**3)
    )
    return _common_terms(c) + 2.0 * (c.eta * c.L) ** 2 * c.sigma2 / tau * bracket


def consensus_bound_t5(
    c: SgdConstants, tau: int, topo: Topology, eps: float, rounds: int
) -> float:
    """Eq. (26): psi_1 scaled by the gossip contraction (1 - eps*mu2)^{2E}."""
    factor = spectral_gap_factor(topo, eps, rounds)
    return _common_terms(c) + (c.eta * c.L) ** 2 * c.sigma2 * (tau + 1.0) * factor


# ----------------------------------------------------------------------------
# Resource cost and utility (eqs. 7, 27, 13)
# ----------------------------------------------------------------------------

def resource_cost_periodic(
    *, m: int, taus, tau: int, T: int, U: int, P: int, c1: float, c2: float
) -> float:
    """Eq. (7): psi_0 = sum_i [C1*T*U/(tau*P) + C2*tau_i*T*U/(tau*P)]."""
    taus = np.asarray(taus, np.float64)
    if len(taus) != m:
        raise ValueError("need one tau_i per agent")
    rounds = T * U / (tau * P)
    return float(np.sum(c1 * rounds + c2 * taus * rounds))


def resource_cost_consensus(
    *,
    m: int,
    taus,
    tau: int,
    T: int,
    U: int,
    P: int,
    c1: float,
    c2: float,
    topo: Topology,
    rounds: int,
    w1: float,
    w2: float,
) -> float:
    """Eq. (27): psi_4 = psi_0 + sum_i |Omega_i| (W1+W2) E T U / P."""
    base = resource_cost_periodic(m=m, taus=taus, tau=tau, T=T, U=U, P=P, c1=c1, c2=c2)
    degs = topo.degrees.astype(np.float64)
    extra = float(np.sum(degs * (w1 + w2) * rounds * T * U / P))
    return base + extra


def utility(*, psi1: float, psi2: float, psi0: float, alpha: float = 1.0) -> float:
    """Eq. (13): alpha * (psi2 - psi1) / psi0 — convergence gain per unit cost."""
    if psi0 <= 0:
        raise ValueError("resource cost must be positive")
    return alpha * (psi2 - psi1) / psi0
