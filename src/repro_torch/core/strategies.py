"""Aggregation strategies: the paper's methods on the flat ``(m, n)`` carry.

The counterpart of ``repro.core.strategies`` for the synchronous
mask/decay family. A strategy owns (a) the within-period weight applied at
each local update (variation mask, times the decay factor for the decay
method), (b) the variation masks I(tau_i > s - t0), and (c) the period length
tau. The server averaging step (eq. 11) is the same for every strategy: the
mean over the replica axis.

The hot path runs through the port's dispatch: the weighted SGD step is one
``decay_accum`` launch with ``d = -eta * w`` (the weight folds into the
coefficient), the momentum/Adam steps one fused optimizer launch, and the
period sync one ``row_mean`` launch whose row is copied back into every row
of the carry. Where the buffers lie picks the path: the hand-written kernels
on the card, the plain PyTorch versions on the CPU.

Not ported yet: ``ConsensusStrategy`` (gossip, with ``core/topology.py`` and
the consensus kernels) and ``AsyncStrategy``; ``make_strategy`` names the
slice that brings each. The payload transforms of ``repro.comm`` are not
ported either: every strategy here communicates dense fp32 rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.decay import DecayFn, no_decay
from repro_torch.core.variation import masked_update_counts, validate_a2
from repro_torch.kernels import dispatch


@dataclasses.dataclass(frozen=True)
class AggregationStrategy:
    """Variation-aware periodic averaging (the paper's base method, T2).

    Attributes:
      tau: local updates per period for the pacing agent (period length).
      taus: per-agent tau_i (A2); shape (m,).
      mask: (m, tau) float32 indicator I(tau_i > j) for period offset j.
    """

    name: str
    tau: int
    taus: np.ndarray
    mask: np.ndarray

    @staticmethod
    def _build_mask(taus: np.ndarray, tau: int) -> np.ndarray:
        offs = np.arange(tau)[None, :]
        return (np.asarray(taus)[:, None] > offs).astype(np.float32)

    @property
    def m(self) -> int:
        return len(self.taus)

    # --- per-step weights ---------------------------------------------------------
    def weight_table(self) -> np.ndarray:
        """``(tau, m)`` fp32: row j is the per-agent weight at offset j (the
        mask column by default)."""
        return np.ascontiguousarray(self.mask.T)

    def weights_on(self, device) -> torch.Tensor:
        """:meth:`weight_table` on ``device``, made once per device; row j
        is a contiguous ``(m,)`` view."""
        cache: Dict = self.__dict__.setdefault("_weights_on", {})
        key = str(torch.device(device))
        if key not in cache:
            cache[key] = torch.tensor(self.weight_table(), device=device)
        return cache[key]

    def weight(self, offset: int, device="cpu") -> torch.Tensor:
        """Per-agent weight vector ``(m,)`` at period offset ``offset``."""
        return self.weights_on(device)[offset]

    # --- flat (m, n) hot path -----------------------------------------------------
    def flat_update(self, params: torch.Tensor, g: torch.Tensor, offset: int,
                    eta: float, *, out: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """Fused transform + local SGD step: ``params - eta * w * g``.

        The weight folds into the accumulation coefficient ``-eta * w`` (fp32,
        as ``strategies.py:243`` computes it), so the whole local update is
        one ``decay_accum`` pass. ``out`` may be ``params``.
        """
        return dispatch.decay_accum(
            params, g, -eta * self.weight(offset, params.device), out=out)

    def flat_opt_step(self, params, g, offset: int, eta: float, opt,
                      opt_state: dict, *, inplace: bool = False):
        """Fused transform + optimizer update on the flat carry; the weight
        folds into the gradient before moment accumulation. Returns
        ``(params, opt_state)``."""
        return opt.update(params, g, self.weight(offset, params.device),
                          opt_state, eta, inplace=inplace)

    def flat_server_average(self, flat: torch.Tensor) -> torch.Tensor:
        """Eq. (11) on the flat carry: the ``(n,)`` mean over the agent axis
        (fp32 accumulation, in ``flat.dtype``)."""
        return dispatch.row_mean(flat)

    def flat_local_step(self, flat: torch.Tensor, g: torch.Tensor,
                        offset: int, eta: float, opt, opt_state: dict):
        """One local step on the flat carry, in place: plain SGD
        (``opt is None``) or the fused optimizer step. Returns
        ``(flat, opt_state)`` with ``flat`` the same buffer, updated."""
        if opt is None:
            self.flat_update(flat, g, offset, eta, out=flat)
            return flat, opt_state
        return self.flat_opt_step(flat, g, offset, eta, opt, opt_state,
                                  inplace=True)

    def flat_sync(self, flat: torch.Tensor) -> torch.Tensor:
        """Period-boundary server sync, in place: the row mean (eq. 11) is
        copied into every row of the contiguous carry (the JAX package
        broadcasts; a stride-0 view here would alias every row of a buffer
        the kernels later write in place). Returns ``flat``."""
        row = self.flat_server_average(flat)
        return flat.copy_(row[None, :].expand_as(flat))

    # --- accounting ---------------------------------------------------------------
    def comm_bytes_per_event(self, payload_elems: int) -> dict:
        """Wire bytes of one C1 uplink / one W1 gossip receive of
        ``payload_elems`` dense fp32 parameters."""
        per = int(payload_elems) * 4
        return {"c1": per, "w1": per}

    def comm_events_per_period(self) -> dict:
        """Event counts in units of C1/C2/W1/W2 for one period (eq. 7)."""
        return {
            "c1": self.m,                      # each agent uploads once per period
            "c2": int(np.sum(self.taus)),      # tau_i local updates each
            "w1": 0,
            "w2": 0,
        }

    def comm_events_partial_period(self, n_offsets: int) -> dict:
        """Event counts for a trailing partial period of ``n_offsets`` steps:
        the first ``n_offsets`` mask columns of local updates (C2) and, when
        any step ran, the final every-replica aggregation read (C1)."""
        n_offsets = int(n_offsets)
        if not 0 <= n_offsets < self.tau:
            raise ValueError(
                f"partial period must satisfy 0 <= n_offsets < tau={self.tau}, "
                f"got {n_offsets}"
            )
        return {
            "c1": self.m if n_offsets else 0,
            "c2": int(masked_update_counts(self.taus, n_offsets).sum()),
            "w1": 0,
            "w2": 0,
        }


class SyncStrategy(AggregationStrategy):
    """tau = 1: classic federated SGD (eq. 4) — the communication-heavy baseline."""

    def __init__(self, m: int):
        taus = np.ones(m, int)
        super().__init__(name="sync", tau=1, taus=taus,
                         mask=self._build_mask(taus, 1))


class PeriodicStrategy(AggregationStrategy):
    """Variation-aware periodic averaging (Alg. 1 / T2). tau_i = tau gives T1."""

    def __init__(self, tau: int, taus: Optional[np.ndarray] = None,
                 m: Optional[int] = None):
        if taus is None:
            if m is None:
                raise ValueError("need taus or m")
            taus = np.full(m, tau, int)
        taus = np.asarray(taus, int)
        validate_a2(taus, tau)
        super().__init__(name=f"periodic(tau={tau})", tau=tau, taus=taus,
                         mask=self._build_mask(taus, tau))


@dataclasses.dataclass(frozen=True)
class DecayStrategy(AggregationStrategy):
    """Decay-based method (T3/T4): weight local grads by D(offset)."""

    decay_weights: np.ndarray = dataclasses.field(default=None)  # (tau,) fp32

    def __init__(self, tau: int, taus=None, m=None, decay: DecayFn = None):
        if taus is None:
            if m is None:
                raise ValueError("need taus or m")
            taus = np.full(m, tau, int)
        taus = np.asarray(taus, int)
        validate_a2(taus, tau)
        decay = decay or no_decay()
        w = decay(torch.arange(tau)).numpy().astype(np.float32)
        if w[0] != 1.0 or np.any(np.diff(w) > 1e-7) or np.any(w < -1e-7):
            raise ValueError("decay function violates A3 over this period")
        object.__setattr__(self, "decay_weights", w)
        AggregationStrategy.__init__(
            self, name=f"decay(tau={tau})", tau=tau, taus=taus,
            mask=self._build_mask(taus, tau),
        )

    def weight_table(self) -> np.ndarray:
        # mask[:, j] * D(j) for every offset j: the fp32 product the JAX
        # strategy takes per step (strategies.py:474-479)
        return np.ascontiguousarray(self.mask.T * self.decay_weights[:, None])


_LATER = {
    "consensus": "the consensus slice (slice 3: core/topology.py and the "
                 "consensus_step / consensus_gather kernels)",
    "async": "the async-federation slice (core/async_fed.py)",
}


def make_strategy(kind: str, *, m: Optional[int] = None,
                  tau: Optional[int] = None, taus=None,
                  decay: Optional[DecayFn] = None,
                  comm=None) -> AggregationStrategy:
    """``sync`` (``m``), ``periodic`` (``tau`` and ``taus`` or ``m``) or
    ``decay`` (the same, plus ``decay``), with the JAX package's keyword
    names. A keyword the kind does not take raises ``TypeError``."""
    if comm is not None:
        raise NotImplementedError(
            "make_strategy: payload compression (repro.comm) is not ported "
            "yet; it comes with the compression slice")
    if kind in _LATER:
        raise NotImplementedError(
            f"make_strategy: {kind!r} is not ported yet; it comes with "
            f"{_LATER[kind]}")
    if kind not in ("sync", "periodic", "decay"):
        raise ValueError(f"unknown strategy kind: {kind}")
    if decay is not None and kind != "decay":
        raise TypeError(f"make_strategy: {kind!r} takes no decay")
    if kind == "sync":
        if tau is not None or taus is not None:
            raise TypeError("make_strategy: 'sync' takes m only (its tau is 1)")
        return SyncStrategy(m=m)
    if tau is None:
        raise TypeError(f"make_strategy: {kind!r} needs tau")
    if kind == "periodic":
        return PeriodicStrategy(tau=tau, taus=taus, m=m)
    return DecayStrategy(tau=tau, taus=taus, m=m, decay=decay)
