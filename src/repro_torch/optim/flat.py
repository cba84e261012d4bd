"""Flat-buffer optimizers for the federated hot path (``repro.optim.flat``).

State lives as fp32 ``(m, n)`` accumulator matrices next to the flat
parameter carry, and each update is one fused pass through
:func:`repro_torch.kernels.dispatch.flat_opt_update` (the hand-written
kernels on the card, the plain PyTorch versions on the CPU). The
within-period weight (variation mask x decay, eq. 10) is folded into the
gradient before moment accumulation, so a masked agent's momentum does not
advance. Adam's step count ``t`` is a host integer.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import dispatch


@dataclasses.dataclass(frozen=True)
class FlatOptimizer:
    """Optimizer spec for flat ``(m, n)`` parameter buffers.

    kind: 'sgd' | 'momentum' | 'adam' (see ``dispatch.flat_opt_update``).
    """

    kind: str
    beta: float = 0.9          # momentum
    nesterov: bool = False     # momentum
    b1: float = 0.9            # adam
    b2: float = 0.95           # adam
    eps: float = 1e-8          # adam
    weight_decay: float = 0.0  # adam

    def __post_init__(self):
        if self.kind not in dispatch.OPT_KINDS:
            raise ValueError(
                f"unknown optimizer kind {self.kind!r}; expected one of "
                f"{dispatch.OPT_KINDS}"
            )

    def init(self, flat: torch.Tensor) -> dict:
        """fp32 accumulator state for a flat (n,) or (m, n) parameter buffer,
        on the buffer's device."""
        z = lambda: torch.zeros(flat.shape, dtype=torch.float32,
                                device=flat.device)
        if self.kind == "sgd":
            return {}
        if self.kind == "momentum":
            return {"mu": z()}
        return {"mu": z(), "nu": z(), "t": 0}

    def update(self, params, g, w, state, lr, *, inplace: bool = False):
        """One fused weighted step: returns ``(new_params, new_state)``."""
        return dispatch.flat_opt_update(
            params, g, w, state,
            kind=self.kind, lr=lr,
            beta=self.beta, nesterov=self.nesterov,
            b1=self.b1, b2=self.b2, eps=self.eps,
            weight_decay=self.weight_decay, inplace=inplace,
        )

    @property
    def n_moments(self) -> int:
        """Number of (m, n) moment matrices the state carries."""
        return {"sgd": 0, "momentum": 1, "adam": 2}[self.kind]


def server_average_state(strat, opt_state: dict) -> dict:
    """Server-sync the fp32 accumulators alongside the params (FedAvg-style):
    every (m, n) moment matrix is overwritten, row by row, with its row mean
    (a copy into a contiguous buffer, never a stride-0 view); shared scalars
    (Adam's ``t``) pass through. Returns ``opt_state``."""
    for leaf in opt_state.values():
        if isinstance(leaf, torch.Tensor) and leaf.ndim == 2:
            leaf.copy_(strat.flat_server_average(leaf)[None, :].expand_as(leaf))
    return opt_state


def flat_sgd() -> FlatOptimizer:
    return FlatOptimizer(kind="sgd")


def flat_momentum(beta: float = 0.9, nesterov: bool = False) -> FlatOptimizer:
    return FlatOptimizer(kind="momentum", beta=beta, nesterov=nesterov)


def flat_adam(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
              weight_decay: float = 0.0) -> FlatOptimizer:
    return FlatOptimizer(kind="adam", b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay)
