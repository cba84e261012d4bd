"""Consensus gossip operators (paper Alg. 2, eq. 23), on dicts of tensors.

The counterpart of ``repro.core.consensus``. Two realizations of the same
math g <- (I - eps*La) g applied E times, on a pytree (nested dicts) of
``(m, ...)`` tensors whose leading axis is the agent:

* ``consensus_rounds_dense`` — E explicit rounds with the fp32 mixing matrix
  P: the paper-faithful reference, and the explicit E-round oracle of the
  port's tests;
* ``consensus_rounds_matrix`` — P^E applied once (one matmul instead of E).

The fused hot-path form is ``repro_torch.kernels.dispatch.consensus_mix``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.topology import Topology, mixing_matrix


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return {k: _tree_map(fn, v) for k, v in tree.items()}


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]


def _mix_leaf(p: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Apply the (m, m) mixing matrix over the leading replica axis."""
    flat = leaf.reshape(leaf.shape[0], -1)
    return (p @ flat).reshape(leaf.shape)


def consensus_rounds_dense(grads, topo: Topology, eps: float, rounds: int):
    """E explicit gossip rounds of eq. (23): each round is
    g_i += eps * sum_{l in Omega_i} (g_l - g_i), i.e. g <- (I - eps*La) g."""
    p = torch.tensor(mixing_matrix(topo, eps), dtype=torch.float32,
                     device=_leaves(grads)[0].device)
    out = grads
    for _ in range(rounds):
        out = _tree_map(lambda leaf: _mix_leaf(p, leaf), out)
    return out


def consensus_rounds_matrix(grads, topo: Topology, eps: float, rounds: int):
    """Fused form: apply P^E once. Mathematically identical to E rounds."""
    pe = np.linalg.matrix_power(mixing_matrix(topo, eps), rounds)
    p = torch.tensor(pe, dtype=torch.float32,
                     device=_leaves(grads)[0].device)
    return _tree_map(lambda leaf: _mix_leaf(p, leaf), grads)


def disagreement(grads) -> torch.Tensor:
    """Frobenius disagreement ||G (I - J)||_F^2 across the replica axis: the
    quantity the T5 proof contracts by (1 - eps*mu2)^{2E}."""
    def leaf_dis(leaf):
        mean = leaf.mean(0, keepdim=True)
        return torch.sum(torch.square(leaf - mean))

    return torch.sum(torch.stack([leaf_dis(l) for l in _leaves(grads)]))
