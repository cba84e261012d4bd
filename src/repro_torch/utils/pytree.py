"""Parameter-tree algebra over nested dicts of tensors (``repro.utils.pytree``).

Only what the port uses: the squared-norm metric of the task-generic driver
(``repro_torch.core.fmarl``), the global norm of the tree optimizers'
gradient clip (``repro_torch.optim.optimizers``) and their leafwise map.
Leaves are taken in ``jax.tree.leaves``' order (mapping keys sorted at every
level, sequences in order) and reduced as the JAX package reduces them: one
fp32 ``sum(x * y)`` per leaf, added left to right from 0.0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import tree_leaves


def tree_dot(a, b) -> torch.Tensor:
    """``sum_leaves sum(a * b)`` in fp32: a 0-d tensor on the leaves' device."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        raise ValueError(f"tree_dot: {len(la)} leaves vs {len(lb)}")
    total = None
    for x, y in zip(la, lb):
        s = torch.sum(x.float() * y.float())
        total = s if total is None else total + s
    if total is None:
        raise ValueError("tree_dot: empty tree")
    return total


def tree_l2_norm(tree) -> torch.Tensor:
    """``sqrt(tree_dot(tree, tree))``: square it for the squared norm, as the
    JAX driver does (``tree_l2_norm(g) ** 2``)."""
    return torch.sqrt(tree_dot(tree, tree))


def tree_map(fn, *trees):
    """``fn`` over the leaves of matching nested dicts, lists and tuples."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)
