"""Tree optimizers (``repro.optim.optimizers``): the same init / update API
over nested dicts (and lists) of tensors.

They are the plain reference of the port's LM training: the trainer
(``repro_torch.launch.fedtrain``) updates a flat ``(A, n)`` parameter
buffer through ``dispatch.flat_opt_update`` (one ``adam_update`` launch on
the card), and the tests hold that flat update against :func:`adamw` here.
AdamW keeps its moments in ``state_dtype`` (fp32 by default, bf16 halves
the memory) whatever the parameter dtype; the arithmetic runs in fp32, with
each Python-number factor rounded to fp32 as jnp rounds it.
:func:`clip_by_global_norm` reduces as the JAX package does
(``repro_torch.utils.pytree.tree_l2_norm``): one fp32 ``sum(g * g)`` per
leaf, added in ``jax.tree.leaves`` order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.kernels.dispatch import adam_bias_corrections
from repro_torch.optim.flat import (
    FlatOptimizer,
    flat_adam,
    flat_momentum,
    flat_sgd,
)
from repro_torch.utils.pytree import tree_l2_norm, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (updates, state)
    # the same update on flat (m, n) buffers (fp32 moments), None where
    # there is none (bf16 moments)
    flat: Optional[FlatOptimizer] = None

    def apply(self, grads, state, params, lr):
        """One step: ``params + updates`` in fp32, cast back to each
        parameter's dtype. Returns ``(params, state)``; nothing is written
        in place."""
        updates, state = self.update(grads, state, params, lr)
        params = tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                          updates)
        return params, state


def _lr32(lr) -> torch.Tensor:
    return torch.as_tensor(lr, dtype=F32)


def sgd() -> Optimizer:
    return Optimizer(
        init=lambda params: (),
        update=lambda g, s, p, lr: (
            tree_map(lambda gi: -_lr32(lr).to(gi.device) * gi.float(), g), s),
        flat=flat_sgd(),
    )


def momentum(beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                    device=p.device), params)}

    def update(g, s, p, lr):
        m = tree_map(lambda mi, gi: beta * mi + gi.float(), s["m"], g)
        if nesterov:
            upd = tree_map(lambda mi, gi: -_lr32(lr).to(mi.device)
                           * (beta * mi + gi.float()), m, g)
        else:
            upd = tree_map(lambda mi: -_lr32(lr).to(mi.device) * mi, m)
        return upd, {"m": m}

    return Optimizer(init, update, flat_momentum(beta, nesterov))


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, state_dtype=F32) -> Optimizer:
    """AdamW with bias correction; ``state["t"]`` is the 0-d int32 step
    count. ``state_dtype=torch.bfloat16`` stores the moments in bf16; the
    update math still runs in fp32."""
    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "t": torch.zeros((), dtype=torch.int32)}

    def update(g, s, p, lr):
        t = s["t"] + 1
        m = tree_map(lambda mi, gi: (b1 * mi.float() + (1 - b1) * gi.float()
                                     ).to(mi.dtype), s["m"], g)
        v = tree_map(lambda vi, gi: (b2 * vi.float() + (1 - b2)
                                     * torch.square(gi.float())
                                     ).to(vi.dtype), s["v"], g)
        bc1, bc2 = adam_bias_corrections(int(t), b1, b2)

        def upd(mi, vi, pi):
            d = mi.device
            step = (mi.float() / torch.tensor(bc1, dtype=F32, device=d)) / (
                torch.sqrt(vi.float() / torch.tensor(bc2, dtype=F32,
                                                     device=d)) + eps)
            if weight_decay:
                step = step + weight_decay * pi.float()
            return -_lr32(lr).to(d) * step

        return tree_map(upd, m, v, p), {"m": m, "v": v, "t": t}

    flat = (flat_adam(b1, b2, eps, weight_decay) if state_dtype == F32
            else None)
    return Optimizer(init, update, flat)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads * min(1, max_norm / max(norm, 1e-12)), norm)``: each leaf
    times the fp32 scale, in fp32 (jnp promotes a bf16 leaf times the fp32
    scale to fp32; torch would keep bf16 for a 0-d factor)."""
    norm = tree_l2_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm
