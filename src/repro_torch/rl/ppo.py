"""Policy-gradient losses (``repro.rl.ppo``): PPO, TRPO-as-KL-penalty, TAC.

Every loss here takes *stacked* parameters (leading agent axis m, see
``repro_torch.rl.policy``) and a trajectory batch whose leaves lead with
``(m, D)``, and returns the ``(m,)`` per-agent losses: agent i's loss is the
JAX package's loss of agent i's parameters on agent i's D transitions. The
agents' losses are independent, so the gradient of their sum with respect to
the stacked parameters is the per-agent gradient matrix, and one
``backward`` gives every agent's gradient at once.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.rl.policy import (
    gaussian_entropy,
    gaussian_logp,
    policy_apply,
    policy_value,
    tsallis2_entropy,
)


def gae(rewards: torch.Tensor, values: torch.Tensor, last_value: torch.Tensor,
        *, gamma: float = 0.99, lam: float = 0.95
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalised advantage estimation along the last axis.

    ``rewards``/``values``: ``(..., P)``; ``last_value``: ``(...)``. Returns
    ``(advantages, returns)``, each ``(..., P)``: the reverse scan of the JAX
    package, one time step at a time.
    """
    P = rewards.shape[-1]
    advs = [None] * P
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    for t in range(P - 1, -1, -1):
        v = values[..., t]
        delta = rewards[..., t] + gamma * v_next - v
        adv_next = delta + gamma * lam * adv_next
        advs[t] = adv_next
        v_next = v
    adv = torch.stack(advs, dim=-1)
    return adv, adv + values


def _policy_terms(params, traj):
    mean, log_std = policy_apply(params, traj["obs"])
    logp = gaussian_logp(traj["act"], mean, log_std)
    ratio = torch.exp(logp - traj["logp_old"])
    adv = traj["adv"]
    # per-agent normalisation with the population std (ddof 0), spelled as
    # jnp.std computes it
    centered = adv - adv.mean(-1, keepdim=True)
    std = torch.sqrt((centered * centered).mean(-1, keepdim=True))
    adv = centered / (std + 1e-8)
    v = policy_value(params, traj["obs"])
    d = v - traj["ret"]
    vf = torch.mean(d * d, dim=-1)
    return ratio, adv, vf, log_std[..., 0, :], logp


def _clipped_surrogate(ratio, adv, clip):
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv
    return -torch.mean(torch.minimum(unclipped, clipped), dim=-1)


def ppo_loss(params, traj, *, clip=0.2, vf_coef=0.5, ent_coef=0.01):
    ratio, adv, vf, log_std, _ = _policy_terms(params, traj)
    pg = _clipped_surrogate(ratio, adv, clip)
    return pg + vf_coef * vf - ent_coef * gaussian_entropy(log_std)


def trpo_kl_loss(params, traj, *, kl_coef=1.0, vf_coef=0.5):
    """Trust region as a KL penalty: -E[ratio * A] + beta * E[KL(old || new)],
    the KL estimated from the old policy's samples."""
    ratio, adv, vf, log_std, logp = _policy_terms(params, traj)
    pg = -torch.mean(ratio * adv, dim=-1)
    kl = torch.mean(traj["logp_old"] - logp, dim=-1)
    return pg + kl_coef * kl + vf_coef * vf


def tac_loss(params, traj, *, clip=0.2, vf_coef=0.5, tsallis_coef=0.01):
    """Tsallis actor-critic (q=2): PPO surrogate + Tsallis-2 entropy bonus."""
    ratio, adv, vf, log_std, _ = _policy_terms(params, traj)
    pg = _clipped_surrogate(ratio, adv, clip)
    return pg + vf_coef * vf - tsallis_coef * tsallis2_entropy(log_std)


LOSSES: Dict[str, Callable] = {"ppo": ppo_loss, "trpo": trpo_kl_loss,
                               "tac": tac_loss}


def stacked_grad(loss_fn, flat: torch.Tensor, spec, data
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(grads, losses)``: the ``(m, n)`` per-agent gradients of ``loss_fn``
    at the flat fp32 parameters ``flat`` (viewed through ``spec``) and the
    ``(m,)`` per-agent losses."""
    leaf = flat.detach().requires_grad_(True)
    losses = loss_fn(spec.unravel(leaf), data)
    (grad,) = torch.autograd.grad(losses.sum(), leaf)
    return grad, losses.detach()


def minibatch_epoch_grad(loss_fn, flat: torch.Tensor, spec, data,
                         perms: torch.Tensor = None, *, epochs: int = 1,
                         n_minibatches: int = 1, lr: float = 1e-3):
    """PPO-style minibatch-epoch local optimisation as a pseudo-gradient.

    ``flat`` is the ``(m, n)`` fp32 parameter matrix (one row per agent,
    viewed through ``spec``) and ``data`` each agent's transition batch
    (leaves lead with ``(m, D)``). Runs ``epochs`` shuffled passes of SGD
    over ``n_minibatches`` minibatches from ``flat``, each agent on its own
    data, and reports the displacement as a gradient,
    ``g = (flat - flat_new) / lr``. ``perms`` is the ``(m, epochs, D)``
    integer permutation draw (agent i, epoch e shuffles its batch by
    ``perms[i, e]``). With ``epochs == n_minibatches == 1`` this is the
    plain gradient and ``perms`` is not read. Returns ``(grads, losses)``
    with ``losses`` the ``(m,)`` mean minibatch loss.
    """
    if epochs == 1 and n_minibatches == 1:
        return stacked_grad(loss_fn, flat, spec, data)
    d = next(iter(data.values())).shape[1]
    if d % n_minibatches:
        raise ValueError(
            f"minibatch_epoch_grad: {d} transitions do not split into "
            f"{n_minibatches} minibatches"
        )
    m = flat.shape[0]
    if perms is None or tuple(perms.shape) != (m, epochs, d):
        raise ValueError(f"minibatch_epoch_grad: perms must be ({m}, {epochs}, "
                         f"{d}), got "
                         f"{None if perms is None else tuple(perms.shape)}")
    mb = d // n_minibatches
    rows = torch.arange(m, device=flat.device)[:, None]
    p = flat
    losses = []
    for e in range(epochs):
        perm = perms[:, e]
        shuffled = {k: v[rows, perm] for k, v in data.items()}
        for j in range(n_minibatches):
            batch = {k: v[:, j * mb:(j + 1) * mb] for k, v in shuffled.items()}
            g, loss = stacked_grad(loss_fn, p, spec, batch)
            p = p - lr * g
            losses.append(loss)
    lr_t = torch.full((), lr, dtype=torch.float32, device=flat.device)
    return (flat - p) / lr_t, torch.stack(losses).mean(0)
