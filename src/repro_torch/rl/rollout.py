"""Heterogeneous-fleet rollouts (``repro.rl.rollout``) as batched tensors.

Agent i owns its own environment (an :class:`~repro_torch.rl.env.EnvParams`
row, possibly perturbed per agent) and B parallel copies of it; agent i's
policy replica drives every RL vehicle of its envs. Where the JAX package
scans over time and vmaps over (m, B), this is a Python loop over time whose
every step is one batched tensor program over the whole ``(m, B)`` fleet.
Trajectory buffers come out shaped ``(m, B, P, ...)``:

    obs       (m, B, P, n_rl, OBS_DIM)
    act       (m, B, P, n_rl, act_dim)
    logp_old  (m, B, P, n_rl)
    val       (m, B, P, n_rl)
    rew       (m, B, P)          — team NAS reward, shared within an env

The draws are operands: the reset jitter ``(m, B, N)`` and the action noise
``(P, m, B, n_rl, act_dim)``.
"""
from __future__ import annotations

import torch

from repro_torch.rl.env import (
    EnvConfig,
    EnvParams,
    EnvState,
    env_reset,
    env_step,
    get_obs,
)
from repro_torch.rl.policy import policy_value, sample_action
from repro_torch.rl.ppo import gae


def fleet_params(env_params: EnvParams) -> EnvParams:
    """``(m,)`` per-agent parameters as ``(m, 1)``, to broadcast against the
    ``(m, B)`` env axes."""
    return EnvParams(*(l[:, None] for l in env_params))


def fleet_reset(cfg: EnvConfig, env_params: EnvParams,
                jitter_u: torch.Tensor) -> EnvState:
    """Reset an (m, B) fleet from its ``(m, B, N)`` jitter draw; the state's
    leaves carry leading (m, B) axes."""
    return env_reset(cfg, jitter_u, params=fleet_params(env_params))


def _act(policy_m, obs, noise):
    """Every vehicle of agent i's envs acts through agent i's policy."""
    m = obs.shape[0]
    lead = obs.shape[:-1]
    flat_obs = obs.reshape(m, -1, obs.shape[-1])
    acts, logps = sample_action(policy_m, flat_obs,
                                noise.reshape(m, -1, noise.shape[-1]))
    vals = policy_value(policy_m, flat_obs)
    return (acts.reshape(lead + acts.shape[-1:]), logps.reshape(lead),
            vals.reshape(lead))


def fleet_rollout(cfg: EnvConfig, env_params: EnvParams, policy_m,
                  env_state: EnvState, noise: torch.Tensor):
    """Roll the fleet forward ``P = noise.shape[0]`` steps.

    ``env_params``: (m,)-leaved EnvParams; ``policy_m``: stacked policy
    parameters (leading (m,) axis); ``env_state``: (m, B)-leaved EnvState;
    ``noise``: ``(P, m, B, n_rl, act_dim)`` standard normals. Returns
    ``(env_state, traj)`` with traj buffers shaped (m, B, P, ...).
    """
    pe = fleet_params(env_params)
    steps = {"obs": [], "act": [], "logp_old": [], "val": [], "rew": []}
    for t in range(noise.shape[0]):
        obs = get_obs(cfg, env_state, params=pe)          # (m, B, n_rl, obs)
        acts, logps, vals = _act(policy_m, obs, noise[t])
        env_state, reward, _ = env_step(cfg, env_state, acts[..., 0], params=pe)
        for k, v in (("obs", obs), ("act", acts), ("logp_old", logps),
                     ("val", vals), ("rew", reward)):
            steps[k].append(v)
    return env_state, {k: torch.stack(v, dim=2) for k, v in steps.items()}


def fleet_last_values(cfg: EnvConfig, env_params: EnvParams, policy_m,
                      env_state: EnvState) -> torch.Tensor:
    """Bootstrap values for GAE at the rollout horizon: (m, B, n_rl)."""
    obs = get_obs(cfg, env_state, params=fleet_params(env_params))
    m = obs.shape[0]
    return policy_value(policy_m, obs.reshape(m, -1, obs.shape[-1])).reshape(
        obs.shape[:-1])


def fleet_gae(rew: torch.Tensor, val: torch.Tensor, last_val: torch.Tensor, *,
              gamma: float, lam: float):
    """GAE along the time axis of fleet buffers: ``rew`` (m, B, P) shared
    team reward, ``val`` (m, B, P, n_rl), ``last_val`` (m, B, n_rl). Returns
    ``(adv, ret)``, each (m, B, P, n_rl): one stream per (env, vehicle)."""
    r = rew[..., None].expand(val.shape).movedim(2, -1)      # (m, B, n_rl, P)
    adv, ret = gae(r, val.movedim(2, -1), last_val, gamma=gamma, lam=lam)
    return adv.movedim(-1, 2), ret.movedim(-1, 2)


def fleet_flatten(tree):
    """Collapse (m, B, P, n_rl, ...) buffers to per-agent transition batches
    (m, B*P*n_rl, ...) for the minibatch-epoch PPO update."""
    return {k: x.reshape((x.shape[0], -1) + tuple(x.shape[4:]))
            for k, x in tree.items()}
