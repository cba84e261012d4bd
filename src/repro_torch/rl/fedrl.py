"""Federated MARL driver (``repro.rl.fedrl``): Algorithms 1 & 2 on the traffic
envs, on the flat ``(m, n)`` carry.

Two rollout regimes share the same federated machinery:

* **Legacy shared env** (``num_envs=0``, the default): the m federated agents
  are the RL-controlled vehicles of ONE environment, each acting under its
  own replica. This is the Table II geometry (m = n_rl = 7 on FIGURE_EIGHT).
* **Heterogeneous fleet** (``num_envs >= 1`` or ``env_params`` set): agent i
  owns its own environment (an ``EnvParams`` row) with B parallel copies
  (``repro_torch.rl.rollout``); each local update runs the PPO
  minibatch-epoch loop over the B*P*n_rl transitions and reports it to the
  strategy as a pseudo-gradient.

Every P transitions each agent takes one local update on its own data; the
strategy weights it by its variation mask / decay factor; every tau local
updates the server averages the replicas (eq. 11) and the optimizer moments
with them. The replicas live as one flat ``(m, n)`` matrix for the whole run
(``n = 9,347`` for the 6-64-1 actor-critic): the rollout and the gradient
read per-agent views of it, the gradient comes back as one ``(m, n)`` matrix
from one ``backward``, and the local step and the sync update the carry in
place through the dispatch (the hand-written kernels on the card).

Where the JAX package runs one jitted scan, this is a Python loop with a
host update counter ``k``. With ``buffer_dtype="bfloat16"`` the flat
parameters and gradients are stored in bf16 (the primitives and the moments
still accumulate in fp32; the rollout and gradient see an fp32 view).

The phases of an update run inside ``torch.profiler.record_function``
ranges (``fedrl.rollout``, ``fedrl.gradient``, ``fedrl.local_step``,
``fedrl.sync``, ``fedrl.eval``; the eval's own rollout and gradient nest in
it), so a profiler window splits an update's time by phase.

The random draws come from a draw source (``repro_torch.rl.draws``): a seed
makes a :class:`~repro_torch.rl.draws.TorchDraws` on the run's device; a
:class:`~repro_torch.rl.draws.ReplayDraws` replays given arrays.

The strategy's communication state (``comm_state``: the server reference
and the error-feedback residuals of a compressed payload transform) is
threaded through the loop beside the optimizer state, as in the JAX flat
driver; the ledger and the bytes curve bill each event at the transform's
``payload_bytes``.

Runs. :func:`run_fedrl_batch` is the driver: it runs S configs that differ
only in their values (learning rate, strategy tables, fleet parameters) as
one batched run on an ``(S, m, n)`` carry, each run with its own draw
source drawn in its own order. The per-agent work (env reset and step, the
rollout, the gradient, the evaluation) runs on S * m agent rows, as
independent as the agents of one run are; aggregation runs per run through
the strategy's per-run tables (``repro_torch.core.strategies.stack_runs``),
one dispatch call (one launch on the card) per primitive for all runs. The
sweep engine (``repro_torch.sweep``) runs a static point through it;
:func:`run_fedrl` is the one-run case, S = 1.

Not ported yet: the tree-space carry (the port keeps the flat one only) and
the async strategy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.accounting import CostLedger
from repro_torch.core.strategies import AggregationStrategy, stack_runs
from repro_torch.kernels import dispatch
from repro_torch.optim.flat import FlatOptimizer, server_average_state
from repro_torch.rl.draws import ReplayDraws, TorchDraws
from repro_torch.rl.env import (
    OBS_DIM,
    EnvConfig,
    EnvParams,
    broadcast_params,
    env_reset,
    env_step,
    get_obs,
)
from repro_torch.rl.policy import GaussianMLPPolicy, policy_value, sample_action
from repro_torch.rl.ppo import LOSSES, gae, minibatch_epoch_grad, stacked_grad
from repro_torch.rl.rollout import (
    fleet_flatten,
    fleet_gae,
    fleet_last_values,
    fleet_reset,
    fleet_rollout,
)

HIDDEN, ACT_DIM = 64, 1        # the actor-critic of repro.rl.policy


@dataclasses.dataclass(frozen=True)
class FedRLConfig:
    env: EnvConfig
    strategy: AggregationStrategy
    eta: float = 1e-3
    n_epochs: int = 100          # U
    epoch_len: int = 200         # T (env steps per epoch)
    minibatch: int = 25          # P (transitions per local update)
    algo: str = "ppo"            # ppo | trpo | tac
    gamma: float = 0.99
    lam: float = 0.95
    eval_seed: int = 1234
    optimizer: Optional[FlatOptimizer] = None  # None = plain SGD
    # --- heterogeneous fleet (repro_torch.rl.rollout) ---
    num_envs: int = 0            # B parallel envs per agent; 0 = legacy shared env
    env_params: Optional[EnvParams] = None  # (m,)-stacked per-agent MDPs
    ppo_epochs: int = 1          # PPO epochs per local update (fleet path)
    n_minibatches: int = 1       # PPO minibatches per epoch (fleet path)
    # --- flat-carry storage dtype (None = fp32); e.g. "bfloat16" ---
    buffer_dtype: Optional[str] = None

    @property
    def fleet(self) -> bool:
        return self.num_envs > 0 or self.env_params is not None

    @property
    def B(self) -> int:
        return max(self.num_envs, 1)

    @property
    def updates_per_epoch(self) -> int:
        return self.epoch_len // self.minibatch

    def __post_init__(self):
        if self.epoch_len % self.minibatch:
            raise ValueError("T must divide into P-sized steps")
        if self.algo not in LOSSES:
            raise ValueError(f"unknown algo {self.algo!r}; expected one of "
                             f"{sorted(LOSSES)}")
        if self.fleet:
            if self.env_params is not None:
                m_p = self.env_params[0].shape[0]
                if m_p != self.strategy.m:
                    raise ValueError(
                        f"env_params carries {m_p} agents, strategy m="
                        f"{self.strategy.m}"
                    )
            d = self.B * self.minibatch * self.env.n_rl
            if d % self.n_minibatches:
                raise ValueError(
                    f"{d} fleet transitions per update do not split into "
                    f"{self.n_minibatches} minibatches"
                )
        elif self.env.n_rl != self.strategy.m:
            raise ValueError(
                f"strategy m={self.strategy.m} must equal n_rl={self.env.n_rl}"
            )
        if self.buffer_dtype is not None:
            storage_dtype(self)  # fail fast on typos


def storage_dtype(cfg: FedRLConfig) -> Optional[torch.dtype]:
    """The flat carry's storage dtype (``None`` = fp32)."""
    if cfg.buffer_dtype is None:
        return None
    dt = getattr(torch, str(cfg.buffer_dtype), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"buffer_dtype {cfg.buffer_dtype!r} is not a torch "
                         f"floating dtype")
    return dt


# --- shapes of the draws ------------------------------------------------------------

def reset_shape(cfg: FedRLConfig) -> tuple:
    n = cfg.env.n_vehicles
    return (cfg.strategy.m, cfg.B, n) if cfg.fleet else (n,)


def noise_shape(cfg: FedRLConfig) -> tuple:
    """One local update's action noise: ``(P, m, act)`` on the shared env,
    ``(P, m, B, n_rl, act)`` on the fleet."""
    if cfg.fleet:
        return (cfg.minibatch, cfg.strategy.m, cfg.B, cfg.env.n_rl, ACT_DIM)
    return (cfg.minibatch, cfg.strategy.m, ACT_DIM)


def shuffles(cfg: FedRLConfig) -> bool:
    """Whether a local update draws minibatch permutations."""
    return cfg.fleet and (cfg.ppo_epochs > 1 or cfg.n_minibatches > 1)


def transitions_per_update(cfg: FedRLConfig) -> int:
    return cfg.B * cfg.minibatch * cfg.env.n_rl


def replay_of(cfg: FedRLConfig, source) -> ReplayDraws:
    """Every draw a run of ``cfg`` takes from ``source``, in the driver's
    order, as a :class:`ReplayDraws` (e.g. to run the same draws on the CPU
    and on the card)."""
    upe, m = cfg.updates_per_epoch, cfg.strategy.m
    init = source.init_params(OBS_DIM)
    resets, noise, perms = [], [], []
    for _ in range(cfg.n_epochs):
        resets.append(source.reset(reset_shape(cfg)).cpu())
        for _ in range(upe):
            noise.append(source.action_noise(noise_shape(cfg)).cpu())
            if shuffles(cfg):
                perms.append(source.permutations(
                    m, cfg.ppo_epochs, transitions_per_update(cfg)).cpu())
    ev = source.eval_stream()
    eval_draws = {"reset": ev.reset(reset_shape(cfg)).cpu(),
                  "noise": ev.action_noise(noise_shape(cfg)).cpu()}
    init = {h: {k: v.cpu() for k, v in init[h].items()} for h in init}
    return ReplayDraws(init, resets, noise, perms, eval_draws)


# --- one local update's experience and gradients ------------------------------------

def _rollout(cfg: FedRLConfig, env_params, params_a, env_state, noise):
    """Steps the shared envs, one a run (state leaves ``(S, N)``, or ``(N,)``
    for one env); RL vehicle i of run s acts via agent row ``s * m + i``.
    ``noise`` is ``(P, S * m, act)``. Returns ``(env_state, traj)`` with
    traj leaves shaped ``(S * m, P, ...)``."""
    steps = {"obs": [], "act": [], "logp_old": [], "val": [], "rew": []}
    lead, m = tuple(env_state.x.shape[:-1]), cfg.env.n_rl
    for t in range(noise.shape[0]):
        obs = get_obs(cfg.env, env_state, env_params).reshape(-1, 1, OBS_DIM)
        acts, logps = sample_action(params_a, obs, noise[t][:, None, :])
        vals = policy_value(params_a, obs)
        env_state, reward, _ = env_step(cfg.env, env_state,
                                        acts[:, 0, 0].reshape(lead + (m,)),
                                        env_params)
        for k, v in (("obs", obs[:, 0]), ("act", acts[:, 0]),
                     ("logp_old", logps[:, 0]), ("val", vals[:, 0]),
                     ("rew", reward[..., None].expand(lead + (m,))
                      .reshape(-1))):
            steps[k].append(v)
    return env_state, {k: torch.stack(v, dim=1) for k, v in steps.items()}


def _agent_grads(cfg: FedRLConfig, flat32, spec, env_params, traj, env_state):
    """Per-agent gradient of the PPO/TRPO/TAC loss on its own P
    transitions: ``(grads (S * m, n), losses (S * m,))``."""
    with torch.no_grad():
        last_obs = get_obs(cfg.env, env_state, env_params).reshape(
            -1, 1, OBS_DIM)
        last_val = policy_value(spec.unravel(flat32), last_obs)[:, 0]
        adv, ret = gae(traj["rew"], traj["val"], last_val, gamma=cfg.gamma,
                       lam=cfg.lam)
    return stacked_grad(LOSSES[cfg.algo], flat32, spec,
                        dict(traj, adv=adv, ret=ret))


def _fleet_grads(cfg: FedRLConfig, flat32, spec, env_params, traj, env_state,
                 perms, lr, *, epochs: int, n_minibatches: int):
    """Per-agent pseudo-gradients from the (A, B, P, ...) fleet trajectories
    of A = S * m agents: GAE per (env, vehicle) stream, the streams
    flattened to one B*P*n_rl batch per agent, then the PPO minibatch-epoch
    loop at ``lr`` (a number, or one per agent row)."""
    with torch.no_grad():
        last_val = fleet_last_values(cfg.env, env_params, spec.unravel(flat32),
                                     env_state)
        adv, ret = fleet_gae(traj["rew"], traj["val"], last_val,
                             gamma=cfg.gamma, lam=cfg.lam)
    data = fleet_flatten({
        "obs": traj["obs"], "act": traj["act"],
        "logp_old": traj["logp_old"], "adv": adv, "ret": ret,
    })
    return minibatch_epoch_grad(
        LOSSES[cfg.algo], flat32, spec, data, perms,
        epochs=epochs, n_minibatches=n_minibatches, lr=lr,
    )


def _collect(cfg: FedRLConfig, env_params, flat32, spec, env_state, draws,
             lr, *, epochs: int, n_minibatches: int):
    """One local update's experience + per-agent gradients of the S runs'
    A = S * m agents. Returns ``(env_state, grads (A, n), losses (A,),
    nas (S,))``."""
    S = draws.runs
    with record_function("fedrl.rollout"), torch.no_grad():
        noise = draws.action_noise(noise_shape(cfg))
        params_a = spec.unravel(flat32)
        if cfg.fleet:
            env_state, traj = fleet_rollout(cfg.env, env_params, params_a,
                                            env_state, noise)
        else:
            env_state, traj = _rollout(cfg, env_params, params_a, env_state,
                                       noise)
    with record_function("fedrl.gradient"):
        if cfg.fleet:
            perms = None
            if epochs > 1 or n_minibatches > 1:
                perms = draws.permutations(cfg.strategy.m, epochs,
                                           transitions_per_update(cfg))
            grads, losses = _fleet_grads(cfg, flat32, spec, env_params, traj,
                                         env_state, perms, lr, epochs=epochs,
                                         n_minibatches=n_minibatches)
        else:
            grads, losses = _agent_grads(cfg, flat32, spec, env_params, traj,
                                         env_state)
    return env_state, grads, losses, _run_means(traj["rew"].reshape(S, -1))


def _run_means(x: torch.Tensor) -> torch.Tensor:
    """``(S,)``: the mean of each run's row of ``x (S, k)``, each taken as a
    reduction of its own fresh copy, so a run's value does not depend on S:
    a reduction over one axis of a batch need not add in the order of a
    reduction of one row, and torch's CUDA reduction groups a row's elements
    by the row's address alignment."""
    return torch.stack([x[s].clone().mean() for s in range(x.shape[0])])


def _reset(cfg: FedRLConfig, env_params, draws):
    u = draws.reset(reset_shape(cfg))
    if cfg.fleet:
        return fleet_reset(cfg.env, env_params, u)
    return env_reset(cfg.env, u, env_params)


def _eval_grad_norm(cfg: FedRLConfig, rows32: torch.Tensor, spec, env_params,
                    draws, lr) -> torch.Tensor:
    """Expected gradient norm ||grad F(theta_bar)||^2 of each run's server
    row ``rows32 (S, n)`` on the fixed evaluation stream (the Table II
    metric): ``(S,)``. On the fleet path the metric is the plain gradient
    over each agent's batch (no PPO epochs)."""
    S, n = rows32.shape
    m = cfg.strategy.m
    flat32 = rows32[:, None, :].expand(S, m, n).reshape(S * m, n)
    env_state = _reset(cfg, env_params, draws)
    _, grads, _, _ = _collect(cfg, env_params, flat32, spec, env_state, draws,
                              lr, epochs=1, n_minibatches=1)
    g = grads.reshape(S, m, n)
    out = []
    for s in range(S):                # each run on its own copy (_run_means)
        g_mean = g[s].clone().mean(0)
        total = torch.zeros((), dtype=torch.float32, device=rows32.device)
        for o, sz in zip(spec.offsets, spec.sizes):  # JAX's tree_dot: per leaf
            leaf = g_mean[o:o + sz]
            total = total + torch.sum(leaf * leaf)
        norm = torch.sqrt(total)
        out.append(norm * norm)
    return torch.stack(out)


# --- accounting ---------------------------------------------------------------------

def policy_payload_elems() -> int:
    """Parameter count of one policy: the per-event payload in elements."""
    o, h, a = OBS_DIM, HIDDEN, ACT_DIM
    pi = o * h + h + h * h + h + h * a + a + a          # ... + log_std
    vf = o * h + h + h * h + h + h + 1
    return pi + vf


def _finish_ledger(strat, n_updates: int,
                   payload_elems: Optional[int] = None) -> CostLedger:
    """Bill full periods plus any trailing partial one."""
    full, rem = divmod(n_updates, strat.tau)
    ledger = CostLedger()
    ledger.add_periods(strat, full, payload_elems)
    ledger.add_partial_period(strat, rem, payload_elems)
    return ledger


def fedrl_ledger(cfg: FedRLConfig) -> CostLedger:
    """The run's communication-cost ledger (host-side, config-only)."""
    return _finish_ledger(cfg.strategy, cfg.n_epochs * cfg.updates_per_epoch,
                          policy_payload_elems())


def fedrl_bytes_curve(cfg: FedRLConfig) -> np.ndarray:
    """Cumulative wire bytes after each epoch — the figures' bytes x-axis."""
    upd = cfg.updates_per_epoch
    n = policy_payload_elems()
    return np.asarray(
        [_finish_ledger(cfg.strategy, (e + 1) * upd, n).total_bytes()
         for e in range(cfg.n_epochs)],
        np.float64,
    )


# --- the driver ---------------------------------------------------------------------

def _server_params(spec, row32: torch.Tensor) -> GaussianMLPPolicy:
    tree = spec.unravel_one(row32.detach().clone())
    return GaussianMLPPolicy(tree["pi"], tree["vf"])


class _RunDraws:
    """The S runs' draw sources as one: each draw is every run's own draw of
    the one-run shape, in the run's own order, stacked on the agent axis
    (runs outer), so run s's agents see exactly the draws a one-run
    ``run_fedrl`` on that source sees."""

    def __init__(self, sources: Sequence, fleet: bool):
        self.sources, self.fleet = list(sources), fleet
        self.runs = len(self.sources)

    def reset(self, shape) -> torch.Tensor:
        u = torch.stack([d.reset(shape) for d in self.sources])
        return u.reshape((-1,) + tuple(shape[1:])) if self.fleet else u

    def action_noise(self, shape) -> torch.Tensor:
        z = torch.stack([d.action_noise(shape) for d in self.sources], dim=1)
        return z.reshape((shape[0], -1) + tuple(shape[2:]))

    def permutations(self, m: int, epochs: int, d: int) -> torch.Tensor:
        return torch.cat([s.permutations(m, epochs, d) for s in self.sources])

    def eval_stream(self) -> "_RunDraws":
        return _RunDraws([d.eval_stream() for d in self.sources], self.fleet)


def _structure(cfg: FedRLConfig) -> tuple:
    """Every field of a config but those a run may set on its own (the
    learning rate, the strategy's values, the fleet's parameters)."""
    return tuple(getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                 if f.name not in ("eta", "strategy", "env_params")) + (
        cfg.env_params is None,)


def _draw_source(d, cfg: FedRLConfig, dev):
    if isinstance(d, (int, np.integer)):
        return TorchDraws(int(d), dev, cfg.eval_seed)
    if isinstance(d, ReplayDraws):
        return d.to(dev)
    return d


def run_fedrl_batch(cfgs: Sequence[FedRLConfig], draws: Sequence, *,
                    device: Union[str, torch.device] = "cuda",
                    ) -> Tuple[torch.Tensor, dict, object]:
    """Run S federated trainings as one batched run.

    ``cfgs`` are the S runs' configs, alike in everything but their values
    (``eta``, the strategy's tables, ``env_params``; ``stack_runs`` checks
    the strategies); ``draws`` their S draw sources (a seed makes a
    :class:`TorchDraws` on ``device``, a :class:`ReplayDraws` is replayed
    there). Returns ``(rows, metrics, spec)``: the ``(S, n)`` fp32 server
    rows on ``device``, per-epoch numpy ``nas``, ``loss`` and
    ``server_grad_sq_norm`` shaped ``(S, n_epochs)``, and the flat layout.
    Runs on the card unless ``device="cpu"``.
    """
    cfgs, draws = list(cfgs), list(draws)
    if not cfgs or len(cfgs) != len(draws):
        raise ValueError(f"run_fedrl_batch: {len(cfgs)} configs and "
                         f"{len(draws)} draw sources; need one each, >= 1")
    cfg = cfgs[0]
    for i, c in enumerate(cfgs):
        if _structure(c) != _structure(cfg):
            raise ValueError(f"run_fedrl_batch: config {i} differs from "
                             f"config 0 in more than eta, the strategy's "
                             f"values and env_params")
    dev = dispatch.resolve_device(device)
    S = len(cfgs)
    src = _RunDraws([_draw_source(d, c, dev) for d, c in zip(draws, cfgs)],
                    cfg.fleet)
    strat, opt = stack_runs([c.strategy for c in cfgs]), cfg.optimizer
    m, tau = strat.m, strat.tau
    dtype = storage_dtype(cfg)
    etas = [float(np.float32(c.eta)) for c in cfgs]
    if len(set(etas)) == 1:
        eta, lr_rows = cfg.eta, cfg.eta
    else:
        eta = torch.tensor(etas, dtype=torch.float32, device=dev)
        lr_rows = eta.repeat_interleave(m)

    inits = [d.init_params(OBS_DIM) for d in src.sources]
    tree = {h: {k: torch.stack([t[h][k] for t in inits])[:, None].expand(
        (S, m) + tuple(inits[0][h][k].shape)).reshape(
        (S * m,) + tuple(inits[0][h][k].shape)) for k in inits[0][h]}
        for h in inits[0]}
    flat, spec = dispatch.stacked_ravel_spec(tree)
    flat = flat.reshape(S, m, spec.n)
    if dtype is not None:
        flat = flat.to(dtype)
    opt_state = opt.init(flat) if opt is not None else {}
    comm_state = strat.init_comm_state(flat)
    # the dynamics on the device once: (S * m,)-stacked rows on the fleet,
    # the shared env's 0-d defaults otherwise
    if cfg.env_params is not None:
        env_params = EnvParams(*(torch.cat([l.to(dev) for l in leaves])
                                 for leaves in zip(*(c.env_params
                                                     for c in cfgs))))
    elif cfg.fleet:
        env_params = broadcast_params(cfg.env.default_params(dev), (S * m,))
    else:
        env_params = cfg.env.default_params(dev)

    metrics = {"nas": [], "loss": [], "server_grad_sq_norm": []}
    k = 0
    for _ in range(cfg.n_epochs):
        env_state = _reset(cfg, env_params, src)
        nas, loss = [], []
        for _ in range(cfg.updates_per_epoch):
            flat32 = dispatch.compute_view(flat, dtype).reshape(S * m, spec.n)
            env_state, g, losses, r = _collect(
                cfg, env_params, flat32, spec, env_state, src, lr_rows,
                epochs=cfg.ppo_epochs, n_minibatches=cfg.n_minibatches)
            with record_function("fedrl.local_step"):
                g = g.reshape(S, m, spec.n)
                if dtype is not None:
                    g = g.to(dtype)
                flat, opt_state, comm_state = strat.flat_local_step(
                    flat, g, k % tau, eta, opt, opt_state, comm_state)
            k += 1
            if k % tau == 0:
                with record_function("fedrl.sync"):
                    flat, comm_state = strat.flat_sync(
                        flat, comm_state, period=k // tau - 1)
                    server_average_state(strat, opt_state)
            nas.append(r)
            loss.append(_run_means(losses.reshape(S, m)))
        # epoch evals land mid-period too: the metric polls every replica
        with record_function("fedrl.eval"):
            rows32 = dispatch.compute_view(strat.flat_server_average(flat),
                                           dtype)
            grad_sq = _eval_grad_norm(cfg, rows32, spec, env_params,
                                      src.eval_stream(), lr_rows)
        metrics["nas"].append(_run_means(torch.stack(nas, dim=1)))
        metrics["loss"].append(_run_means(torch.stack(loss, dim=1)))
        metrics["server_grad_sq_norm"].append(grad_sq)
    rows32 = dispatch.compute_view(strat.flat_server_average(flat), dtype)
    out = {k_: torch.stack(v, dim=1).cpu().numpy().astype(np.float32)
           for k_, v in metrics.items()}
    return rows32, out, spec


def run_fedrl(cfg: FedRLConfig,
              draws: Union[int, TorchDraws, ReplayDraws] = 0, *,
              device: Union[str, torch.device] = "cuda",
              ) -> Tuple[GaussianMLPPolicy, dict, CostLedger]:
    """Run federated PPO; returns ``(server_params, metrics, ledger)``.

    ``draws`` is a seed (a :class:`TorchDraws` on ``device``) or a draw
    source. ``server_params`` is the final server row as a
    :class:`GaussianMLPPolicy`; ``metrics`` holds per-epoch numpy ``nas``,
    ``loss`` and ``server_grad_sq_norm``, as the JAX package returns them.
    Runs on the card unless ``device="cpu"``: :func:`run_fedrl_batch` with
    one run.
    """
    rows32, metrics, spec = run_fedrl_batch([cfg], [draws], device=device)
    return (_server_params(spec, rows32[0]),
            {k: v[0] for k, v in metrics.items()}, fedrl_ledger(cfg))


def expected_gradient_norm(metrics) -> float:
    """Table II metric: average ||grad F||^2 over the training run."""
    return float(np.mean(metrics["server_grad_sq_norm"]))
