"""Reinforcement-learning pieces of the port (``repro.rl``): the ring-road
environments, the actor-critic policy, the PPO losses, the fleet rollouts,
the draw sources and the federated training driver."""
from repro_torch.rl.draws import ReplayDraws, TorchDraws
from repro_torch.rl.env import (
    FIGURE_EIGHT,
    HETERO_FIELDS,
    MERGE,
    OBS_DIM,
    EnvConfig,
    EnvParams,
    EnvState,
    broadcast_params,
    env_reset,
    env_step,
    get_obs,
    perturb_params,
    stack_params,
)
from repro_torch.rl.fedrl import (
    FedRLConfig,
    expected_gradient_norm,
    fedrl_bytes_curve,
    fedrl_ledger,
    policy_payload_elems,
    replay_of,
    run_fedrl,
)
from repro_torch.rl.policy import (
    GaussianMLPPolicy,
    gaussian_entropy,
    gaussian_logp,
    init_policy,
    params_from_jax,
    params_to_numpy,
    policy_apply,
    policy_value,
    sample_action,
    tsallis2_entropy,
)
from repro_torch.rl.ppo import (
    LOSSES,
    gae,
    minibatch_epoch_grad,
    ppo_loss,
    tac_loss,
    trpo_kl_loss,
)
from repro_torch.rl.rollout import (
    fleet_flatten,
    fleet_gae,
    fleet_last_values,
    fleet_reset,
    fleet_rollout,
)

__all__ = [
    "FIGURE_EIGHT", "HETERO_FIELDS", "LOSSES", "MERGE", "OBS_DIM",
    "EnvConfig", "EnvParams", "EnvState", "FedRLConfig", "GaussianMLPPolicy",
    "ReplayDraws", "TorchDraws",
    "broadcast_params", "env_reset", "env_step", "expected_gradient_norm",
    "fedrl_bytes_curve", "fedrl_ledger", "fleet_flatten", "fleet_gae",
    "fleet_last_values", "fleet_reset", "fleet_rollout", "gae",
    "gaussian_entropy", "gaussian_logp", "get_obs", "init_policy",
    "minibatch_epoch_grad", "params_from_jax", "params_to_numpy",
    "perturb_params", "policy_apply", "policy_payload_elems", "policy_value",
    "ppo_loss", "replay_of", "run_fedrl", "sample_action", "stack_params",
    "tac_loss",
    "trpo_kl_loss", "tsallis2_entropy",
]
