"""Policy and environment pieces of the port (``repro.rl``)."""
from repro_torch.rl.env import OBS_DIM
from repro_torch.rl.policy import (
    GaussianMLPPolicy,
    init_policy,
    params_from_jax,
    params_to_numpy,
    policy_apply,
)

__all__ = [
    "GaussianMLPPolicy",
    "OBS_DIM",
    "init_policy",
    "params_from_jax",
    "params_to_numpy",
    "policy_apply",
]
