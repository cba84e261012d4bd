"""Gaussian MLP actor-critic, the counterpart of ``repro.rl.policy``.

The parameters keep the JAX package's names and layout: ``pi`` and ``vf``
each hold ``w1, b1, w2, b2, w3, b3`` (plus ``log_std`` in ``pi``), every
weight is ``(in, out)`` and a layer is ``x @ w + b``. They are not transposed
into ``nn.Linear``'s ``(out, in)``, so checkpoints and flat parameter rows
map one to one between the two packages.

Every function also takes *stacked* parameters: leaves with a leading agent
axis m (weights ``(m, in, out)``, biases ``(m, out)``, as the training loop's
per-agent views of its flat ``(m, n)`` carry give them) together with
observations ``(m, K, in)``. Each agent's rows then go through its own
weights in one batched product, as the JAX package's ``vmap`` over agents
does. Sampling takes its standard-normal noise as an operand.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.dispatch import resolve_device

_HEADS = ("pi", "vf")


class GaussianMLPPolicy(nn.Module):
    """The policy (``pi``) and value (``vf``) MLPs as ``nn.ParameterDict``s.

    Also reads as the JAX parameter tree: ``params["pi"]["w1"]``,
    ``"pi" in params`` and iteration over the head names work as they do on
    the nested dict ``repro.rl.policy.init_policy`` returns.
    """

    def __init__(self, pi: Mapping[str, torch.Tensor],
                 vf: Optional[Mapping[str, torch.Tensor]] = None):
        super().__init__()
        self.pi = nn.ParameterDict({k: nn.Parameter(v) for k, v in pi.items()})
        self.vf = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in (vf or {}).items()}
        )

    def __getitem__(self, head: str) -> nn.ParameterDict:
        if head not in self:
            raise KeyError(head)
        return getattr(self, head)

    def __contains__(self, head: object) -> bool:
        return head == "pi" or (head == "vf" and len(self.vf) > 0)

    def __iter__(self) -> Iterator[str]:
        return (h for h in _HEADS if h in self)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return policy_apply(self, obs)


def _orthogonal(shape, generator: torch.Generator) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return nn.init.orthogonal_(w, generator=generator)


def init_policy(obs_dim: int, hidden: int = 64, act_dim: int = 1, *,
                generator: torch.Generator,
                device: Union[str, torch.device] = "cuda") -> GaussianMLPPolicy:
    """Orthogonal init from ``generator``: ``pi.w3`` scaled by 0.01,
    ``log_std = -0.5``, zero biases — the recipe of
    ``repro.rl.policy.init_policy``. The values differ from JAX's (another
    generator); tests carry JAX's values across with :func:`params_from_jax`.
    """
    dev = resolve_device(device)
    g = lambda *shape: _orthogonal(shape, generator).to(dev)
    z = lambda n: torch.zeros(n, dtype=torch.float32, device=dev)
    pi = {
        "w1": g(obs_dim, hidden), "b1": z(hidden),
        "w2": g(hidden, hidden), "b2": z(hidden),
        "w3": 0.01 * g(hidden, act_dim), "b3": z(act_dim),
        "log_std": torch.full((act_dim,), -0.5, dtype=torch.float32, device=dev),
    }
    vf = {
        "w1": g(obs_dim, hidden), "b1": z(hidden),
        "w2": g(hidden, hidden), "b2": z(hidden),
        "w3": g(hidden, 1), "b3": z(1),
    }
    return GaussianMLPPolicy(pi, vf)


def _rows(b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A bias (or log_std) broadcast against the rows of one agent: stacked
    ``(m, out)`` becomes ``(m, 1, out)``."""
    return b.unsqueeze(-2) if w.ndim == 3 else b


def _mlp(p, x: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(x @ p["w1"] + _rows(p["b1"], p["w1"]))
    h = torch.tanh(h @ p["w2"] + _rows(p["b2"], p["w2"]))
    return h @ p["w3"] + _rows(p["b3"], p["w3"])


def policy_apply(params, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(mean, log_std)`` of the Gaussian policy (``log_std`` as
    ``(m, 1, act)`` for stacked parameters, so it broadcasts against the
    mean)."""
    pi = params["pi"]
    return torch.tanh(_mlp(pi, obs)), _rows(pi["log_std"], pi["w3"])


def policy_value(params, obs: torch.Tensor) -> torch.Tensor:
    """The value head's estimate, with the trailing unit axis dropped."""
    return _mlp(params["vf"], obs)[..., 0]


# log(2 pi) and log(2 pi e) in fp32, as the JAX package evaluates them (the
# constant rounded to fp32 first, then its fp32 log)
_LOG_2PI = torch.log(torch.tensor(2.0 * math.pi, dtype=torch.float32)).item()
_LOG_2PIE = torch.log(torch.tensor(2.0 * math.pi * math.e,
                                   dtype=torch.float32)).item()


def gaussian_logp(act, mean, log_std) -> torch.Tensor:
    var = torch.exp(2.0 * log_std)
    return torch.sum(
        -0.5 * ((act - mean) ** 2 / var + 2.0 * log_std + _LOG_2PI), dim=-1)


def sample_action(params, obs: torch.Tensor, noise: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mean + exp(log_std) * noise`` and its log density; ``noise`` is the
    standard-normal draw, shaped like the mean."""
    mean, log_std = policy_apply(params, obs)
    act = mean + torch.exp(log_std) * noise
    return act, gaussian_logp(act, mean, log_std)


def gaussian_entropy(log_std) -> torch.Tensor:
    """Entropy of the diagonal Gaussian: the sum over the last axis (one value
    per agent for stacked ``(m, 1, act)``)."""
    return torch.sum(log_std + 0.5 * _LOG_2PIE, dim=-1)


def tsallis2_entropy(log_std) -> torch.Tensor:
    """Tsallis entropy with index q=2 of a diagonal Gaussian:
    S_2 = 1 - prod_i 1/(2 sqrt(pi) sigma_i), over the last axis."""
    sigma = torch.exp(log_std)
    return 1.0 - torch.prod(1.0 / (2.0 * _SQRT_PI * sigma), dim=-1)


_SQRT_PI = torch.sqrt(torch.tensor(math.pi, dtype=torch.float32)).item()


def params_from_jax(tree, device: Union[str, torch.device] = "cuda"
                    ) -> GaussianMLPPolicy:
    """The port's parameters from a JAX ``init_policy`` tree given as numpy
    arrays (``jax.tree.map(np.asarray, params)``); values are copied."""
    dev = resolve_device(device)
    if "pi" not in tree:
        raise ValueError(f"params_from_jax: tree needs a 'pi' head, got "
                         f"{sorted(tree)}")
    conv = lambda head: {
        k: torch.tensor(np.array(v), device=dev) for k, v in head.items()
    }
    return GaussianMLPPolicy(conv(tree["pi"]), conv(tree.get("vf", {})))


def params_to_numpy(params) -> Dict[str, Dict[str, np.ndarray]]:
    """``{"pi": {...}, "vf": {...}}`` of numpy arrays, the JAX tree's layout,
    from a :class:`GaussianMLPPolicy` or a nested mapping of tensors/arrays."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return np.asarray(v)

    return {h: {k: leaf(v) for k, v in params[h].items()}
            for h in _HEADS if h in params}
