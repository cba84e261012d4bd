"""Gaussian MLP actor-critic, the counterpart of ``repro.rl.policy``.

The parameters keep the JAX package's names and layout: ``pi`` and ``vf``
each hold ``w1, b1, w2, b2, w3, b3`` (plus ``log_std`` in ``pi``), every
weight is ``(in, out)`` and a layer is ``x @ w + b``. They are not transposed
into ``nn.Linear``'s ``(out, in)``, so checkpoints and flat parameter rows
map one to one between the two packages.

Slice 1 (serving) ports the policy head's forward pass; sampling, the log
density, the entropies and the value head's forward belong to the training
slice.
"""
from __future__ import annotations

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


def _mlp(p, x: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(x @ p["w1"] + p["b1"])
    h = torch.tanh(h @ p["w2"] + p["b2"])
    return h @ p["w3"] + p["b3"]


def policy_apply(params, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(mean, log_std)`` of the Gaussian policy."""
    return torch.tanh(_mlp(params["pi"], obs)), params["pi"]["log_std"]


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
