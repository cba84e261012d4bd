"""Device dispatch for the port's primitives.

The counterpart of ``repro.kernels.dispatch``. Where the JAX package picks a
backend (``jnp`` / ``interpret`` / ``pallas``, with ``auto`` resolving by
platform), the port picks by the device the tensors lie on:

* on CPU tensors a primitive runs its plain PyTorch version;
* on CUDA tensors it launches its hand-written kernel, or raises. A kernel
  error is never caught and retried on the plain path.

Entry points take ``device=`` and run on the card unless the caller asks for
the CPU; :func:`resolve_device` raises when the card is asked for and there
is none. There is no ``auto`` that drops to the CPU.
"""
from __future__ import annotations

from typing import Mapping, Optional, Union

import torch

from repro_torch.kernels.policy_infer import (
    PI_KEYS,
    policy_infer_cuda,
    policy_infer_plain,
)


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; ``cuda`` requires a card.

    Raises ``RuntimeError`` when a CUDA device is asked for and
    ``torch.cuda.is_available()`` is false, and ``ValueError`` for a device
    type the port does not run on.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"repro_torch: device {str(device)!r} asked for, but CUDA is "
                f"not available; pass device='cpu' to run the plain PyTorch "
                f"path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch: unsupported device {str(device)!r}; "
                         f"expected 'cuda' or 'cpu'")
    return dev


def policy_infer(obs: torch.Tensor, pi: Mapping[str, torch.Tensor],
                 norm_mean, norm_std, noise: torch.Tensor, *,
                 sample: bool = False,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused serving inference: obs-normalize -> policy MLP -> mean/sample.

    ``obs`` is a ``(B, obs_dim)`` observation batch, ``pi`` the Gaussian
    policy head (``w1, b1, w2, b2, w3, b3, log_std``, weights ``(in, out)``),
    ``norm_mean``/``norm_std`` the ``(obs_dim,)`` normalization stats (cast
    to fp32, as the JAX dispatch does) and ``noise`` a ``(B, act_dim)``
    standard-normal operand. Returns the ``(B, act_dim)`` actions in
    ``obs.dtype``: the tanh policy mean, or ``mean + exp(log_std) * noise``
    with ``sample=True``. ``out`` (may be ``noise``) receives the actions.

    Raises the validation errors of ``repro.kernels.dispatch.policy_infer``.
    """
    if obs.ndim != 2:
        raise ValueError(f"policy_infer: obs must be (B, obs_dim), got "
                         f"{tuple(obs.shape)}")
    for name in PI_KEYS:
        if name not in pi:
            raise ValueError(f"policy_infer: pi needs {name!r} (got {sorted(pi)})")
    B, obs_dim = obs.shape
    act_dim = pi["w3"].shape[1]
    if pi["w1"].shape[0] != obs_dim:
        raise ValueError(
            f"policy_infer: w1 expects obs_dim {pi['w1'].shape[0]}, "
            f"obs has {obs_dim}"
        )
    if tuple(noise.shape) != (B, act_dim):
        raise ValueError(
            f"policy_infer: noise must be ({B}, {act_dim}), got "
            f"{tuple(noise.shape)}"
        )
    nm = torch.as_tensor(norm_mean, dtype=torch.float32, device=obs.device)
    ns = torch.as_tensor(norm_std, dtype=torch.float32, device=obs.device)
    if tuple(nm.shape) != (obs_dim,) or tuple(ns.shape) != (obs_dim,):
        raise ValueError(
            f"policy_infer: norm stats must be ({obs_dim},), got "
            f"{tuple(nm.shape)} / {tuple(ns.shape)}"
        )
    if obs.device.type == "cpu":
        return policy_infer_plain(obs, pi, nm, ns, noise, sample=sample, out=out)
    if obs.device.type == "cuda":
        return policy_infer_cuda(obs, pi, nm, ns, noise, sample=sample, out=out)
    raise ValueError(f"policy_infer: unsupported device {obs.device}")
