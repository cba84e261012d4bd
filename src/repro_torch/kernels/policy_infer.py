"""Fused serving inference: obs-normalize -> policy MLP -> mean or sample.

The port of the Pallas TPU kernel ``policy_infer_pallas``
(``src/repro/kernels/policy_infer.py:61``). Three pieces live here:

* :func:`policy_infer_cuda` — the wrapper of the hand-written Hopper kernel in
  ``csrc/policy_infer.cu``. It takes CUDA tensors only, launches on the
  current stream without synchronising, and counts its launches in
  :data:`launches`.
* :func:`policy_infer_plain` — the same function in plain PyTorch ops. The
  CPU path runs it; on the card it is only the reference the kernel is held
  against.
* the limits the kernel takes (:data:`MAX_HIDDEN`, :data:`MAX_OBS_DIM`,
  :data:`MAX_ACT_DIM`), mirrored from the CUDA source.

Callers go through :func:`repro_torch.kernels.dispatch.policy_infer`, which
picks one of the two by the tensors' device.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from repro_torch.kernels import _build

PI_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3", "log_std")

# Mirrors kMaxHidden / kMaxObsDim / kMaxActDim in csrc/policy_infer.cu:
# hidden <= 128 keeps w2 in shared memory, act_dim <= 32 gives one lane per
# action column.
MAX_HIDDEN = 128
MAX_OBS_DIM = 128
MAX_ACT_DIM = 32

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0          # kernel launches made by policy_infer_cuda


def policy_infer_plain(obs: torch.Tensor, pi: Mapping[str, torch.Tensor],
                       norm_mean: torch.Tensor, norm_std: torch.Tensor,
                       noise: torch.Tensor, *, sample: bool = False,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: fp32 throughout, cast to ``obs.dtype``.

    Op for op the JAX package's jnp path (``dispatch.policy_infer`` on eager
    ``policy_apply``). With ``out`` given the result is copied into it and
    ``out`` is returned.
    """
    x = (obs.float() - norm_mean) / norm_std
    h = torch.tanh(x @ pi["w1"] + pi["b1"])
    h = torch.tanh(h @ pi["w2"] + pi["b2"])
    act = torch.tanh(h @ pi["w3"] + pi["b3"])
    if sample:
        act = act + torch.exp(pi["log_std"]) * noise.float()
    act = act.to(obs.dtype)
    if out is None:
        return act
    return out.copy_(act)


def _check(name: str, t: torch.Tensor, shape, dtypes, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"policy_infer_cuda: {name} must be a tensor, got "
                        f"{type(t).__name__}")
    if t.device != device:
        raise ValueError(f"policy_infer_cuda: {name} is on {t.device}, "
                         f"obs is on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"policy_infer_cuda: {name} must be one of "
                        f"{[str(d) for d in dtypes]}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"policy_infer_cuda: {name} must be {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"policy_infer_cuda: {name} must be contiguous")


def policy_infer_cuda(obs: torch.Tensor, pi: Mapping[str, torch.Tensor],
                      norm_mean: torch.Tensor, norm_std: torch.Tensor,
                      noise: torch.Tensor, *, sample: bool = False,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the Hopper kernel of ``csrc/policy_infer.cu``.

    ``obs`` ``(B, obs_dim)`` and ``noise`` ``(B, act_dim)`` are fp32 or bf16;
    the weights, biases, ``log_std`` and the norm stats are fp32; everything
    is contiguous and on one CUDA device. The actions are written to ``out``
    (``(B, act_dim)`` in ``obs.dtype``), which may be ``noise`` itself: the
    kernel reads each noise element before writing the action to the same
    element. Without ``out`` the wrapper allocates the result. Any fp32 view
    is taken (the kernel stages a tensor's misaligned head and tail with
    4-byte copies, its body with 16-byte ones).

    No single PyTorch call computes this fused function, so the kernel has no
    library yardstick; its reference is :func:`policy_infer_plain`.
    """
    global launches
    device = obs.device
    if device.type != "cuda":
        raise ValueError(f"policy_infer_cuda: tensors must be on a CUDA "
                         f"device, got {device}")
    if obs.ndim != 2:
        raise ValueError(f"policy_infer_cuda: obs must be (B, obs_dim), got "
                         f"{tuple(obs.shape)}")
    B, obs_dim = obs.shape
    hidden = pi["w1"].shape[-1]
    act_dim = pi["w3"].shape[-1]
    if not (1 <= hidden <= MAX_HIDDEN and 1 <= obs_dim <= MAX_OBS_DIM
            and 1 <= act_dim <= MAX_ACT_DIM):
        raise ValueError(
            f"policy_infer_cuda: the kernel takes obs_dim <= {MAX_OBS_DIM}, "
            f"hidden <= {MAX_HIDDEN} and act_dim <= {MAX_ACT_DIM}; got "
            f"obs_dim={obs_dim}, hidden={hidden}, act_dim={act_dim}"
        )
    io = tuple(_DTYPE_CODE)
    f32 = (torch.float32,)
    _check("obs", obs, (B, obs_dim), io, device)
    _check("noise", noise, (B, act_dim), io, device)
    for name, shape in (("w1", (obs_dim, hidden)), ("b1", (hidden,)),
                        ("w2", (hidden, hidden)), ("b2", (hidden,)),
                        ("w3", (hidden, act_dim)), ("b3", (act_dim,)),
                        ("log_std", (act_dim,))):
        _check(name, pi[name], shape, f32, device)
    _check("norm_mean", norm_mean, (obs_dim,), f32, device)
    _check("norm_std", norm_std, (obs_dim,), f32, device)
    if out is None:
        out = torch.empty((B, act_dim), dtype=obs.dtype, device=device)
    else:
        _check("out", out, (B, act_dim), (obs.dtype,), device)
        if out.data_ptr() == noise.data_ptr() and out.dtype != noise.dtype:
            raise ValueError("policy_infer_cuda: out aliases noise with "
                             "another dtype")
    if B == 0:
        return out
    lib = _build.load()
    err = lib.repro_policy_infer(
        obs.data_ptr(), noise.data_ptr(), out.data_ptr(),
        norm_mean.data_ptr(), norm_std.data_ptr(),
        *(pi[k].data_ptr() for k in PI_KEYS),
        B, obs_dim, hidden, act_dim, int(bool(sample)),
        _DTYPE_CODE[obs.dtype], _DTYPE_CODE[noise.dtype],
        device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"policy_infer_cuda: launch failed with CUDA error {err}: "
            f"{lib.repro_cuda_error_string(err).decode()}"
        )
    launches += 1
    return out
