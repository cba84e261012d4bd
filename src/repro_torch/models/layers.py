"""Primitive layers of the language models (``repro.models.layers``).

Parameters are nested dicts of tensors in the JAX package's layout
(weights ``(in, out)``), made by :func:`mk` from a seeded
``torch.Generator`` on the target device. The JAX package's logical sharding
axes have no counterpart here. Only the parts the ported models read are
here: norms and (un)embedding; rotary and sinusoidal positions and the
dense MLP come with the slices of the models that use them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name (``param_dtype``, ``compute_dtype``)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def mk(gen: Optional[torch.Generator], shape: Sequence[int], std: float = 0.02,
       zeros: bool = False, ones: bool = False) -> torch.Tensor:
    """One fp32 parameter: ``std * N(0, 1)`` drawn from ``gen`` on ``gen``'s
    device, or zeros / ones. ``gen=None`` makes a shape-only ``meta``
    tensor (see ``transformer.param_shapes``)."""
    if gen is None:
        return torch.empty(tuple(shape), device="meta")
    device = gen.device
    if ones:
        return torch.ones(tuple(shape), device=device)
    if zeros:
        return torch.zeros(tuple(shape), device=device)
    return std * torch.randn(tuple(shape), generator=gen, device=device)


# ----------------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Layer norm computed in fp32 and cast back to ``x.dtype``, as the JAX
    package's (``layers.py:69-83``)."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def init_norm(gen, d: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": mk(gen, (d,), zeros=True)}
    return {"scale": mk(gen, (d,), ones=True), "bias": mk(gen, (d,), zeros=True)}


def apply_norm(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


# ----------------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------------

def init_embedding(gen, vocab: int, d: int) -> dict:
    return {"table": mk(gen, (vocab, d), std=0.02)}


def embed(p: dict, tokens: torch.Tensor, scale: Optional[float] = None
          ) -> torch.Tensor:
    out = p["table"][tokens]
    if scale is not None:
        out = out * scale
    return out


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["table"].T
