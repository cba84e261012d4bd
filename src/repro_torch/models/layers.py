"""Primitive layers of the language models (``repro.models.layers``).

Parameters are nested dicts of tensors in the JAX package's layout
(weights ``(in, out)``), made by :func:`mk` from a seeded
``torch.Generator`` on the target device. The JAX package's logical sharding
axes have no counterpart here. Only the parts the ported models read are
here: norms, (un)embedding, rotary and sinusoidal positions (the latter
for whisper-small's two stacks) and the dense MLP.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


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
# Rotary embeddings
# ----------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """``1 / theta ** (arange(half) / half)`` in fp32, as the JAX package
    computes it (``layers.py:104-106``)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Split-half rotary embedding (``x1, x2 = split(x, 2)``, not
    interleaved). x: ``(..., S, H, hd)`` or ``(..., S, hd)``; positions:
    broadcastable to ``(..., S)``. Angles, cos/sin and the rotation are fp32;
    the result is cast back to ``x.dtype``."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions.to(torch.float32)[..., None] * freqs
    if x.ndim == angles.ndim + 1:                     # head axis present
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Sinusoidal positions
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sinusoid_denominators(d: int, device: torch.device) -> torch.Tensor:
    """``10000 ** (2 i / d)`` for i < d / 2 on ``device`` (made once per
    width and device), each the C library's fp32 ``powf`` of the fp32
    exponent: the function XLA's CPU backend calls for the JAX package's
    ``jnp.power``, so both tables divide by the same fp32 numbers.
    (``torch.pow`` differs from it in the last bit at 4 of the 384 at
    d = 768, which moves ``sin(447 / den)`` by up to 1.5e-5.)"""
    powf = ctypes.CDLL(ctypes.util.find_library("m")).powf
    powf.restype = ctypes.c_float
    powf.argtypes = (ctypes.c_float, ctypes.c_float)
    exps = 2.0 * torch.arange(d // 2, dtype=torch.float32) / d
    return torch.tensor([powf(10000.0, float(e)) for e in exps],
                        dtype=torch.float32, device=device)


def sinusoidal_for_positions(pos: torch.Tensor, d: int) -> torch.Tensor:
    """``(..., d)`` fp32 embeddings of the integer positions ``pos``:
    ``[sin(pos / den), cos(pos / den)]`` with ``den = 10000 ** (2 i / d)``,
    i < d / 2, in fp32 on ``pos``'s device, as the JAX package computes them
    (``layers.py:126-131``)."""
    den = _sinusoid_denominators(d, pos.device)
    angle = pos.to(torch.float32)[..., None] / den
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def sinusoidal_positions(n_pos: int, d: int, device=None) -> torch.Tensor:
    """``(n_pos, d)``: :func:`sinusoidal_for_positions` of 0..n_pos - 1."""
    return sinusoidal_for_positions(torch.arange(n_pos, device=device), d)


# ----------------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------------

def init_mlp(gen, d: int, d_ff: int, activation: str) -> dict:
    p = {"w_down": mk(gen, (d_ff, d), std=0.02 / max(1, d_ff) ** 0.5)}
    if activation in ("swiglu", "geglu"):
        p["w_gate"] = mk(gen, (d, d_ff))
        p["w_up"] = mk(gen, (d, d_ff))
    else:
        p["w_in"] = mk(gen, (d, d_ff))
    return p


def apply_mlp(p: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    """SwiGLU, GeGLU or GELU. GELU is the tanh form, ``jax.nn.gelu``'s
    default."""
    if activation in ("swiglu", "geglu"):
        gate = x @ p["w_gate"]
        up = x @ p["w_up"]
        act = (F.silu(gate) if activation == "swiglu"
               else F.gelu(gate, approximate="tanh"))
        h = act * up
    else:
        h = F.gelu(x @ p["w_in"], approximate="tanh")
    return h @ p["w_down"]


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
