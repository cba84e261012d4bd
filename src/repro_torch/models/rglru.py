"""Griffin recurrent block of RecurrentGemma (``repro.models.rglru``;
arXiv:2402.19427): a temporal conv1d and the RG-LRU.

Block: x -> (gate branch: Linear + GeLU) * (rec branch: Linear -> causal
Conv1D (width 4) -> RG-LRU) -> Linear out, with

    r_t = sigmoid(W_a x_t + b_a)                     recurrence gate
    i_t = sigmoid(W_x x_t + b_x)                     input gate
    a_t = exp(-c * softplus(Lambda) * r_t)           c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The cast points are the JAX package's (``rglru.py:70-83``): the gates in
``x.dtype``, ``log a`` and ``i * x`` cast to fp32 for the scan, ``h`` carried
in fp32 and cast back to ``x.dtype`` before the gate product.

No Pallas kernel computes the recurrence: JAX runs it as
``jax.lax.associative_scan``. :func:`rglru_scan` is that scan in plain
PyTorch, with the same recursion (pairs combined, the half-length scan
recursed into, the even elements fixed up), so its sums are taken in JAX's
order: log2(S) levels of a few launches each, never a loop over S. Its
gradient (training) is autograd through the same recursion, as JAX's is
``jax.grad`` through ``associative_scan``.

State per stream: ``{"h": (B, W) fp32, "conv": (B, K - 1, W)}``, the last
K - 1 inputs of the conv (in the compute dtype), zeros to start.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import mk

_C = 8.0


def init_rglru_block(gen, cfg) -> dict:
    """The JAX package's leaves and shapes, drawn from ``gen`` in this
    order (``gen=None``: shapes only)."""
    d, w = cfg.d_model, cfg.lru_dim
    return {
        "w_gate": mk(gen, (d, w), std=0.02),
        "w_rec_in": mk(gen, (d, w), std=0.02),
        "conv_w": mk(gen, (cfg.conv_width, w), std=0.2),
        "conv_b": mk(gen, (w,), zeros=True),
        "wa": mk(gen, (w, w), std=0.02),
        "ba": mk(gen, (w,), zeros=True),
        "wx": mk(gen, (w, w), std=0.02),
        "bx": mk(gen, (w,), zeros=True),
        "lam": mk(gen, (w,), std=0.5),
        "w_out": mk(gen, (w, d), std=0.02 / max(cfg.n_layers, 1) ** 0.5),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   conv_state: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, W); w: (K, W); conv_state: (B, K - 1, W), the trailing
    inputs of the previous call. Returns ``(out (B, S, W), new_state)``,
    the taps added in JAX's order (k = 0 first) and the bias last."""
    k, s = w.shape[0], x.shape[1]
    xp = torch.cat([conv_state, x], dim=1)                 # (B, S + K - 1, W)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    new_state = xp[:, s:][:, -(k - 1):] if k > 1 else conv_state
    return out + b, new_state


def _combine(a1, b1, a2, b2):
    """The linear recurrence's associative combine: (a1 a2, a2 b1 + b2)."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along axis 1: even[0], odd[0], even[1], ... (len(even) is len(odd)
    or one more)."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n) + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _scan(a: torch.Tensor, b: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of (a, b) along axis 1 under :func:`_combine`, by the
    recursion of ``jax.lax.associative_scan``."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: the values of ``torch.clamp``, and JAX's gradient,
    which at a bound is half (``min`` / ``max`` split a tie), where
    ``clamp`` passes all of it."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def rglru_scan(a_log: torch.Tensor, gate_in: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t), in fp32.

    a_log (log a_t <= 0) and gate_in (i_t * x_t): (B, S, W) fp32; h0: (B,
    W) fp32. Returns ``(h (B, S, W), h[:, -1])``. The first input takes
    ``a_0 h0`` in, then the associative scan runs in ``O(log S)`` depth."""
    a = torch.exp(a_log)
    inp = torch.sqrt(_clip(1.0 - torch.exp(2.0 * a_log), 1e-12, 1.0)) \
        * gate_in
    inp = torch.cat([inp[:, :1] + a[:, :1] * h0[:, None], inp[:, 1:]], dim=1)
    _, h = _scan(a, inp)
    return h, h[:, -1]


def apply_rglru_block(p: dict, x: torch.Tensor, cfg, state: dict
                      ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d); state ``{"h": (B, W) fp32, "conv": (B, K - 1, W)}``.
    Returns ``(out (B, S, d), {"h": h_last, "conv": conv_state})``, new
    tensors (the caller writes them over its state)."""
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    rec = x @ p["w_rec_in"]
    rec, conv_state = _causal_conv1d(rec, p["conv_w"], p["conv_b"],
                                     state["conv"])
    r = torch.sigmoid(rec @ p["wa"] + p["ba"])
    i = torch.sigmoid(rec @ p["wx"] + p["bx"])
    a_log = -_C * F.softplus(p["lam"]) * r                 # log a_t <= 0
    h, h_last = rglru_scan(a_log.float(), (i * rec).float(), state["h"])
    out = (gate * h.to(x.dtype)) @ p["w_out"]
    return out, {"h": h_last, "conv": conv_state}


def init_rglru_state(cfg, batch: int, dtype=torch.float32,
                     device="cpu") -> dict:
    w = cfg.lru_dim
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                            device=device),
    }
