"""RWKV6 'Finch' block [arXiv:2404.05892] (``repro.models.rwkv6``).

Time-mix with data-dependent token-shift interpolation (ddlerp, low-rank),
per-channel data-dependent decay w_t = exp(-exp(w0 + lora(x))), bonus u, and
the WKV state recurrence S_t = diag(w_t) S_{t-1} + k_t v_t^T per head.
Channel-mix is the RWKV squared-ReLU FFN with token shift. Both are pre-norm
sub-blocks composed by ``repro_torch.models.transformer``:
    x += time_mix(ln1(x));  x += channel_mix(ln2(x)).

The recurrence goes through :func:`repro_torch.kernels.dispatch.wkv6`: the
hand-written kernel on the card, the plain ``wkv_scan`` loop on the CPU. The
JAX package's matmul form ``wkv_chunked`` (``cfg.wkv_impl == "chunked"``) is
a TPU formulation of the same function and is not ported.

:func:`time_mix` and :func:`channel_mix` only read the state they are
given and return the new one as new tensors; the caller writes it back
(``transformer._run_layers``: over the layer's views in prefill and decode,
stacked in training, where autograd holds the initial state). Under
autograd the recurrence goes through the differentiable ``dispatch.Wkv6``
(the ``wkv6_bwd`` kernel on the card).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch
from repro_torch.models.layers import mk


def n_wkv_heads(cfg) -> int:
    return cfg.d_model // cfg.wkv_head_dim


def init_time_mix(gen, cfg) -> dict:
    d, r = cfg.d_model, cfg.decay_lora_rank
    h, hd = n_wkv_heads(cfg), cfg.wkv_head_dim
    p = {name: mk(gen, (d,), std=0.2)
         for name in ("mu_x", "mu_r", "mu_k", "mu_v", "mu_w", "mu_g")}
    p["lora_a"] = mk(gen, (d, r), std=0.01)
    p["lora_w"] = mk(gen, (r, d), std=0.01)
    p["w0"] = mk(gen, (d,), std=0.5)
    p["u"] = mk(gen, (h, hd), std=0.5)
    for name in ("wr", "wk", "wv", "wg"):
        p[name] = mk(gen, (d, d), std=0.02)
    p["wo"] = mk(gen, (d, d), std=0.02 / max(cfg.n_layers, 1) ** 0.5)
    p["gn_scale"] = mk(gen, (d,), ones=True)
    p["gn_bias"] = mk(gen, (d,), zeros=True)
    return p


def init_channel_mix(gen, cfg) -> dict:
    d = cfg.d_model
    return {
        "mu_k": mk(gen, (d,), std=0.2),
        "mu_r": mk(gen, (d,), std=0.2),
        "wk": mk(gen, (d, cfg.d_ff), std=0.02),
        "wv": mk(gen, (cfg.d_ff, d), std=0.02 / max(cfg.d_ff, 1) ** 0.5),
        "wr": mk(gen, (d, d), std=0.02),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x_{t-1} for x (B, S, d), with carry-in ``prev`` (B, d)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def time_mix(p: dict, xa: torch.Tensor, cfg, state: dict,
             wkv_impl: Optional[Callable] = None):
    """xa: normed input (B, S, d); state: ``{"shift": (B, d), "wkv": (B, H,
    hd, hd) fp32}``, only read. Returns ``(y, new_state)``, ``new_state``
    new tensors of the same layout (``shift`` a view of ``xa``).

    ``wkv_impl`` (``(r, k, v, w, u, s0) -> (y, sT)``) replaces the dispatched
    recurrence, as the JAX function's argument of that name does; the card
    run passes the plain loop there to hold the kernel's model against it.
    """
    b, s, d = xa.shape
    h, hd = n_wkv_heads(cfg), cfg.wkv_head_dim

    prev = _token_shift(xa, state["shift"])
    xx = prev - xa
    z = xa + xx * p["mu_x"]
    dd = torch.tanh(z @ p["lora_a"]) @ p["lora_w"]           # (B, S, d)

    def ddlerp(mu):
        return xa + xx * (mu + dd)

    r = (ddlerp(p["mu_r"]) @ p["wr"]).reshape(b, s, h, hd)
    k = (ddlerp(p["mu_k"]) @ p["wk"]).reshape(b, s, h, hd)
    v = (ddlerp(p["mu_v"]) @ p["wv"]).reshape(b, s, h, hd)
    g = F.silu(ddlerp(p["mu_g"]) @ p["wg"])
    w_log = -torch.exp(
        (p["w0"] + torch.tanh(ddlerp(p["mu_w"]) @ p["lora_a"]) @ p["lora_w"])
        .float()
    )
    w = torch.exp(w_log).reshape(b, s, h, hd)                 # decay in (0, 1)

    args = (r.float(), k.float(), v.float(), w, p["u"].float().contiguous())
    y, s_new = (wkv_impl or dispatch.wkv6)(*args, state["wkv"])
    # per-head group norm
    mu = y.mean(-1, keepdim=True)
    var = (y - mu).square().mean(-1, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(b, s, d)
    y = y * p["gn_scale"] + p["gn_bias"]
    y = (y.to(xa.dtype) * g) @ p["wo"]
    return y, {"shift": xa[:, -1], "wkv": s_new}


def channel_mix(p: dict, xb: torch.Tensor, cfg, shift: torch.Tensor):
    """xb: normed input (B, S, d); shift: (B, d) carry. Returns
    ``(y, new_shift)``; ``new_shift`` is a view of ``xb``."""
    prev = _token_shift(xb, shift)
    xx = prev - xb
    xk = xb + xx * p["mu_k"]
    xr = xb + xx * p["mu_r"]
    kk = torch.relu(xk @ p["wk"]).square()
    y = torch.sigmoid(xr @ p["wr"]) * (kk @ p["wv"])
    return y, xb[:, -1]


def init_wkv_state(cfg, batch: int, dtype=torch.float32, device="cpu") -> dict:
    """One layer's zero state: the two shift carries in ``dtype``, the WKV
    state in fp32."""
    d = cfg.d_model
    h, hd = n_wkv_heads(cfg), cfg.wkv_head_dim
    return {
        "tm": {
            "shift": torch.zeros((batch, d), dtype=dtype, device=device),
            "wkv": torch.zeros((batch, h, hd, hd), device=device),
        },
        "cm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
    }
