"""The flat-carry kernels: server averaging and the fused optimizer steps.

The port of the Pallas TPU kernels of ``src/repro/kernels/flat_update.py``:

* ``row_mean`` (``row_mean_pallas``, :41) — ``(m, n) -> (n,)`` mean over the
  agent axis in fp32: the server average, eq. (11);
* ``momentum_update`` (``momentum_update_pallas``, :79) —
  ``mu <- beta * mu + w * g``, ``p <- p - lr * (nesterov ? beta * mu + w * g
  : mu)``;
* ``adam_update`` (``adam_update_pallas``, :158) — bias-corrected AdamW with
  fp32 moments, ``bc1``/``bc2`` passed in and ``wd * p`` added to the step.

For each, ``*_cuda`` wraps the hand-written Hopper kernel of
``csrc/flat_update.cu`` (a whole ``(m, n)`` buffer with one weight per row in
one launch, on the current stream, without synchronising; launches counted
in :data:`launches` under the kernel's name), and ``*_plain`` is the same
function in plain PyTorch ops, op for op the jnp path of
``repro.kernels.dispatch`` (``row_mean`` :442, ``flat_opt_update``
:645-690). The CPU path runs the plain versions; on the card they are only
the references the kernels are held against. Callers go through
:mod:`repro_torch.kernels.dispatch`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decay_accum import (
    DTYPE_CODE,
    Coef,
    check_buffer,
    coef_args,
    raise_on,
    rows_of,
    rows_view,
    stream_of,
)

# kernel launches made by the *_cuda wrappers, by kernel
launches = {"row_mean": 0, "momentum_update": 0, "adam_update": 0}

_F32 = (torch.float32,)


# --- row_mean -------------------------------------------------------------------

def row_mean_plain(g: torch.Tensor, *,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: the fp32 mean over axis 0, cast to ``g.dtype``."""
    res = g.float().mean(0).to(g.dtype)
    if out is None:
        return res
    return out.copy_(res)


def row_mean_cuda(g: torch.Tensor, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``row_mean_kernel``: the ``(n,)`` fp32 mean of an ``(m, n)``
    buffer over its rows, cast to ``g.dtype`` (fp32, bf16 or fp16).

    One launch a call (``row_mean_kernel_rows`` for up to 64 rows); ``g``
    may start at any element. The sum's order is fixed by the shape, so a
    call repeats bitwise; it is not torch's order, so it matches
    :func:`row_mean_plain` to rounding.

    Library yardstick: ``g.float().mean(0)`` (timed beside the kernel, never
    called here).
    """
    fn = "row_mean_cuda"
    device = g.device
    if device.type != "cuda":
        raise ValueError(f"{fn}: tensors must be on a CUDA device, got {device}")
    if g.ndim != 2:
        raise ValueError(f"{fn}: g must be (m, n), got {tuple(g.shape)}")
    m, n = g.shape
    check_buffer(fn, "g", g, g.shape, tuple(DTYPE_CODE), device)
    if out is None:
        out = torch.empty(n, dtype=g.dtype, device=device)
    else:
        check_buffer(fn, "out", out, (n,), (g.dtype,), device)
    if n == 0:
        return out
    if m == 0:
        return out.fill_(float("nan"))       # the mean of nothing, as torch
    lib = _build.load()
    raise_on(fn, lib, lib.repro_row_mean(g.data_ptr(), out.data_ptr(), m, n,
                                         DTYPE_CODE[g.dtype],
                                         stream_of(device)))
    launches["row_mean"] += 1
    return out


# --- momentum ---------------------------------------------------------------------

def momentum_update_plain(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                          w: Coef, lr: float, beta: float, *,
                          nesterov: bool = False,
                          p_out: Optional[torch.Tensor] = None,
                          mu_out: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused heavy-ball step; returns ``(p, mu)``.

    With ``p_out`` / ``mu_out`` given (they may be ``p`` / ``mu``) the results
    are copied into them.
    """
    wg = rows_view(w, p.ndim) * g.float()
    new_mu = beta * mu + wg
    upd = beta * new_mu + wg if nesterov else new_mu
    new_p = (p.float() - lr * upd).to(p.dtype)
    if p_out is not None:
        new_p = p_out.copy_(new_p)
    if mu_out is not None:
        new_mu = mu_out.copy_(new_mu)
    return new_p, new_mu


def _check_step(fn, p, g, moments, outs):
    device = p.device
    if device.type != "cuda":
        raise ValueError(f"{fn}: tensors must be on a CUDA device, got {device}")
    m, n = rows_of(fn, p)
    check_buffer(fn, "p", p, p.shape, tuple(DTYPE_CODE), device)
    check_buffer(fn, "g", g, p.shape, (p.dtype,), device)
    for name, t in moments:
        check_buffer(fn, name, t, p.shape, _F32, device)
    for name, t, dtypes in outs:
        if t is not None:
            check_buffer(fn, name, t, p.shape, dtypes, device)
    return device, m, n


def momentum_update_cuda(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                         w: Coef, lr: float, beta: float, *,
                         nesterov: bool = False,
                         p_out: Optional[torch.Tensor] = None,
                         mu_out: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``momentum_update_kernel``; returns ``(p_out, mu_out)``.

    ``p``, ``g`` are contiguous ``(n,)`` or ``(m, n)`` CUDA buffers of one
    dtype (fp32, bf16 or fp16), ``mu`` the fp32 momentum of the same shape;
    ``w`` is a number, a 0-d fp32 device tensor or an ``(m,)`` fp32 tensor
    of per-row weights; ``lr`` and ``beta`` are numbers. ``p_out`` /
    ``mu_out`` may be ``p`` / ``mu`` (the in-place step); the wrapper
    allocates whichever is not given.

    No single PyTorch call computes this w-folded per-row step, so the kernel
    has no library yardstick.
    """
    fn = "momentum_update_cuda"
    device, m, n = _check_step(fn, p, g, [("mu", mu)],
                               [("p_out", p_out, (p.dtype,)),
                                ("mu_out", mu_out, _F32)])
    ptr, stride, value = coef_args(fn, "w", w, m, p.ndim, device)
    p_out = torch.empty_like(p) if p_out is None else p_out
    mu_out = torch.empty_like(mu) if mu_out is None else mu_out
    if p.numel() == 0:
        return p_out, mu_out
    lib = _build.load()
    raise_on(fn, lib, lib.repro_momentum_update(
        p.data_ptr(), g.data_ptr(), mu.data_ptr(), p_out.data_ptr(),
        mu_out.data_ptr(), ptr, stride, value, float(lr), float(beta),
        int(bool(nesterov)), m, n, DTYPE_CODE[p.dtype], device.index,
        stream_of(device)))
    launches["momentum_update"] += 1
    return p_out, mu_out


# --- Adam(W) ----------------------------------------------------------------------

def adam_update_plain(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                      nu: torch.Tensor, w: Coef, lr: float, bc1: float,
                      bc2: float, *, b1: float = 0.9, b2: float = 0.95,
                      eps: float = 1e-8, weight_decay: float = 0.0,
                      p_out: Optional[torch.Tensor] = None,
                      mu_out: Optional[torch.Tensor] = None,
                      nu_out: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the fused Adam(W) step; returns ``(p, mu, nu)``.

    ``bc1`` / ``bc2`` divide as 0-d tensors on the buffers' device, so the
    division is the IEEE one on the card too (torch turns a division by a
    Python number into a multiplication by its reciprocal there).
    """
    wg = rows_view(w, p.ndim) * g.float()
    new_mu = b1 * mu + (1.0 - b1) * wg
    new_nu = b2 * nu + (1.0 - b2) * (wg * wg)
    p32 = p.float()
    bc1_t = torch.full((), bc1, dtype=torch.float32, device=p.device)
    bc2_t = torch.full((), bc2, dtype=torch.float32, device=p.device)
    step = (new_mu / bc1_t) / (torch.sqrt(new_nu / bc2_t) + eps)
    step = step + weight_decay * p32
    new_p = (p32 - lr * step).to(p.dtype)
    if p_out is not None:
        new_p = p_out.copy_(new_p)
    if mu_out is not None:
        new_mu = mu_out.copy_(new_mu)
    if nu_out is not None:
        new_nu = nu_out.copy_(new_nu)
    return new_p, new_mu, new_nu


def adam_update_cuda(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                     nu: torch.Tensor, w: Coef, lr: float, bc1: float,
                     bc2: float, *, b1: float = 0.9, b2: float = 0.95,
                     eps: float = 1e-8, weight_decay: float = 0.0,
                     p_out: Optional[torch.Tensor] = None,
                     mu_out: Optional[torch.Tensor] = None,
                     nu_out: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``adam_update_kernel``; returns ``(p_out, mu_out, nu_out)``.

    Buffers and ``w`` as for :func:`momentum_update_cuda`, with fp32 ``nu``
    beside ``mu``; ``lr``, ``bc1 = 1 - b1**t``, ``bc2 = 1 - b2**t``, ``b1``,
    ``b2``, ``eps`` and ``weight_decay`` are numbers passed by value (the
    step counter lives outside the kernel). The outputs may be the inputs.

    No single PyTorch call computes this w-folded per-row step, so the kernel
    has no library yardstick.
    """
    fn = "adam_update_cuda"
    device, m, n = _check_step(fn, p, g, [("mu", mu), ("nu", nu)],
                               [("p_out", p_out, (p.dtype,)),
                                ("mu_out", mu_out, _F32),
                                ("nu_out", nu_out, _F32)])
    ptr, stride, value = coef_args(fn, "w", w, m, p.ndim, device)
    p_out = torch.empty_like(p) if p_out is None else p_out
    mu_out = torch.empty_like(mu) if mu_out is None else mu_out
    nu_out = torch.empty_like(nu) if nu_out is None else nu_out
    if p.numel() == 0:
        return p_out, mu_out, nu_out
    lib = _build.load()
    raise_on(fn, lib, lib.repro_adam_update(
        p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
        p_out.data_ptr(), mu_out.data_ptr(), nu_out.data_ptr(),
        ptr, stride, value, float(lr), float(b1), float(1.0 - b1), float(b2),
        float(1.0 - b2), float(eps), float(weight_decay), float(bc1),
        float(bc2), m, n, DTYPE_CODE[p.dtype], device.index,
        stream_of(device)))
    launches["adam_update"] += 1
    return p_out, mu_out, nu_out
