"""Fused top-k select + server sum + residual: the compressed uplink's
server reduction.

The port of the Pallas TPU kernel ``topk_scatter_pallas``
(``src/repro/kernels/topk_scatter.py:37``). From ``x (m, n)`` and the
per-agent magnitude thresholds ``t (m,)`` (``repro_torch.comm.topk_threshold``,
computed outside the kernel): ``sent = |x| >= t_i ? x : 0`` (ties kept),
the ``(n,)`` fp32 sum of ``sent`` over agents and the ``(m, n)`` residual
``x - sent``, both in ``x.dtype``.

* :func:`topk_scatter_cuda` wraps the hand-written Hopper kernel of
  ``csrc/topk_scatter.cu`` (one launch, one pass, no atomics; launches
  counted in :data:`launches`);
* :func:`topk_scatter_plain` is ``torch.where`` and an fp32 ``sum(0)``:
  the JAX jnp path (``dispatch.py:498-503``) with its ``segment_sum``
  written as the column sum it computes. The residual is bitwise equal to
  the kernel's; the sums are taken in different orders and agree to
  rounding.

Callers go through :func:`repro_torch.kernels.dispatch.topk_scatter`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decay_accum import (
    DTYPE_CODE,
    check_buffer,
    raise_on,
    stream_of,
)

launches = 0          # kernel launches made by topk_scatter_cuda


def topk_scatter_plain(x: torch.Tensor, t: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``(sum_i sent, x - sent)`` in ``x.dtype``, fp32 inside."""
    x32 = x.float()
    sent = torch.where(x32.abs() >= t[:, None], x32, 0.0)
    return sent.sum(0).to(x.dtype), (x32 - sent).to(x.dtype)


def topk_scatter_cuda(x: torch.Tensor, t: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``topk_scatter_kernel``; returns ``(ssum, residual)``.

    ``x`` is a contiguous ``(m, n)`` CUDA buffer (fp32, bf16 or fp16) and
    ``t`` a contiguous ``(m,)`` fp32 threshold vector on the same device;
    the outputs are a new ``(n,)`` and a new ``(m, n)`` buffer of ``x``'s
    dtype.

    No single PyTorch call computes this select + sum + residual, so the
    kernel has no library yardstick.
    """
    global launches
    fn = "topk_scatter_cuda"
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"{fn}: tensors must be on a CUDA device, got {device}")
    if x.ndim != 2:
        raise ValueError(f"{fn}: x must be (m, n), got {tuple(x.shape)}")
    m, n = x.shape
    check_buffer(fn, "x", x, x.shape, tuple(DTYPE_CODE), device)
    check_buffer(fn, "t", t, (m,), (torch.float32,), device)
    out_sum = torch.empty(n, dtype=x.dtype, device=device)
    out_residual = torch.empty_like(x)
    if n == 0:
        return out_sum, out_residual
    if m == 0:
        return out_sum.zero_(), out_residual
    lib = _build.load()
    raise_on(fn, lib, lib.repro_topk_scatter(
        x.data_ptr(), t.data_ptr(), out_sum.data_ptr(),
        out_residual.data_ptr(), m, n, DTYPE_CODE[x.dtype], stream_of(device)))
    launches += 1
    return out_sum, out_residual
