"""Sparse neighbour-list gossip: ``out[i] = sum_k w[i,k] * g[idx[i,k]]``.

The port of the Pallas TPU kernel ``consensus_gather_pallas``
(``src/repro/kernels/consensus_gather.py:51``): one consensus round over a
padded ``(m, k_max)`` neighbour list (``repro_torch.core.topology``'s
``NeighborList`` layout), O(m*k) instead of the dense O(m^2) mix.

* :func:`consensus_gather_cuda` wraps the hand-written Hopper kernel of
  ``csrc/consensus_gather.cu`` (one launch on the current stream, no
  synchronisation; launches counted in :data:`launches`);
* :func:`consensus_gather_plain` is the ascending-k loop of the jnp path of
  ``repro.kernels.dispatch.consensus_gather`` (``dispatch.py:428-434``) in
  torch: ``w[:, 0] * g32[idx[:, 0]]``, then ``out + w[:, k] * g32[idx[:,
  k]]``, each a separately rounded fp32 operation. The kernel performs the
  same roundings in the same order, so the two are bitwise equal.

Callers go through :func:`repro_torch.kernels.dispatch.consensus_gather`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.consensus_step import overlaps
from repro_torch.kernels.decay_accum import (
    DTYPE_CODE,
    check_buffer,
    raise_on,
    stream_of,
)

launches = 0          # kernel launches made by consensus_gather_cuda


def consensus_gather_plain(g: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                           *, out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain version: the fp32 ascending-k chain, cast to ``g.dtype``."""
    g32 = g.float()
    idx = idx.long()
    acc = w[:, 0, None] * g32[idx[:, 0]]
    for k in range(1, idx.shape[1]):
        acc = acc + w[:, k, None] * g32[idx[:, k]]
    res = acc.to(g.dtype)
    return res if out is None else out.copy_(res)


def consensus_gather_cuda(g: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                          *, out: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Launch ``consensus_gather_kernel``: one sparse gossip round.

    ``g`` is a contiguous ``(m, n)`` CUDA buffer (fp32, bf16 or fp16),
    ``idx`` a contiguous ``(m, k_max)`` int32 neighbour list and ``w`` the
    matching fp32 weights, on the same device. ``idx`` must hold rows in
    ``[0, m)`` and ``w`` must be 0.0 on padding: the kernel gathers every
    slot, and a row out of range would read foreign memory, so the caller
    checks ``idx`` once on the host (the strategy does, when it builds its
    neighbour list), not on every launch. ``out`` (allocated when not given)
    must not overlap ``g``.

    The same function is one sparse-dense product, ``W @ g`` with ``W`` the
    ``(m, m)`` matrix of ``(idx, w)``: ``chip_smoke.py`` times
    ``torch.sparse.mm`` of its CSR form (cuSPARSE SpMM) as the yardstick.
    The port never calls it.
    """
    global launches
    fn = "consensus_gather_cuda"
    device = g.device
    if device.type != "cuda":
        raise ValueError(f"{fn}: tensors must be on a CUDA device, got {device}")
    if g.ndim != 2 or idx.ndim != 2:
        raise ValueError(f"{fn}: g and idx must be 2-D, got {tuple(g.shape)} "
                         f"and {tuple(idx.shape)}")
    m, n = g.shape
    check_buffer(fn, "g", g, g.shape, tuple(DTYPE_CODE), device)
    check_buffer(fn, "idx", idx, (m, idx.shape[1]), (torch.int32,), device)
    check_buffer(fn, "w", w, tuple(idx.shape), (torch.float32,), device)
    if out is None:
        out = torch.empty_like(g)
    else:
        check_buffer(fn, "out", out, g.shape, (g.dtype,), device)
        if overlaps(out, g):
            raise ValueError(f"{fn}: out overlaps g (gossip cannot run in "
                             f"place)")
    if g.numel() == 0:
        return out
    if idx.shape[1] == 0:
        raise ValueError(f"{fn}: k_max must be >= 1")
    lib = _build.load()
    raise_on(fn, lib, lib.repro_consensus_gather(
        g.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), m, n,
        int(idx.shape[1]), DTYPE_CODE[g.dtype], stream_of(device)))
    launches += 1
    return out
