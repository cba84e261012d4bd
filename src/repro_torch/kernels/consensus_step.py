"""Dense consensus gossip: ``out = P @ G`` on the flat ``(m, n)`` carry.

The port of the Pallas TPU kernel ``consensus_step_pallas``
(``src/repro/kernels/consensus_step.py:36``): one (possibly fused-E,
possibly mask-folded) gossip mix of the per-agent gradient rows.

* :func:`consensus_step_cuda` wraps the hand-written Hopper kernel of
  ``csrc/consensus_step.cu`` (one launch on the current stream, no
  synchronisation; launches counted in :data:`launches`);
* :func:`consensus_step_plain` is the same function in plain PyTorch, the
  jnp path of ``repro.kernels.dispatch.consensus_mix``
  (``dispatch.py:364-370``): an fp32 matmul cast back to ``G.dtype``. The
  CPU path runs it; on the card it is only the reference the kernel is held
  against.

Callers go through :func:`repro_torch.kernels.dispatch.consensus_mix`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decay_accum import (
    DTYPE_CODE,
    check_buffer,
    raise_on,
    stream_of,
)

launches = 0          # kernel launches made by consensus_step_cuda


def consensus_step_plain(g: torch.Tensor, mixing: torch.Tensor, *,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``(mixing32 @ g32).to(g.dtype)``; with ``out`` given
    the result is copied into it."""
    res = torch.matmul(mixing.float(), g.float()).to(g.dtype)
    return res if out is None else out.copy_(res)


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the storage spans of two tensors intersect."""
    a0 = a.data_ptr()
    b0 = b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and \
        b0 < a0 + a.numel() * a.element_size()


def consensus_step_cuda(g: torch.Tensor, mixing: torch.Tensor, *,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel of ``csrc/consensus_step.cu``: ``out = mixing @ g``
    (``consensus_step_kernel_small`` for m <= 32, else
    ``consensus_step_kernel_tiled``; the C entry point picks by m).

    ``g`` is a contiguous ``(m, n)`` CUDA buffer (fp32, bf16 or fp16),
    ``mixing`` a contiguous ``(m, m)`` fp32 matrix on the same device, and
    ``out`` (allocated when not given) a ``g``-shaped buffer of ``g``'s dtype
    that does not overlap ``g``: gossip cannot run in place.

    Library yardstick: ``torch.matmul(mixing, g)`` (timed beside the kernel,
    never called here).
    """
    global launches
    fn = "consensus_step_cuda"
    device = g.device
    if device.type != "cuda":
        raise ValueError(f"{fn}: tensors must be on a CUDA device, got {device}")
    if g.ndim != 2:
        raise ValueError(f"{fn}: g must be (m, n), got {tuple(g.shape)}")
    m, n = g.shape
    check_buffer(fn, "g", g, g.shape, tuple(DTYPE_CODE), device)
    check_buffer(fn, "mixing", mixing, (m, m), (torch.float32,), device)
    if out is None:
        out = torch.empty_like(g)
    else:
        check_buffer(fn, "out", out, g.shape, (g.dtype,), device)
        if overlaps(out, g):
            raise ValueError(f"{fn}: out overlaps g (gossip cannot run in "
                             f"place)")
    if g.numel() == 0:
        return out
    lib = _build.load()
    raise_on(fn, lib, lib.repro_consensus_step(
        mixing.data_ptr(), g.data_ptr(), out.data_ptr(), m, n,
        DTYPE_CODE[g.dtype], stream_of(device)))
    launches += 1
    return out
