"""Fused decay-weighted accumulation: ``acc + d * g`` on flat buffers.

The port of the Pallas TPU kernel ``decay_accum_pallas``
(``src/repro/kernels/decay_accum.py:27``): the decay/mask-weighted SGD step of
the federated loop (``d = -eta * w``) and ``scale_rows``. Three pieces:

* :func:`decay_accum_cuda` — the wrapper of the hand-written Hopper kernel in
  ``csrc/decay_accum.cu``: an ``(m, n)`` buffer with one coefficient per row
  (or an ``(n,)`` buffer with a scalar) in one launch, on the current stream,
  without synchronising; it counts its launches in :data:`launches`.
* :func:`decay_accum_plain` — the same function in plain PyTorch ops, op for
  op the jnp path of ``repro.kernels.dispatch.decay_accum``. The CPU path
  runs it; on the card it is only the reference the kernel is held against.
* the coefficient and buffer checks shared with ``flat_update``.

Callers go through :func:`repro_torch.kernels.dispatch.decay_accum`.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import _build

# Buffer dtypes the flat kernels take, by the code csrc/flat_common.cuh uses.
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

Coef = Union[float, torch.Tensor]

launches = 0          # kernel launches made by decay_accum_cuda


def rows_view(d: Coef, ndim: int):
    """``d`` broadcast against a buffer of ``ndim`` dims: an ``(m,)``
    coefficient becomes ``(m, 1)``; a scalar stays as it is."""
    if isinstance(d, torch.Tensor) and d.ndim == 1 and ndim == 2:
        return d[:, None]
    return d


def decay_accum_plain(acc: torch.Tensor, g: torch.Tensor, d: Coef, *,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: ``acc + d * g`` in fp32, cast to ``acc.dtype``.

    ``d`` is a Python number, a 0-d fp32 tensor or an ``(m,)`` fp32 tensor of
    per-row coefficients. With ``out`` given the result is copied into it.
    """
    res = (acc.float() + rows_view(d, acc.ndim) * g.float()).to(acc.dtype)
    if out is None:
        return res
    return out.copy_(res)


def check_buffer(fn: str, name: str, t: torch.Tensor, shape, dtypes,
                 device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be a tensor, got "
                        f"{type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{fn}: {name} must be one of "
                        f"{[str(x) for x in dtypes]}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def rows_of(fn: str, t: torch.Tensor) -> Tuple[int, int]:
    """``(m, n)`` of an ``(m, n)`` buffer; an ``(n,)`` buffer is one row."""
    if t.ndim == 2:
        return int(t.shape[0]), int(t.shape[1])
    if t.ndim == 1:
        return 1, int(t.shape[0])
    raise ValueError(f"{fn}: buffers must be (n,) or (m, n), got "
                     f"{tuple(t.shape)}")


def coef_args(fn: str, name: str, c: Coef, m: int, ndim: int, device):
    """A coefficient as the kernels take it: ``(pointer, stride, value)``.

    An ``(m,)`` fp32 tensor on the buffers' device is read per row (stride 1);
    a one-element fp32 tensor on that device is read in place (stride 0), so
    no value crosses to the host; a Python number or a CPU scalar tensor is
    passed by value (rounded to fp32, as torch rounds a scalar operand).
    """
    if isinstance(c, torch.Tensor):
        if c.ndim == 0 and c.device.type == "cpu":
            return None, 0, float(c)
        if c.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be float32, got {c.dtype}")
        if c.device != device:
            raise ValueError(f"{fn}: {name} is on {c.device}, buffers on "
                             f"{device}")
        if c.ndim == 0:
            return c.data_ptr(), 0, 0.0
        if c.ndim != 1 or ndim != 2 or c.shape[0] != m:
            raise ValueError(f"{fn}: {name} must be a scalar or ({m},) with "
                             f"(m, n) buffers, got {tuple(c.shape)}")
        if not c.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        return c.data_ptr(), 1, 0.0
    return None, 0, float(c)


def raise_on(fn: str, lib, err: int) -> None:
    if err:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}: "
                           f"{lib.repro_cuda_error_string(err).decode()}")


def stream_of(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def decay_accum_cuda(acc: torch.Tensor, g: torch.Tensor, d: Coef, *,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the Hopper kernel of ``csrc/decay_accum.cu``: ``acc + d * g``.

    ``acc``, ``g`` (and ``out``) are contiguous ``(n,)`` or ``(m, n)`` CUDA
    buffers of one dtype (fp32, bf16 or fp16); ``d`` is a number, a 0-d fp32
    tensor, or an ``(m,)`` fp32 tensor of per-row coefficients on the same
    device. ``out`` may be ``acc`` (the in-place step); without it the
    wrapper allocates the result.

    Library yardstick: ``torch.addcmul(acc, d[:, None], g)`` computes the
    same function in fp32 (it is timed beside the kernel, never called here).
    """
    global launches
    fn = "decay_accum_cuda"
    device = acc.device
    if device.type != "cuda":
        raise ValueError(f"{fn}: tensors must be on a CUDA device, got {device}")
    m, n = rows_of(fn, acc)
    dtypes = (acc.dtype,) if acc.dtype in DTYPE_CODE else tuple(DTYPE_CODE)
    check_buffer(fn, "acc", acc, acc.shape, dtypes, device)
    check_buffer(fn, "g", g, acc.shape, dtypes, device)
    ptr, stride, value = coef_args(fn, "d", d, m, acc.ndim, device)
    if out is None:
        out = torch.empty_like(acc)
    else:
        check_buffer(fn, "out", out, acc.shape, dtypes, device)
    if acc.numel() == 0:
        return out
    lib = _build.load()
    raise_on(fn, lib, lib.repro_decay_accum(
        acc.data_ptr(), g.data_ptr(), out.data_ptr(), ptr, stride, value,
        m, n, DTYPE_CODE[acc.dtype], device.index, stream_of(device)))
    launches += 1
    return out
