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

import numpy as np
import torch

from repro_torch.kernels import _build

# Buffer dtypes the flat kernels take, by the code csrc/flat_common.cuh uses.
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

Coef = Union[float, torch.Tensor]

launches = 0          # kernel launches made by decay_accum_cuda


def rows_view(d: Coef, ndim: int):
    """``d`` broadcast against a buffer of ``ndim`` dims: per-row
    coefficients (``(m,)`` on ``(m, n)``, ``(S, m)`` on ``(S, m, n)``) gain
    a trailing unit axis; a scalar stays as it is."""
    if isinstance(d, torch.Tensor) and d.ndim >= 1 and d.ndim == ndim - 1:
        return d[..., None]
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


def rows_of(fn: str, t: torch.Tensor) -> Tuple[Tuple[int, ...], int]:
    """``(row_shape, n)`` of a flat buffer: ``(n,)`` is one row (``()``),
    ``(m, n)`` m rows (``(m,)``), and a sweep's ``(S, m, n)`` S * m rows
    (``(S, m)``), each of n elements."""
    if t.ndim in (1, 2, 3):
        return tuple(int(x) for x in t.shape[:-1]), int(t.shape[-1])
    raise ValueError(f"{fn}: buffers must be (n,), (m, n) or (S, m, n), got "
                     f"{tuple(t.shape)}")


def coef_args(fn: str, name: str, c: Coef, row_shape, device):
    """A coefficient as the kernels take it: ``(pointer, stride, value)``.

    A fp32 tensor of the buffer's ``row_shape`` (``(m,)`` for ``(m, n)``,
    ``(S, m)`` for ``(S, m, n)``) on the buffers' device is read per row
    (stride 1); a one-element fp32 tensor on that device is read in place
    (stride 0), so no value crosses to the host; a Python number or a CPU
    scalar tensor is passed by value (rounded to fp32, as torch rounds a
    scalar operand).
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
        if not row_shape or tuple(c.shape) != tuple(row_shape):
            want = tuple(row_shape) if row_shape else "(m,)"
            raise ValueError(f"{fn}: {name} must be a scalar or {want} per "
                             f"row of the buffers, got {tuple(c.shape)}")
        if not c.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        return c.data_ptr(), 1, 0.0
    return None, 0, float(c)


def run_lr_args(fn: str, lr, row_shape, device):
    """A learning rate as the optimizer kernels take it: ``(pointer,
    run_rows, value)``. A number is passed by value; an ``(S,)`` fp32 tensor
    on the buffers' device with ``(S, m, n)`` buffers is read per run (run
    s owns rows ``s * m .. s * m + m - 1``)."""
    if not isinstance(lr, torch.Tensor):
        return None, 0, float(lr)
    if lr.ndim == 0 and lr.device.type == "cpu":
        return None, 0, float(lr)
    if len(row_shape) != 2 or tuple(lr.shape) != (row_shape[0],):
        raise ValueError(f"{fn}: lr must be a number, or one per run (S,) "
                         f"with (S, m, n) buffers; got {tuple(lr.shape)} for "
                         f"rows {tuple(row_shape)}")
    if lr.dtype != torch.float32:
        raise TypeError(f"{fn}: lr must be float32, got {lr.dtype}")
    if lr.device != device:
        raise ValueError(f"{fn}: lr is on {lr.device}, buffers on {device}")
    if not lr.is_contiguous():
        raise ValueError(f"{fn}: lr must be contiguous")
    return lr.data_ptr(), row_shape[1], 0.0


def raise_on(fn: str, lib, err: int) -> None:
    if err:
        raise RuntimeError(f"{fn}: launch failed with CUDA error {err}: "
                           f"{lib.repro_cuda_error_string(err).decode()}")


def stream_of(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def decay_accum_cuda(acc: torch.Tensor, g: torch.Tensor, d: Coef, *,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the Hopper kernel of ``csrc/decay_accum.cu``: ``acc + d * g``.

    ``acc``, ``g`` (and ``out``) are contiguous ``(n,)``, ``(m, n)`` or
    ``(S, m, n)`` CUDA buffers of one dtype (fp32, bf16 or fp16), the last
    seen as S * m rows; ``d`` is a number, a 0-d fp32 tensor, or an fp32
    tensor of per-row coefficients (``(m,)`` / ``(S, m)``) on the same
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
    row_shape, n = rows_of(fn, acc)
    m = int(np.prod(row_shape, dtype=np.int64))
    dtypes = (acc.dtype,) if acc.dtype in DTYPE_CODE else tuple(DTYPE_CODE)
    check_buffer(fn, "acc", acc, acc.shape, dtypes, device)
    check_buffer(fn, "g", g, acc.shape, dtypes, device)
    ptr, stride, value = coef_args(fn, "d", d, row_shape, device)
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
