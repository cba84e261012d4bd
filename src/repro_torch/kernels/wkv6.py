"""The WKV6 recurrence of the RWKV6 time-mix, with its final state.

The port of the Pallas TPU kernel ``wkv6_pallas``
(``src/repro/kernels/wkv6.py:56``). Per (b, h), over t:

    y_t[j] = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
    S      <- diag(w_t) S + k_t v_t^T

* :func:`wkv6_cuda` wraps the hand-written Hopper kernel of
  ``csrc/wkv6.cu`` (one launch on the current stream, no synchronisation;
  launches counted in :data:`launches`). It takes fp32 only, like the TPU
  kernel, and no chunk size: a loop over t inside the block replaces the
  sequential chunk grid;
* :func:`wkv6_plain` is the same function in plain PyTorch, op for op the
  JAX package's ``wkv_scan`` loop (``src/repro/models/rwkv6.py:65-80``) in
  the inputs' dtype. The CPU path runs it; on the card it is only the
  reference the kernel is held against.

Callers go through :func:`repro_torch.kernels.dispatch.wkv6`. No single
PyTorch call computes this recurrence, so the kernel has no library
yardstick.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.consensus_step import overlaps
from repro_torch.kernels.decay_accum import check_buffer, raise_on, stream_of

HEAD_DIM = 64         # the one head size the kernel takes

launches = 0          # kernel launches made by wkv6_cuda


def check_shapes(fn: str, r, k, v, w, u, state) -> Tuple[int, int, int, int]:
    """``(B, T, H, D)`` of ``r``, once ``k, v, w`` match it, ``u`` is
    ``(H, D)`` and ``state`` is ``(B, H, D, D)``; raises ``ValueError``."""
    if r.ndim != 4:
        raise ValueError(f"{fn}: r must be (B, T, H, D), got {tuple(r.shape)}")
    B, T, H, D = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{fn}: {name} must match r {tuple(r.shape)}, "
                             f"got {tuple(t.shape)}")
    if tuple(u.shape) != (H, D):
        raise ValueError(f"{fn}: u must be ({H}, {D}), got {tuple(u.shape)}")
    if tuple(state.shape) != (B, H, D, D):
        raise ValueError(f"{fn}: state must be ({B}, {H}, {D}, {D}), got "
                         f"{tuple(state.shape)}")
    return B, T, H, D


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``wkv_scan``'s loop over t in ``r``'s dtype.

    ``r, k, v, w``: ``(B, T, H, D)``; ``u``: ``(H, D)``; ``state``:
    ``(B, H, D, D)``. Returns new ``(y (B, T, H, D), final_state)``; the
    inputs are not written.
    """
    s = state
    bonus = u[None, :, :, None]
    ys = []
    for r_t, k_t, v_t, w_t in zip(r.unbind(1), k.unbind(1), v.unbind(1),
                                  w.unbind(1)):
        kv = k_t[..., :, None] * v_t[..., None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r_t, s + bonus * kv))
        s = w_t[..., :, None] * s + kv
    if not ys:
        return r.new_empty(r.shape), s.clone()
    return torch.stack(ys, 1), s


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
              state_out: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``wkv6_kernel``: returns ``(y, final_state)``.

    ``r, k, v, w`` are contiguous fp32 ``(B, T, H, 64)`` CUDA tensors with
    T >= 1, ``u`` a contiguous fp32 ``(H, 64)`` and ``state`` a contiguous
    fp32 ``(B, H, 64, 64)``, all on one device. The final state goes to
    ``state_out`` (allocated when not given), which may be ``state`` itself
    (the in-place decode update) but must not overlap it otherwise; ``y`` is
    allocated here.

    The kernel picks its block shape by B * H and T (and a whole-column
    kernel for a decode step over many (b, h)), none of which changes its
    arithmetic: a (b, h) gives the same bits at any batch size, and a
    sequence cut anywhere and chained through the state gives the bits of
    one run. Its sum over i is not the einsum's, so it matches
    :func:`wkv6_plain` to fp32 rounding.
    """
    global launches
    fn = "wkv6_cuda"
    device = r.device
    if device.type != "cuda":
        raise ValueError(f"{fn}: tensors must be on a CUDA device, got {device}")
    B, T, H, D = check_shapes(fn, r, k, v, w, u, state)
    if D != HEAD_DIM:
        raise ValueError(f"{fn}: the kernel takes head size {HEAD_DIM}, got {D}")
    if T < 1:
        raise ValueError(f"{fn}: needs T >= 1, got {T}")
    f32 = (torch.float32,)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        check_buffer(fn, name, t, r.shape, f32, device)
    check_buffer(fn, "u", u, (H, D), f32, device)
    check_buffer(fn, "state", state, (B, H, D, D), f32, device)
    if state_out is None:
        state_out = torch.empty_like(state)
    else:
        check_buffer(fn, "state_out", state_out, (B, H, D, D), f32, device)
        if state_out.data_ptr() != state.data_ptr() and overlaps(state_out,
                                                                 state):
            raise ValueError(f"{fn}: state_out overlaps state without being "
                             f"it")
    y = torch.empty_like(r)
    lib = _build.load()
    raise_on(fn, lib, lib.repro_wkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state.data_ptr(), y.data_ptr(), state_out.data_ptr(), B, T, H, D,
        stream_of(device)))
    launches += 1
    return y, state_out
