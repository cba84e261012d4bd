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

Its gradient (training) has no Pallas twin: the JAX package differentiates
``wkv_scan``'s ``lax.scan``. Given ``dy`` and the gradient ``dsT`` of the
final state:

* :func:`wkv6_bwd_cuda` wraps the hand-written kernels of
  ``csrc/wkv6_bwd.cu`` (up to three launches, counted once in
  :data:`bwd_launches`): ``(dr, dk, dv, dw, du, ds0)``;
* :func:`wkv6_bwd_plain` is the same function in plain PyTorch (the
  forward's states kept, then the reverse loop).

Callers go through :func:`repro_torch.kernels.dispatch.wkv6` (and its
autograd function ``dispatch.Wkv6``). No single PyTorch call computes this
recurrence or its gradient, so neither kernel has a library yardstick.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.consensus_step import overlaps
from repro_torch.kernels.decay_accum import check_buffer, raise_on, stream_of

HEAD_DIM = 64         # the one head size the kernel takes

launches = 0          # kernel launches made by wkv6_cuda
bwd_launches = 0      # calls of wkv6_bwd_cuda (up to three kernels each)
BWD_CHUNK = 32        # steps a time chunk of csrc/wkv6_bwd.cu


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


Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor, torch.Tensor]


def _check_bwd(fn, r, k, v, w, u, s0, dy, dsT):
    B, T, H, D = check_shapes(fn, r, k, v, w, u, s0)
    if tuple(dy.shape) != tuple(r.shape):
        raise ValueError(f"{fn}: dy must match r {tuple(r.shape)}, got "
                         f"{tuple(dy.shape)}")
    if dsT is not None and tuple(dsT.shape) != tuple(s0.shape):
        raise ValueError(f"{fn}: dsT must match the state {tuple(s0.shape)}, "
                         f"got {tuple(dsT.shape)}")
    return B, T, H, D


def wkv6_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                   dy: torch.Tensor, dsT: Optional[torch.Tensor] = None
                   ) -> Grads:
    """Plain version of the gradient of :func:`wkv6_plain`: ``(dr, dk, dv,
    dw, du, ds0)`` in ``r``'s dtype, from ``dy`` (``(B, T, H, D)``) and the
    final state's gradient ``dsT`` (``None``: zero). With ``G`` the
    gradient of the state after step t and ``S`` the one before it:
    ``G <- w_t G + r_t dy_t^T`` walking t down, ``dr = S dy + u k (dy.v)``,
    ``dk = G v + r u (dy.v)``, ``dv = G^T k + (r.u k) dy``, ``dw = rowsum(G
    * S)``, ``du = sum r k (dy.v)``. Keeps the T states S and G: a
    reference for short sequences and small batches."""
    _check_bwd("wkv6_bwd_plain", r, k, v, w, u, s0, dy, dsT)
    # The states S_{t-1} (forward) and G_t (walking t down), (B, T, H, D, D)
    # each; every other gradient is a batched sum over them.
    states, s = [], s0
    for k_t, v_t, w_t in zip(k.unbind(1), v.unbind(1), w.unbind(1)):
        states.append(s)
        s = w_t[..., :, None] * s + k_t[..., :, None] * v_t[..., None, :]
    G = torch.zeros_like(s0) if dsT is None else dsT
    grads = [None] * r.shape[1]
    for t in range(r.shape[1] - 1, -1, -1):
        grads[t] = G
        G = w[:, t, ..., None] * G + r[:, t, ..., None] * dy[:, t, :, None, :]
    if not grads:
        z = torch.zeros_like(r)
        return z, z.clone(), z.clone(), z.clone(), torch.zeros_like(u), G
    S, Gs = torch.stack(states, 1), torch.stack(grads, 1)
    c = (dy * v).sum(-1, keepdim=True)                      # (B, T, H, 1)
    dr = torch.einsum("bthij,bthj->bthi", S, dy) + u * k * c
    dk = torch.einsum("bthij,bthj->bthi", Gs, v) + r * u * c
    dv = torch.einsum("bthij,bthi->bthj", Gs, k) \
        + (r * u * k).sum(-1, keepdim=True) * dy
    dw = (Gs * S).sum(-1)
    du = (r * k * c).sum((0, 1))
    return dr, dk, dv, dw, du, G


def bwd_scratch_shapes(B: int, T: int, H: int, D: int = HEAD_DIM) -> dict:
    """The fp32 scratch :func:`wkv6_bwd_cuda` gives its kernels, with n =
    ceil(T / :data:`BWD_CHUNK`) time chunks: the state S at the start of
    chunks 1 .. n - 1 (``sck``), the state gradient G at the end of chunks
    0 .. n - 2 (``gck``), and du's partial of every (b, chunk)
    (``du_part``)."""
    n = -(-T // BWD_CHUNK)
    return {"sck": (B, H, n - 1, D, D), "gck": (B, H, n - 1, D, D),
            "du_part": (B, n, H, D)}


def wkv6_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                  dy: torch.Tensor, dsT: Optional[torch.Tensor] = None
                  ) -> Grads:
    """Launch ``wkv6_bwd_bound_kernel`` (the states at the time chunks'
    edges; not when T <= :data:`BWD_CHUNK`), ``wkv6_bwd_chunk_kernel``
    (persistent blocks over the (b, h, chunk) units) and
    ``wkv6_bwd_du_kernel``: returns ``(dr, dk, dv, dw, du, ds0)``.

    Takes what :func:`wkv6_cuda` takes (contiguous fp32 on one CUDA device,
    D = 64, T >= 1), with ``dy`` like ``r`` and ``dsT`` like ``s0`` or
    ``None`` (a zero gradient of the final state); every pointer 16-byte
    aligned. The outputs and the scratch of :func:`bwd_scratch_shapes` are
    allocated here. Fixed order, no atomics: a shape's result repeats
    bitwise; it matches :func:`wkv6_bwd_plain` to fp32 rounding."""
    global bwd_launches
    fn = "wkv6_bwd_cuda"
    device = r.device
    if device.type != "cuda":
        raise ValueError(f"{fn}: tensors must be on a CUDA device, got {device}")
    B, T, H, D = _check_bwd(fn, r, k, v, w, u, s0, dy, dsT)
    if D != HEAD_DIM:
        raise ValueError(f"{fn}: the kernel takes head size {HEAD_DIM}, got {D}")
    if T < 1:
        raise ValueError(f"{fn}: needs T >= 1, got {T}")
    f32 = (torch.float32,)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("dy", dy)):
        check_buffer(fn, name, t, r.shape, f32, device)
    check_buffer(fn, "u", u, (H, D), f32, device)
    check_buffer(fn, "s0", s0, (B, H, D, D), f32, device)
    if dsT is not None:
        check_buffer(fn, "dsT", dsT, (B, H, D, D), f32, device)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0), ("dy", dy), ("dsT", dsT)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must start on a 16-byte boundary")
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du, ds0 = torch.empty_like(u), torch.empty_like(s0)
    sck, gck, du_part = (torch.empty(shape, dtype=torch.float32,
                                     device=device)
                         for shape in bwd_scratch_shapes(B, T, H, D).values())
    lib = _build.load()
    raise_on(fn, lib, lib.repro_wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), dy.data_ptr(), 0 if dsT is None else dsT.data_ptr(),
        sck.data_ptr(), gck.data_ptr(), du_part.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
        du.data_ptr(), ds0.data_ptr(), B, T, H, D, stream_of(device)))
    bwd_launches += 1
    return dr, dk, dv, dw, du, ds0
