"""The backward of attention with an optional causal mask and sliding
window, flash-style.

No Pallas kernel of the JAX package computes it: there the training
forward's ``flash_attention`` is a ``jax.custom_vjp`` whose backward
``_flash_bwd`` (``src/repro/models/attention.py:224-260``) is jnp. The port
trains through the hand-written ``swa_attention`` forward, so its gradient
is a hand-written kernel too. For each batch row and query head h (reading
KV head ``h // (H // KV)``), with ``lse`` the forward's log-sum-exp:

    delta_i = sum_d do_id * o_id                         fp32, o in its dtype
    p_ij    = exp(s_ij * D^-1/2 - lse_i)                 0 where masked
    dv_j    = sum_i p_ij do_i        dp_ij = do_i . v_j
    ds_ij   = p_ij (dp_ij - delta_i) D^-1/2
    dq_i    = sum_j ds_ij k_j        dk_j  = sum_i ds_ij q_i

with the forward's mask (key j is seen by query rows ``j <= i < j + W``
when causal and windowed; by every row when ``causal`` is off and there is
no window, as in whisper-small's encoder and cross-attention, where Sq and
Sk may differ), all sums in fp32, the results cast to the input dtype. ``dk`` and ``dv`` are un-repeated ``(B, Sk, KV, D)``: the sum over
the ``H / KV`` query heads of a group is the gradient of JAX's
``_repeat_kv``.

* :func:`swa_attention_bwd_cuda` wraps ``csrc/swa_attention_bwd.cu``: a dq
  kernel (one block per (b, h, q tile), walking the key tiles of its
  window; it also writes ``delta``) and a dk / dv kernel (one block per
  (b, KV head, 64-row key tile), walking the group's query heads and the q
  tiles that see the tile, in a fixed order, so a shape's result repeats
  bitwise). bf16 runs on the tensor cores (wgmma on tiles a TMA producer
  streams through a shared-memory ring; ``p`` and ``ds`` enter the products
  as bf16 hi + lo), fp32 on the CUDA cores. One call is two launches on the
  current stream and counts one in :data:`launches`. Head sizes:
  the forward's :data:`HEAD_DIMS`: 64 (whisper-small, lm-100m), 120, 128
  and 256 (gemma-7b, recurrentgemma-9b).
* :func:`swa_attention_bwd_plain` is the same function in plain PyTorch,
  scores materialised in fp32 (float64 for float64 inputs) per KV group, as
  ``swa_attention_plain`` does. The CPU path runs it; on the card it is
  only the reference the kernel is held against.

The library yardstick timed beside the kernel (never called here) is the
autograd backward of ``torch.nn.functional.scaled_dot_product_attention``
on repeated K/V.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decay_accum import check_buffer, raise_on, stream_of
from repro_torch.kernels.swa_attention import (
    DTYPE_CODE,
    HEAD_DIMS,
    check_shapes,
    swa_mask,
)

launches = 0               # calls of swa_attention_bwd_cuda (two kernels each)


def check_head_dim(fn: str, d: int) -> None:
    """Raise ``ValueError`` for a head size the backward kernels do not
    take."""
    if d not in HEAD_DIMS:
        raise ValueError(f"{fn}: the backward kernels take head sizes "
                         f"{HEAD_DIMS}, got {d}")

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check_residuals(fn, q, o, do, lse, B, Sq, H):
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"{fn}: o and do must be {tuple(q.shape)}, got "
                         f"{tuple(o.shape)} / {tuple(do.shape)}")
    if tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"{fn}: lse must be {(B, H, Sq)}, got "
                         f"{tuple(lse.shape)}")


def swa_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, *,
                            window: Optional[int] = None, causal: bool = True
                            ) -> Grads:
    """Plain version: ``(dq, dk, dv)`` in the inputs' dtype, per batch row
    and KV group with the scores materialised in fp32 (float64 for float64
    inputs)."""
    fn = "swa_attention_bwd_plain"
    B, Sq, Sk, H, KV, D = check_shapes(fn, q, k, v, window, causal)
    _check_residuals(fn, q, o, do, lse, B, Sq, H)
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    rep = H // KV
    ok = swa_mask(Sq, Sk, window, causal, q.device)
    zero = torch.zeros((), dtype=ct, device=q.device)
    scale = D ** -0.5
    dqs, dks, dvs = [], [], []
    for b in range(B):
        dq_b, dk_b, dv_b = [], [], []
        for g in range(KV):
            hs = slice(g * rep, (g + 1) * rep)
            qg, og, dog = (t[b, :, hs].to(ct) for t in (q, o, do))  # (Sq, rep, D)
            kg, vg = k[b, :, g].to(ct), v[b, :, g].to(ct)          # (Sk, D)
            delta = torch.einsum("shd,shd->hs", dog, og)            # (rep, Sq)
            s = torch.einsum("shd,td->hst", qg, kg) * scale
            p = torch.where(ok, torch.exp(s - lse[b, hs].to(ct)[..., None]),
                            zero)
            dv_b.append(torch.einsum("hst,shd->td", p, dog))
            dp = torch.einsum("shd,td->hst", dog, vg)
            ds = p * (dp - delta[..., None]) * scale
            dq_b.append(torch.einsum("hst,td->shd", ds, kg))
            dk_b.append(torch.einsum("hst,shd->td", ds, qg))
        dqs.append(torch.cat(dq_b, dim=1))
        dks.append(torch.stack(dk_b, dim=1))
        dvs.append(torch.stack(dv_b, dim=1))
    return (torch.stack(dqs).to(q.dtype), torch.stack(dks).to(k.dtype),
            torch.stack(dvs).to(v.dtype))


def swa_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           o: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor, *,
                           window: Optional[int] = None, causal: bool = True
                           ) -> Grads:
    """Launch the dq kernel then the dk / dv kernel (bf16:
    ``swa_bwd_dq_hopper_kernel``, ``swa_bwd_dkdv_hopper_kernel``; fp32:
    ``swa_bwd_dq_kernel``, ``swa_bwd_dkdv_kernel``): returns ``(dq, dk, dv)``
    in the inputs' dtype.

    ``q``, ``o``, ``do`` are contiguous ``(B, Sq, H, D)`` CUDA tensors,
    ``k`` and ``v`` contiguous ``(B, Sk, KV, D)``, all fp32 or all bf16 on
    one device, D in :data:`HEAD_DIMS`; ``lse`` is the forward's
    contiguous fp32 ``(B, H, Sq)``; every pointer 16-byte aligned. The
    outputs and the fp32 scratch (``delta``, and for bf16 also ``lse * log2
    e``, each padded to whole 128-row tiles of Sq) are allocated here. A head
    size outside :data:`HEAD_DIMS` is refused first, before any other
    check or launch.
    """
    global launches
    fn = "swa_attention_bwd_cuda"
    check_head_dim(fn, q.shape[-1])
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"{fn}: tensors must be on a CUDA device, got {device}")
    B, Sq, Sk, H, KV, D = check_shapes(fn, q, k, v, window, causal)
    _check_residuals(fn, q, o, do, lse, B, Sq, H)
    dtypes = (q.dtype,) if q.dtype in DTYPE_CODE else tuple(DTYPE_CODE)
    for name, t in (("q", q), ("o", o), ("do", do)):
        check_buffer(fn, name, t, q.shape, dtypes, device)
    for name, t in (("k", k), ("v", v)):
        check_buffer(fn, name, t, k.shape, dtypes, device)
    check_buffer(fn, "lse", lse, (B, H, Sq), (torch.float32,), device)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must start on a 16-byte boundary")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((2, B, H, -(-Sq // 128) * 128), dtype=torch.float32,
                        device=device)
    lib = _build.load()
    raise_on(fn, lib, lib.repro_swa_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, Sq, Sk, H, KV, D,
        0 if window is None else int(window), int(causal), float(D ** -0.5),
        DTYPE_CODE[q.dtype], stream_of(device)))
    launches += 1
    return dq, dk, dv
