"""Causal attention with an optional sliding window, flash-style.

The port of the Pallas TPU kernel ``swa_attention_pallas``
(``src/repro/kernels/swa_attention.py:80``). For each batch row and head,
with query and key positions both counted from 0:

    s = (q . k^T) * D^-1/2                       in fp32
    s = -1e30 where (causal and j > i) or (window and j <= i - window)
    o = softmax(s) @ v                           p kept in fp32 for p @ v

* :func:`swa_attention_cuda` wraps the hand-written Hopper kernels of
  ``csrc/swa_attention.cu`` (one launch on the current stream, no
  synchronisation; launches counted in :data:`launches`): bf16 on the
  tensor cores (wgmma, TMA loads into a K/V ring, ``p`` as bf16 ``p_hi +
  p_lo``), fp32 on the CUDA cores, chosen by dtype. They take head sizes
  :data:`HEAD_DIMS`, any lengths, and visit only the key tiles inside each
  query tile's window;
* :func:`swa_attention_plain` is the same function in plain PyTorch: the
  masked scores materialised in fp32 (float64 for float64 inputs), softmax,
  p @ v, cast to ``q``'s dtype. The CPU path runs it; on the card it is
  only the reference the kernel is held against.

Both return, when asked (``with_lse``), the fp32 log-sum-exp of each
query row's masked scores, ``(B, H, Sq)``: the residual of the JAX
package's ``_flash_fwd`` (``models/attention.py:219-221``) that the
backward (``kernels/swa_attention_bwd.py``) reads.

Unlike the TPU kernel, ``k`` and ``v`` come un-repeated, ``(B, Sk, KV, D)``:
head h reads KV head ``h // (H // KV)``, the JAX package's ``_repeat_kv``
mapping. That is the TPU kernel's function on the repeated K/V, without a
copy of it. Callers go through :func:`repro_torch.kernels.dispatch
.swa_attention`. The library yardstick timed beside the kernel (never
called here) is ``torch.nn.functional.scaled_dot_product_attention``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decay_accum import check_buffer, raise_on, stream_of

HEAD_DIMS = (64, 120, 128, 256)   # the head sizes the kernels take
NEG_INF = -1e30
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0               # kernel launches made by swa_attention_cuda


def check_shapes(fn: str, q, k, v, window, causal
                 ) -> Tuple[int, int, int, int, int, int]:
    """``(B, Sq, Sk, H, KV, D)`` once ``q`` is ``(B, Sq, H, D)``, ``k`` and
    ``v`` are ``(B, Sk, KV, D)`` with H a multiple of KV, ``window`` is None
    or >= 1 and every query row has a key in its window; raises
    ``ValueError``."""
    if q.ndim != 4:
        raise ValueError(f"{fn}: q must be (B, Sq, H, D), got {tuple(q.shape)}")
    B, Sq, H, D = q.shape
    if k.ndim != 4 or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{fn}: k must be ({B}, Sk, KV, {D}), got "
                         f"{tuple(k.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"{fn}: v must match k {tuple(k.shape)}, got "
                         f"{tuple(v.shape)}")
    Sk, KV = k.shape[1], k.shape[2]
    if KV < 1 or H % KV:
        raise ValueError(f"{fn}: {H} query heads are not a multiple of {KV} "
                         f"KV heads")
    if Sk < 1:
        raise ValueError(f"{fn}: needs Sk >= 1, got {Sk}")
    if window is not None and (isinstance(window, bool)
                               or int(window) != window or window < 1):
        raise ValueError(f"{fn}: window must be None or an integer >= 1, got "
                         f"{window!r}")
    if causal not in (True, False):
        raise ValueError(f"{fn}: causal must be a bool, got {causal!r}")
    if window is not None and Sq >= Sk + window:
        raise ValueError(f"{fn}: query rows {Sk + window - 1}.. have no key in "
                         f"their window (Sq {Sq}, Sk {Sk}, window {window})")
    return B, Sq, Sk, H, KV, D


def swa_mask(Sq: int, Sk: int, window, causal, device) -> torch.Tensor:
    """``(Sq, Sk)`` bool: key j is seen by query i (positions from 0)."""
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Sk, device=device)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    return ok


def swa_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: Optional[int] = None, causal: bool = True,
                        with_lse: bool = False):
    """Plain version: per batch row and KV group, the masked scores
    materialised in fp32 (float64 for float64 inputs), softmax, p @ v, cast
    to ``q.dtype``. Looping over KV groups (the ``H // KV`` query heads that
    share one KV head) is ``_repeat_kv`` without the copy, and keeps the
    score tensor at ``H // KV`` heads. Writes nothing in place (autograd
    differentiates it as it is).

    With ``with_lse`` also returns the log-sum-exp of each row's masked
    scores, ``(B, H, Sq)`` in the score dtype: the residual of JAX's
    ``_flash_fwd`` (``m + log(l)``) that the backward reads.
    """
    B, Sq, Sk, H, KV, D = check_shapes("swa_attention_plain", q, k, v, window,
                                       causal)
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    rep = H // KV
    ok = swa_mask(Sq, Sk, window, causal, q.device)
    neg = torch.full((), NEG_INF, dtype=ct, device=q.device)
    scale = D ** -0.5
    outs, lses = [], []
    for b in range(B):
        o_b, l_b = [], []
        for g in range(KV):
            qg = q[b, :, g * rep:(g + 1) * rep].to(ct)          # (Sq, rep, D)
            kg, vg = k[b, :, g].to(ct), v[b, :, g].to(ct)       # (Sk, D)
            s = torch.where(ok, torch.einsum("shd,td->hst", qg, kg) * scale,
                            neg)
            o_b.append(torch.einsum("hst,td->shd", torch.softmax(s, dim=-1),
                                    vg).to(q.dtype))
            if with_lse:
                l_b.append(torch.logsumexp(s, dim=-1))          # (rep, Sq)
        outs.append(torch.cat(o_b, dim=1))
        if with_lse:
            lses.append(torch.cat(l_b, dim=0))
    out = torch.stack(outs)
    return (out, torch.stack(lses)) if with_lse else out


def swa_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       window: Optional[int] = None, causal: bool = True,
                       with_lse: bool = False):
    """Launch ``swa_attention_hopper_kernel`` (bf16) or
    ``swa_attention_kernel`` (fp32): returns ``o (B, Sq, H, D)`` in ``q``'s
    dtype, and with ``with_lse`` also ``lse (B, H, Sq)`` fp32, each row's
    log-sum-exp of its masked scores (the training forward saves it for
    the backward; serving passes a null pointer and the kernels skip the
    write).

    ``q`` is a contiguous ``(B, Sq, H, D)`` CUDA tensor, ``k`` and ``v``
    contiguous ``(B, Sk, KV, D)``, all fp32 or all bf16 on one device, D in
    :data:`HEAD_DIMS`, Sq >= 1; ``o`` and ``lse`` are allocated here.
    """
    global launches
    fn = "swa_attention_cuda"
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"{fn}: tensors must be on a CUDA device, got {device}")
    B, Sq, Sk, H, KV, D = check_shapes(fn, q, k, v, window, causal)
    if D not in HEAD_DIMS:
        raise ValueError(f"{fn}: the kernel takes head sizes {HEAD_DIMS}, got "
                         f"{D}")
    if Sq < 1:
        raise ValueError(f"{fn}: needs Sq >= 1, got {Sq}")
    dtypes = (q.dtype,) if q.dtype in DTYPE_CODE else tuple(DTYPE_CODE)
    check_buffer(fn, "q", q, q.shape, dtypes, device)
    check_buffer(fn, "k", k, k.shape, dtypes, device)
    check_buffer(fn, "v", v, k.shape, dtypes, device)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must start on a 16-byte boundary")
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=device)
           if with_lse else None)
    lib = _build.load()
    raise_on(fn, lib, lib.repro_swa_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Sq, Sk, H,
        KV, D, 0 if window is None else int(window), int(causal),
        float(D ** -0.5), DTYPE_CODE[q.dtype], stream_of(device)))
    launches += 1
    return (o, lse) if with_lse else o
