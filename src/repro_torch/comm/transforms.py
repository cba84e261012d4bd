"""Payload transforms: what crosses the federated links, in bytes.

The port of ``repro.comm.transforms``. A :class:`PayloadTransform` is a
frozen hashable spec of the lossy encoding applied to a flat ``(m, n)``
payload matrix before it is communicated: uplink deltas at the period sync,
gossip payloads on the consensus path. Four kinds:

* ``identity`` — dense fp32; 4n bytes per event (the default: strategies
  with it behave exactly as without a transform);
* ``topk`` — per-agent top-k magnitude sparsification in threshold form:
  keep every entry with ``|x| >= kth largest |x|`` of its row (ties at the
  threshold all kept); 8k bytes per event ((value, index) pairs);
* ``int8`` — symmetric per-row quantization, ``s = max|x| / 127``,
  ``q = round(x / s)`` in [-127, 127]; n + 4 bytes per event;
* ``bf16`` — a round trip through bfloat16; 2n bytes per event.

Error feedback: ``encode`` returns ``(sent, residual)`` with ``sent +
residual == x`` exactly in fp32; the strategies fold the previous residual
into the next payload and keep the new one as ``(m, n)`` fp32 state.

``reduce_mean`` is the compressed server reduction: the fp32 mean over
agents of the encoded payloads. Top-k runs the fused ``topk_scatter``
kernel on the card (``repro_torch.kernels.dispatch.topk_scatter``); int8 and
bf16 dequantize and ``row_mean``.

Divisions are by 0-d tensors on the payload's device, never by Python
numbers: on the card torch turns ``x / python_float`` into a multiplication
by the reciprocal, which would make the card's payloads differ from the
CPU's (and the JAX package's).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.kernels import dispatch

KINDS = ("identity", "topk", "int8", "bf16")


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def topk_threshold(x: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row top-k magnitude threshold: the k-th largest ``|x|`` of each
    row of ``x`` ``(..., n)``; an entry is kept iff ``|x| >= threshold``."""
    n = x.shape[-1]
    if not 1 <= k <= n:
        raise ValueError(f"topk_threshold: need 1 <= k <= {n}, got k={k}")
    return torch.topk(x.abs(), k, dim=-1).values[..., -1].contiguous()


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization: ``(q, scale)``.

    ``scale = max|x| / 127`` per row; ``q = round(x / scale)`` (half to
    even, as ``jnp.round``) clamped to [-127, 127]; an all-zero row
    quantizes through a safe unit scale to q = 0.
    """
    x = x.to(torch.float32)
    amax = torch.amax(x.abs(), dim=-1)
    scale = amax / _scalar(127.0, x)
    safe = torch.where(scale > 0, scale, _scalar(1.0, x))
    q = torch.clamp(torch.round(x / safe[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 reconstruction of a per-row-quantized payload."""
    return q.to(torch.float32) * scale.to(torch.float32)[..., None]


@dataclasses.dataclass(frozen=True)
class PayloadTransform:
    """Frozen spec of one link compression scheme.

    ``k`` is the top-k count; ``error_feedback`` adds the per-agent fp32
    residual accumulators to the strategy's comm state.
    """

    kind: str = "identity"
    k: int = 0
    error_feedback: bool = True

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown payload transform kind {self.kind!r}; expected one "
                f"of {KINDS}"
            )
        if self.kind == "topk":
            if self.k < 1:
                raise ValueError(f"topk transform needs k >= 1, got {self.k}")
        elif self.k:
            raise ValueError(f"k only applies to the topk kind, got k={self.k}")

    @property
    def enabled(self) -> bool:
        """True when the transform actually changes the payload."""
        return self.kind != "identity"

    @property
    def label(self) -> str:
        if self.kind == "identity":
            return "dense"
        if self.kind == "topk":
            return f"topk{self.k}"
        return self.kind

    # --- bytes accounting ------------------------------------------------------
    def payload_bytes(self, n: int) -> int:
        """Wire bytes of ONE encoded n-element payload: identity 4n, topk 8k
        (nominal k), int8 n + 4, bf16 2n."""
        n = int(n)
        if n < 0:
            raise ValueError(f"payload_bytes: n must be >= 0, got {n}")
        if self.kind == "identity":
            return 4 * n
        if self.kind == "topk":
            return 8 * min(self.k, n)
        if self.kind == "int8":
            return n + 4
        return 2 * n

    # --- encoding --------------------------------------------------------------
    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encode/decode round trip of an ``(m, n)`` payload matrix:
        ``(sent, residual)`` in fp32 with ``residual = x - sent``. Callers
        fold the previous error-feedback residual in before encoding."""
        x = x.to(torch.float32)
        if self.kind == "identity":
            return x, torch.zeros_like(x)
        if self.kind == "topk":
            thresh = topk_threshold(x, self.k)
            sent = torch.where(x.abs() >= thresh[..., None], x, 0.0)
        elif self.kind == "int8":
            sent = dequantize_int8(*quantize_int8(x))
        else:  # bf16
            sent = x.to(torch.bfloat16).to(torch.float32)
        return sent, x - sent

    def reduce_mean(self, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Compressed server reduction: ``(mean over agents, residual)``.

        Each agent's row of ``x`` is encoded and the server averages the
        reconstructions in fp32: top-k through the fused ``topk_scatter``
        (the dense ``sent`` matrix never exists), int8 / bf16 by dequantizing
        and ``row_mean``.
        """
        x = x.to(torch.float32)
        m = x.shape[-2]
        if self.kind == "topk":
            thresh = topk_threshold(x, self.k)
            ssum, residual = dispatch.topk_scatter(x, thresh)
            return ssum / _scalar(float(m), ssum), residual
        sent, residual = self.encode(x)
        return dispatch.row_mean(sent), residual


IDENTITY = PayloadTransform("identity", error_feedback=False)


def identity() -> PayloadTransform:
    """The dense fp32 no-op transform (byte accounting still applies)."""
    return IDENTITY


def topk(k: int, error_feedback: bool = True) -> PayloadTransform:
    """Top-k magnitude sparsification of each agent's payload row."""
    return PayloadTransform("topk", k=int(k), error_feedback=error_feedback)


def qint8(error_feedback: bool = True) -> PayloadTransform:
    """Symmetric per-row int8 quantization (n + 4 bytes per event)."""
    return PayloadTransform("int8", error_feedback=error_feedback)


def qbf16(error_feedback: bool = True) -> PayloadTransform:
    """bfloat16 round trip (2n bytes per event)."""
    return PayloadTransform("bf16", error_feedback=error_feedback)
