"""repro_torch.comm — byte-accurate payload transforms for the federated
links (the port of ``repro.comm``).

What is communicated (dense fp32, top-k sparsified, int8 / bf16 quantized
payloads, each with optional error feedback) is separate from how it is
aggregated (periodic averaging, decay weighting, consensus gossip).
:class:`PayloadTransform` encodes a flat ``(m, n)`` payload matrix and
reports its wire size in bytes; ``AggregationStrategy`` composes one in
through its ``comm`` field and ``CostLedger`` prices every event with
``payload_bytes``.
"""
from repro_torch.comm.transforms import (
    IDENTITY,
    KINDS,
    PayloadTransform,
    dequantize_int8,
    identity,
    qbf16,
    qint8,
    quantize_int8,
    topk,
    topk_threshold,
)

__all__ = [
    "IDENTITY",
    "KINDS",
    "PayloadTransform",
    "dequantize_int8",
    "identity",
    "qbf16",
    "qint8",
    "quantize_int8",
    "topk",
    "topk_threshold",
]
