"""Language models of the port (``repro.models``): the decoder LM with
RWKV6 ``wkv`` blocks (slice 4), sliding-window attention (slice 5), its
training loss (slice 13), the Griffin ``rglru`` block with mixed layer
patterns at head size 256 (slice 15), and the whisper encoder-decoder
(slice 18, serving; slice 19, training)."""
from repro_torch.models.encdec import (
    encdec_decode_step,
    encdec_forward,
    encdec_loss,
    encode,
    init_encdec_decode_state,
)
from repro_torch.models.transformer import (
    chunked_cross_entropy,
    count_params,
    decode_step,
    forward,
    init_decode_state,
    init_params,
    layer_plan,
    lm_head,
    lm_loss,
    padded_vocab,
    param_shapes,
    params_from_jax,
    prefill,
    sharded_cross_entropy,
)

__all__ = [
    "chunked_cross_entropy",
    "count_params",
    "decode_step",
    "encdec_decode_step",
    "encdec_forward",
    "encdec_loss",
    "encode",
    "forward",
    "init_decode_state",
    "init_encdec_decode_state",
    "init_params",
    "layer_plan",
    "lm_head",
    "lm_loss",
    "padded_vocab",
    "param_shapes",
    "params_from_jax",
    "prefill",
    "sharded_cross_entropy",
]
