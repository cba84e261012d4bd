"""Language models of the port (``repro.models``): the decoder LM with
RWKV6 ``wkv`` blocks (slice 4)."""
from repro_torch.models.transformer import (
    count_params,
    decode_step,
    forward,
    init_decode_state,
    init_params,
    layer_plan,
    lm_head,
    padded_vocab,
    param_shapes,
    params_from_jax,
    prefill,
)

__all__ = [
    "count_params",
    "decode_step",
    "forward",
    "init_decode_state",
    "init_params",
    "layer_plan",
    "lm_head",
    "padded_vocab",
    "param_shapes",
    "params_from_jax",
    "prefill",
]
