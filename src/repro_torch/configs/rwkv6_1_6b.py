"""RWKV6 'Finch' 1.6B [arXiv:2404.05892] — attention-free, data-dependent decay."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=32,           # wkv heads = d_model / wkv_head_dim
        n_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab_size=65536,
        layer_pattern=("wkv",),
        wkv_head_dim=64,
        decay_lora_rank=64,
        pos_emb="none",
        norm="layernorm",
        source="arXiv:2404.05892",
    )
)
