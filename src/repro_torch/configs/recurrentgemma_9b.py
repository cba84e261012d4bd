"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427] — RG-LRU + local attention, 2:1."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,          # MQA on the local-attention blocks
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        activation="geglu",
        layer_pattern=("rglru", "rglru", "local"),  # 1 attn : 2 recurrent
        sliding_window=2048,
        lru_width=4096,
        conv_width=4,
        tie_embeddings=True,
        source="arXiv:2402.19427",
    )
)
