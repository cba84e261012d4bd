"""Gemma-7B [arXiv:2403.08295] — GeGLU, head_dim=256, tied embeddings."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="gemma-7b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        activation="geglu",
        tie_embeddings=True,
        rope_theta=10_000.0,
        source="arXiv:2403.08295",
    )
)
