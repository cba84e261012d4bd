"""Phi-4-mini 3.8B [arXiv:2412.08905] — RoPE + SwiGLU + GQA, tied embeddings."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="phi4-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=200064,
        activation="swiglu",
        tie_embeddings=True,
        rope_theta=10_000.0,
        source="arXiv:2412.08905",
    )
)
