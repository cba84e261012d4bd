"""Whisper-small [arXiv:2212.04356] — enc-dec audio; conv/mel frontend is a stub."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="whisper-small",
        family="audio",
        n_layers=12,            # decoder layers
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        activation="gelu",
        norm="layernorm",
        qkv_bias=True,
        pos_emb="sinusoidal",
        is_encoder_decoder=True,
        n_encoder_layers=12,
        frontend="audio",
        n_frontend_tokens=1500,  # mel frames after the conv stub (30 s @ 50 Hz)
        source="arXiv:2212.04356",
    )
)
