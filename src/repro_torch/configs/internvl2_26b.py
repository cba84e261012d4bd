"""InternVL2-26B [arXiv:2404.16821] — InternViT (stub frontend) + InternLM2 backbone."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="internvl2-26b",
        family="vlm",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92553,       # padded to a multiple of 128 by padded_vocab
        activation="swiglu",
        frontend="vision",
        n_frontend_tokens=256,  # IMG context tokens per image (pixel-shuffled ViT patches)
        rope_theta=1_000_000.0,
        source="arXiv:2404.16821",
    )
)
