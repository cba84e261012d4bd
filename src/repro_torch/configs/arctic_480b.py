"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base] — 128e top-2 MoE + dense residual."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,              # dense-residual MLP width
        vocab_size=32000,
        activation="swiglu",
        n_experts=128,
        top_k=2,
        expert_d_ff=4864,
        dense_residual=True,    # dense MLP in parallel with the MoE FFN
        capacity_factor=1.25,
        rope_theta=10_000.0,
        source="hf:Snowflake/snowflake-arctic-base",
    )
)
