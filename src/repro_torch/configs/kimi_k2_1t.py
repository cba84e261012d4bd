"""Kimi K2 1T-A32B [arXiv:2501.kimi2] — trillion-param MoE, 384 experts top-8."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=18432,            # dense (first_k_dense) FFN width
        vocab_size=163840,
        activation="swiglu",
        n_experts=384,
        top_k=8,
        expert_d_ff=2048,
        n_shared_experts=1,
        first_k_dense=1,
        capacity_factor=1.25,
        rope_theta=50_000.0,
        source="arXiv:2501.kimi2 (paper-table)",
    )
)
