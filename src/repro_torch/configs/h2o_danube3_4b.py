"""H2O-Danube3-4B [arXiv:2401.16818] — llama+mistral mix with sliding-window attention."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(
    ModelConfig(
        name="h2o-danube-3-4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        head_dim=120,
        d_ff=10240,
        vocab_size=32000,
        activation="swiglu",
        sliding_window=4096,
        layer_pattern=("local",),   # mistral-style SWA everywhere -> sub-quadratic
        rope_theta=10_000.0,
        source="arXiv:2401.16818",
    )
)
