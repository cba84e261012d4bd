"""Unified architecture config schema + registries for archs and input shapes.

The port's own copy of ``repro.configs.base``: the same fields, defaults,
checks and ``reduced()`` variant, so a configuration built here equals the
JAX package's field for field. ``n_params()`` is copied as it is, including
its miscount of RWKV blocks (it counts 4·d² for the time-mix projections
where there are 5, and a SwiGLU FFN where the channel-mix has 2·d·d_ff +
d²); count the parameters of a model from its tree instead.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    source: str = ""               # paper / model-card citation

    activation: str = "swiglu"     # swiglu | geglu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    pos_emb: str = "rope"          # rope | sinusoidal | none
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None   # SWA window for 'local' layers
    layer_pattern: Tuple[str, ...] = ("attn",)  # cycled: attn|local|rglru|wkv

    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0         # leading dense FFN layers (e.g. kimi-k2)
    dense_residual: bool = False   # parallel dense MLP next to MoE (arctic)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_group_size: int = 4096     # dispatch-einsum group size (perf knob:
                                   # dispatch FLOPs/token scale linearly with it)

    # SSM / recurrent
    wkv_impl: str = "scan"         # scan (baseline) | chunked (matmul-form, §Perf)
    wkv_chunk: int = 64
    wkv_head_dim: int = 64
    decay_lora_rank: int = 64      # rwkv6 data-dependent decay low-rank
    lru_width: int = 0             # rg-lru recurrence width (0 -> d_model)
    conv_width: int = 4

    # Modality frontend stubs (vlm/audio): input_specs() provides embeddings
    frontend: Optional[str] = None  # vision | audio
    n_frontend_tokens: int = 0

    # Encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # Implementation knobs
    attn_impl: str = "flash"       # flash (custom-vjp) | chunked | einsum (oracle)
    attn_chunk: int = 512
    ce_chunks: int = 16            # chunked-CE batch chunks (0 = materialize logits)
    cache_update: str = "scatter"  # scatter | onehot (sharded-window-friendly)
    scan_layers: bool = True
    remat: bool = True
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.family == "moe" and (self.n_experts < 2 or self.top_k < 1):
            raise ValueError("moe family needs n_experts>=2, top_k>=1")
        for blk in self.layer_pattern:
            if blk not in ("attn", "local", "rglru", "wkv"):
                raise ValueError(f"unknown block kind {blk}")
        if "local" in self.layer_pattern and not self.sliding_window:
            raise ValueError("'local' blocks need a sliding_window")

    # ------------------------------------------------------------------
    @property
    def lru_dim(self) -> int:
        return self.lru_width or self.d_model

    @property
    def is_subquadratic(self) -> bool:
        """True if no block attends to unbounded context (long_500k eligible)."""
        return all(b != "attn" for b in self.layer_pattern)

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    def block_kind(self, layer_idx: int) -> str:
        return self.layer_pattern[layer_idx % len(self.layer_pattern)]

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6ND roofline."""
        d, hd = self.d_model, self.head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        n_dec = self.n_layers
        for i in range(n_dec):
            kind = self.block_kind(i)
            if kind in ("attn", "local"):
                attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
                if self.qkv_bias:
                    attn += hd * (self.n_heads + 2 * self.n_kv_heads)
            elif kind == "rglru":
                w = self.lru_dim
                attn = 2 * d * w + w * d + self.conv_width * w + 3 * w
            else:  # wkv
                attn = 4 * d * d + 2 * d * self.decay_lora_rank + 2 * d
            total += attn
            # FFN
            n_in = 2 if self.activation in ("swiglu", "geglu") else 1
            if self.family == "moe" and i >= self.first_k_dense:
                ff = self.n_experts * (n_in * d * self.expert_d_ff + self.expert_d_ff * d)
                ff += d * self.n_experts  # router
                ff += self.n_shared_experts * (n_in * d * self.expert_d_ff + self.expert_d_ff * d)
                if self.dense_residual:
                    ff += n_in * d * self.d_ff + self.d_ff * d
            else:
                ff = n_in * d * self.d_ff + self.d_ff * d
            total += ff + 2 * d  # norms
        if self.is_encoder_decoder:
            for _ in range(self.n_encoder_layers):
                attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
                ff = d * self.d_ff + self.d_ff * d
                total += attn + ff + 2 * d
            # decoder cross-attention
            total += n_dec * (d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d + d)
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k instead of all experts)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        n_in = 2 if self.activation in ("swiglu", "geglu") else 1
        per_expert = n_in * d * self.expert_d_ff + self.expert_d_ff * d
        n_moe_layers = self.n_layers - self.first_k_dense
        inactive = n_moe_layers * (self.n_experts - self.top_k) * per_expert
        return self.n_params() - inactive

    def reduced(self) -> "ModelConfig":
        """CPU smoke variant: same family/pattern, tiny dims."""
        d = min(self.d_model, 128)
        heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        pat = self.layer_pattern
        n_layers = max(2, len(pat)) if len(pat) > 1 else 2
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=32,
            d_ff=min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            # no-drop regime for correctness tests: capacity drops make
            # prefill(S) vs forward(S+1) legitimately diverge (capacity binds
            # per sequence length); production keeps the real factor.
            capacity_factor=max(self.capacity_factor, 4.0),
            expert_d_ff=min(self.expert_d_ff, 128) if self.expert_d_ff else 0,
            first_k_dense=min(self.first_k_dense, 1),
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else None,
            lru_width=min(self.lru_dim, 128) if self.lru_width else 0,
            decay_lora_rank=16,
            n_frontend_tokens=min(self.n_frontend_tokens, 8) if self.n_frontend_tokens else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2) if self.n_encoder_layers else 0,
            attn_chunk=8,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPE_REGISTRY = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

ARCH_REGISTRY: dict[str, ModelConfig] = {}


def register_arch(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in ARCH_REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]


def get_shape(name: str) -> InputShape:
    return SHAPE_REGISTRY[name]


def list_archs() -> list[str]:
    return sorted(ARCH_REGISTRY)
