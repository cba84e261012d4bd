"""Architecture configs of the port (``repro.configs``).

``ModelConfig`` and the registries are copies of the JAX package's. Only the
configurations whose model the port runs are registered: ``rwkv6-1.6b``
(slice 4), ``h2o-danube-3-4b`` and ``phi4-mini-3.8b`` (slice 5),
``gemma-7b`` and ``recurrentgemma-9b`` (slice 15: head size 256, the
``rglru`` block and a mixed layer pattern), ``whisper-small`` (slice 18:
the encoder-decoder at head size 64), ``kimi-k2-1t-a32b`` and
``arctic-480b`` (slice 20: the MoE FFN, ``models/moe.py``),
``internvl2-26b`` (slice 21: the VLM embedding prefix and its projector)
and ``qwen2-72b`` (slice 21: QKV bias at d 8192). With them the port
registers every configuration of the JAX package.
"""
from repro_torch.configs.base import (
    ARCH_REGISTRY,
    InputShape,
    ModelConfig,
    SHAPE_REGISTRY,
    get_arch,
    get_shape,
    list_archs,
    register_arch,
)

# Import for registration side effects.
from repro_torch.configs import arctic_480b  # noqa: F401
from repro_torch.configs import gemma_7b  # noqa: F401
from repro_torch.configs import h2o_danube3_4b  # noqa: F401
from repro_torch.configs import internvl2_26b  # noqa: F401
from repro_torch.configs import kimi_k2_1t  # noqa: F401
from repro_torch.configs import phi4_mini_3_8b  # noqa: F401
from repro_torch.configs import qwen2_72b  # noqa: F401
from repro_torch.configs import recurrentgemma_9b  # noqa: F401
from repro_torch.configs import rwkv6_1_6b  # noqa: F401
from repro_torch.configs import whisper_small  # noqa: F401

__all__ = [
    "ARCH_REGISTRY",
    "InputShape",
    "ModelConfig",
    "SHAPE_REGISTRY",
    "get_arch",
    "get_shape",
    "list_archs",
    "register_arch",
]
