"""PyTorch port of the JAX package ``repro``, for an NVIDIA H100.

The JAX package stays the reference; this package mirrors its subpackage
names and imports neither ``jax`` nor ``repro``. Ported so far: the
policy-serving path (``repro_torch.serve``) with its hand-written Hopper
kernel (``repro_torch.kernels``), the policy head (``repro_torch.rl``) and
the checkpoint format (``repro_torch.checkpoint``). Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
from repro_torch.serve import (
    DEFAULT_BUCKETS,
    MicroBatchQueue,
    ObsNorm,
    ObsRequest,
    ServeEngine,
    poisson_arrivals,
    save_for_serving,
    simulate_clients,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "MicroBatchQueue",
    "ObsNorm",
    "ObsRequest",
    "ServeEngine",
    "poisson_arrivals",
    "save_for_serving",
    "simulate_clients",
]
