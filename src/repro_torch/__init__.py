"""PyTorch port of the JAX package ``repro``, for an NVIDIA H100.

The JAX package stays the reference; this package mirrors its subpackage
names and imports neither ``jax`` nor ``repro``. Ported so far:

* serving (``repro_torch.serve``) through the hand-written ``policy_infer``
  kernel, with the checkpoint format (``repro_torch.checkpoint``);
* training: federated PPO (``repro_torch.rl.run_fedrl``) with the sync,
  periodic and decay strategies (``repro_torch.core``) and the flat SGD,
  momentum and Adam optimizers (``repro_torch.optim``), whose local steps
  and server averages run the hand-written ``decay_accum``,
  ``momentum_update``, ``adam_update`` and ``row_mean`` kernels
  (``repro_torch.kernels``).

Entry points run on the card unless the caller passes ``device="cpu"``.
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
