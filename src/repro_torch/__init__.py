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
  (``repro_torch.kernels``);
* consensus gossip and compressed payloads (``repro_torch.core``,
  ``repro_torch.comm``) through the ``consensus_step``,
  ``consensus_gather`` and ``topk_scatter`` kernels;
* language-model serving: ``rwkv6-1.6b`` (``repro_torch.configs``,
  ``repro_torch.models``) through ``repro_torch.launch`` (prefill and serve
  steps, the ``ServingLoop``), with the recurrence in the ``wkv6`` kernel;
  ``h2o-danube-3-4b`` with the ``swa_attention`` kernel;
* batched sweeps (``repro_torch.sweep``) and asynchronous federation
  (``repro_torch.core.async_fed``);
* the paper's task-generic driver ``repro_torch.core.run_fmarl``
  (Algorithms 1 and 2), its closed-form bounds (``repro_torch.core.bounds``)
  and the hierarchical, quantised-sync and elastic strategies
  (``repro_torch.core.extensions``).

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
