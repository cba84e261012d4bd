"""Policy-serving engine: bucketed batches + micro-batching queue.

The port of ``repro.serve``, with the same public surface:

- :class:`~repro_torch.serve.engine.ServeEngine` — bucketed policy-forward
  engine (one build and one warm-up launch per bucket at construction, the
  actions written into the device noise buffer on the hot path).
- :class:`~repro_torch.serve.engine.ObsNorm` /
  :func:`~repro_torch.serve.engine.save_for_serving` — observation
  normalization stats and the checkpoint writer twin of
  ``ServeEngine.from_checkpoint``.
- :class:`~repro_torch.serve.queue.MicroBatchQueue` /
  :class:`~repro_torch.serve.queue.ObsRequest` — arrival-order request
  coalescing into bucket-shaped batches.
- :func:`~repro_torch.serve.queue.poisson_arrivals` /
  :func:`~repro_torch.serve.queue.simulate_clients` — seeded open-loop
  client schedules.
"""
from repro_torch.serve.engine import (
    DEFAULT_BUCKETS,
    ObsNorm,
    ServeEngine,
    save_for_serving,
)
from repro_torch.serve.queue import (
    MicroBatchQueue,
    ObsRequest,
    poisson_arrivals,
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
