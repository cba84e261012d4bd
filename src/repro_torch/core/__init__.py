"""Host-side core of the port (``repro.core``): variation schedules, decay
families, the cost ledger and the synchronous aggregation strategies."""
from repro_torch.core.accounting import CostLedger
from repro_torch.core.decay import (
    cosine_decay,
    decay_sq_prefix_sum,
    exponential_decay,
    linear_decay,
    no_decay,
    step_decay,
)
from repro_torch.core.strategies import (
    AggregationStrategy,
    DecayStrategy,
    PeriodicStrategy,
    SyncStrategy,
    make_strategy,
)
from repro_torch.core.variation import (
    indicator_mask,
    mask_from_taus,
    masked_update_counts,
    tau_schedule,
    tau_stats,
    uniform_taus,
    validate_a2,
)

__all__ = [
    "AggregationStrategy",
    "CostLedger",
    "DecayStrategy",
    "PeriodicStrategy",
    "SyncStrategy",
    "cosine_decay",
    "decay_sq_prefix_sum",
    "exponential_decay",
    "indicator_mask",
    "linear_decay",
    "make_strategy",
    "mask_from_taus",
    "masked_update_counts",
    "no_decay",
    "step_decay",
    "tau_schedule",
    "tau_stats",
    "uniform_taus",
    "validate_a2",
]
