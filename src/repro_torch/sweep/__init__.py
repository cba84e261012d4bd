"""repro_torch.sweep — the batched multi-seed / multi-hyperparameter engine
(``repro.sweep``).

Runs many full federated training runs as ONE batched run per static point:
the seed axis and value-only hyperparameters (eta, decay lambda, consensus
eps, per-agent tau_i schedules at fixed tau, fleet hetero_scale) form a
leading run axis S — the driver's flat ``(m, n)`` carry becomes ``(S, m,
n)``, the strategies' tables gain a run axis, and every aggregation kernel
takes all S runs in one launch — while shape-changing statics (tau itself,
topology, scenario, compression) loop outside.

    from repro_torch.sweep import SweepAxis, SweepSpec, run_sweep

    spec = SweepSpec(
        name="fig5",
        base=FedRLConfig(env=FIGURE_EIGHT, strategy=decay_strategy, ...),
        seeds=(0, 1, 2, 3),
        vmapped=(SweepAxis("lam", (0.98, 0.95, 0.92)),),
    )
    result = run_sweep(spec, device="cpu")  # one batched run; default cuda
    mean, hw = result.seed_mean_ci("base", "server_grad_sq_norm")
    result.save("experiments/sweeps")       # torch_fig5.v<N>.json + .csv
"""
from repro_torch.sweep.overrides import (
    OVERRIDES,
    algebraic_connectivity_axis,
    apply_overrides,
    compression_axis,
    override_delay,
    override_eps,
    override_eta,
    override_hetero_scale,
    override_k,
    override_lam,
    override_taus,
    register_override,
)
from repro_torch.sweep.results import SweepResult, mean_ci, t_critical
from repro_torch.sweep.runner import run_sweep, run_sweep_loop, static_points
from repro_torch.sweep.spec import StaticAxis, SweepAxis, SweepSpec

__all__ = [
    "OVERRIDES",
    "StaticAxis",
    "SweepAxis",
    "SweepSpec",
    "SweepResult",
    "algebraic_connectivity_axis",
    "apply_overrides",
    "compression_axis",
    "mean_ci",
    "override_delay",
    "override_eps",
    "override_eta",
    "override_hetero_scale",
    "override_k",
    "override_lam",
    "override_taus",
    "register_override",
    "run_sweep",
    "run_sweep_loop",
    "static_points",
    "t_critical",
]
