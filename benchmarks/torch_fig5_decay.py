"""Paper Fig. 5 on the port: the decay-based method (DIRL), a lambda sweep at
tau=1~15 (``benchmarks/fig5_decay.py`` on ``repro_torch``).

  PYTHONPATH=src:. python benchmarks/torch_fig5_decay.py [--quick]
      [--seeds N] [--device cpu]

The same configs, axes and ``--quick`` geometry as the JAX bench: the decay
constant lambda and the seeds batch into ONE run (each run's ``(tau,)``
decay table, stacked per run), beside the no-decay periodic base; curves are
seed-averaged with t-based confidence intervals and carry the ledger's
cumulative wire bytes (``fedrl_bytes_curve``). Seeds 0.. through
``TorchDraws``. Artifacts: ``experiments/bench/torch_fig5_decay.csv`` (JAX's
columns), ``torch_fig5_sweep.json`` (also the loop of one-run calls over the
same grid: wall clock, runs/s, deviation; the card's name and power limit)
and ``experiments/sweeps/torch_fig5_decay.v<N>``.
"""
from __future__ import annotations

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "src")]

import numpy as np  # noqa: E402

from benchmarks.torch_common import (  # noqa: E402
    SWEEP_DIR,
    bench_args,
    device_line,
    emit,
    seed_tuple,
    sweep_config_rows,
    write_bench_json,
    write_csv,
)
from benchmarks.torch_fmarl_bench import make_cfg  # noqa: E402
from repro_torch.core import make_strategy, uniform_taus  # noqa: E402
from repro_torch.core.decay import exponential_decay  # noqa: E402
from repro_torch.rl.fedrl import fedrl_bytes_curve  # noqa: E402
from repro_torch.sweep import (  # noqa: E402
    SweepAxis,
    SweepSpec,
    mean_ci,
    run_sweep,
    run_sweep_loop,
)


def _curves(out, metrics, config, cfg, lam_idx=None):
    """Seed-reduced curves + run-level summary for one plotted config, on
    the ledger's cumulative wire-bytes axis."""
    entry, rows = sweep_config_rows(config, metrics, out["n_seeds"],
                                    idx=lam_idx)
    bytes_curve = fedrl_bytes_curve(cfg)
    entry["bytes"] = bytes_curve.tolist()
    for ep, row in enumerate(rows):
        row["bytes"] = float(bytes_curve[ep])
    out["curves"][config] = entry
    sel = (lambda a: a) if lam_idx is None else (lambda a: a[lam_idx])
    egn_m, egn_h = mean_ci(sel(metrics["server_grad_sq_norm"]).mean(-1), 0)
    out["summary"][config] = {
        "expected_grad_norm_mean": float(egn_m),
        "expected_grad_norm_ci_hw": float(egn_h),
        "final_nas_mean": float(np.asarray(entry["nas_mean"])[-3:].mean()),
        "total_bytes": float(bytes_curve[-1]),
    }
    return rows


def run(quick: bool = False, seeds=None, device: str = "cuda") -> list:
    m, tau = 7, 15
    seeds = seed_tuple(seeds)
    taus = uniform_taus(1, tau, m, seed=0)
    epochs = 8 if quick else None
    lams = (0.98, 0.92) if quick else (0.98, 0.95, 0.92)

    base_spec = SweepSpec(
        name="fig5_no_decay",
        base=make_cfg(make_strategy("periodic", tau=tau, taus=taus),
                      epochs=epochs),
        seeds=seeds,
    )
    decay_spec = SweepSpec(
        name="fig5_decay",
        base=make_cfg(
            make_strategy("decay", tau=tau, taus=taus,
                          decay=exponential_decay(lams[0])),
            epochs=epochs,
        ),
        seeds=seeds,
        vmapped=(SweepAxis("lam", lams),),
    )

    res_base = run_sweep(base_spec, device=device)
    res_decay = run_sweep(decay_spec, device=device)
    res_loop = run_sweep_loop(decay_spec, device=device)

    out = {
        "schema_version": 1,
        "quick": bool(quick),
        "device": device_line(device),
        "seeds": list(seeds),
        "n_seeds": len(seeds),
        "lams": list(lams),
        "curves": {},
        "summary": {},
    }
    rows = _curves(out, res_base.metrics["base"], "no-decay", base_spec.base)
    emit("torch_fig5/no-decay", res_base.wall_s["base"] / len(seeds) * 1e6,
         f"grad_norm={out['summary']['no-decay']['expected_grad_norm_mean']:.4f}"
         f"+-{out['summary']['no-decay']['expected_grad_norm_ci_hw']:.4f}")
    per_run_us = res_decay.wall_s["base"] / decay_spec.n_runs * 1e6
    for i, lam in enumerate(lams):
        config = f"lambda={lam}"
        rows += _curves(out, res_decay.metrics["base"], config,
                        decay_spec.base, lam_idx=i)
        s = out["summary"][config]
        emit(f"torch_fig5/{config}", per_run_us,
             f"grad_norm={s['expected_grad_norm_mean']:.4f}"
             f"+-{s['expected_grad_norm_ci_hw']:.4f}")

    max_dev = max(
        float(np.max(np.abs(res_decay.metrics["base"][k]
                            - res_loop.metrics["base"][k])))
        for k in res_decay.metrics["base"]
    )
    out["timings"] = {
        "n_runs": decay_spec.n_runs,
        "vmapped_exec_s": res_decay.wall_s["base"],
        "vmapped_compile_s": res_decay.compile_s["base"],
        "loop_exec_s": res_loop.wall_s["base"],
        "loop_compile_s": res_loop.compile_s["base"],
        "vmapped_speedup": res_loop.wall_s["base"] / res_decay.wall_s["base"],
        "max_abs_dev_vs_loop": max_dev,
        "runs_per_s": decay_spec.n_runs / res_decay.wall_s["base"],
        "loop_runs_per_s": decay_spec.n_runs / res_loop.wall_s["base"],
    }
    emit("torch_fig5/sweep_vs_loop", res_decay.wall_s["base"] * 1e6,
         f"loop={res_loop.wall_s['base'] * 1e6:.0f}us "
         f"x{out['timings']['vmapped_speedup']:.2f} max_dev={max_dev:.3g}")

    write_bench_json("fig5_sweep", out)
    res_decay.save(SWEEP_DIR)
    write_csv("fig5_decay", rows)
    return rows


if __name__ == "__main__":
    args = bench_args(__doc__.splitlines()[0])
    run(args.quick, args.seeds, args.device)
