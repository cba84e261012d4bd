"""Paper Fig. 4 on the port: convergence (NAS) of variation-aware periodic
averaging (``benchmarks/fig4_variation.py`` on ``repro_torch``).

  PYTHONPATH=src:. python benchmarks/torch_fig4_variation.py [--quick]
      [--seeds N] [--device cpu]

The same configs, axes and ``--quick`` geometry as the JAX bench: at fixed
period length tau=15 the per-agent tau_i schedules are a batched ``taus``
axis (each run's ``(m, tau)`` mask, stacked ``(S, m, tau)``), so the whole
(schedules x seeds) grid runs as ONE batched run; tau=1 (sync) and tau=10
change the period length and stay static points. Seeds 0.. through
``TorchDraws``. Artifacts: ``experiments/bench/torch_fig4_variation.csv``
(JAX's columns), ``torch_fig4_sweep.json`` (curves, summary, the batched run
against the loop of one-run calls, the taus axis against static-mask runs,
the card's name and power limit) and ``experiments/sweeps/
torch_fig4_variation.v<N>``.
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
    strategy_axis,
    sweep_config_rows,
    write_bench_json,
    write_csv,
)
from benchmarks.torch_fmarl_bench import make_cfg  # noqa: E402
from repro_torch.core import make_strategy, uniform_taus  # noqa: E402
from repro_torch.core.variation import validate_a2  # noqa: E402
from repro_torch.rl import run_fedrl  # noqa: E402
from repro_torch.sweep import (  # noqa: E402
    SweepAxis,
    SweepSpec,
    mean_ci,
    run_sweep,
    run_sweep_loop,
)

TAU = 15


def _summarize(out, label, metrics, idx=None):
    """Seed-reduced curves + run-level summary for one plotted config."""
    entry, rows = sweep_config_rows(label, metrics, out["n_seeds"], idx=idx)
    out["curves"][label] = entry
    sel = (lambda a: a) if idx is None else (lambda a: a[idx])
    egn_m, egn_h = mean_ci(sel(metrics["server_grad_sq_norm"]).mean(-1), 0)
    out["summary"][label] = {
        "expected_grad_norm_mean": float(egn_m),
        "expected_grad_norm_ci_hw": float(egn_h),
        "final_nas_mean": float(np.asarray(entry["nas_mean"])[-3:].mean()),
    }
    return rows


def _static_parity(res_loop, schedules, seeds, epochs, device):
    """The taus axis's runs (the loop) against runs of a strategy built with
    each schedule statically (seed 0): the largest deviation."""
    max_dev = 0.0
    for i, (_, sched) in enumerate(schedules):
        strat = make_strategy("periodic", tau=TAU, taus=np.asarray(sched, int))
        _, ref, _ = run_fedrl(make_cfg(strat, epochs=epochs), seeds[0],
                              device=device)
        for k, arr in ref.items():
            dev = float(np.max(np.abs(res_loop.metrics["base"][k][i, 0]
                                      - arr)))
            max_dev = max(max_dev, dev)
    return max_dev


def run(quick: bool = False, seeds=None, device: str = "cuda") -> list:
    m = 7
    seeds = seed_tuple(seeds)
    epochs = 8 if quick else None

    statics = [
        ("tau=1", make_strategy("sync", m=m)),
        ("tau=10", make_strategy("periodic", tau=10, m=m)),
    ]
    schedules = [
        ("tau=15", tuple(float(TAU) for _ in range(m))),
        ("tau=10~15", tuple(map(float, uniform_taus(10, TAU, m, seed=0)))),
        ("tau=5~15", tuple(map(float, uniform_taus(5, TAU, m, seed=0)))),
        ("tau=1~15", tuple(map(float, uniform_taus(1, TAU, m, seed=0)))),
    ]
    if quick:
        statics = statics[:1]
        schedules = schedules[:2]
    for _, sched in schedules:
        validate_a2(np.asarray(sched, int), TAU)

    static_spec = SweepSpec(
        name="fig4_static_taus",
        base=make_cfg(statics[0][1], epochs=epochs),
        seeds=seeds,
        static=(strategy_axis("tau", statics),),
    )
    sched_spec = SweepSpec(
        name="fig4_variation",
        base=make_cfg(make_strategy("periodic", tau=TAU, m=m), epochs=epochs),
        seeds=seeds,
        vmapped=(SweepAxis("taus", tuple(s for _, s in schedules)),),
    )

    res_static = run_sweep(static_spec, device=device)
    res_sched = run_sweep(sched_spec, device=device)
    res_loop = run_sweep_loop(sched_spec, device=device)

    out = {
        "schema_version": 2,
        "quick": bool(quick),
        "device": device_line(device),
        "seeds": list(seeds),
        "n_seeds": len(seeds),
        "tau": TAU,
        "schedules": {lab: list(map(int, s)) for lab, s in schedules},
        "curves": {},
        "summary": {},
    }
    rows = []
    for label, _ in statics:
        rows += _summarize(out, label, res_static.metrics[label])
        emit(f"torch_fig4/{label}",
             res_static.wall_s[label] / len(seeds) * 1e6,
             f"final_nas={out['summary'][label]['final_nas_mean']:.4f}")
    per_run_us = res_sched.wall_s["base"] / sched_spec.n_runs * 1e6
    for i, (label, _) in enumerate(schedules):
        rows += _summarize(out, label, res_sched.metrics["base"], idx=i)
        emit(f"torch_fig4/{label}", per_run_us,
             f"final_nas={out['summary'][label]['final_nas_mean']:.4f}")

    max_dev_loop = max(
        float(np.max(np.abs(res_sched.metrics["base"][k]
                            - res_loop.metrics["base"][k])))
        for k in res_sched.metrics["base"]
    )
    out["timings"] = {
        "n_runs": sched_spec.n_runs,
        "vmapped_exec_s": res_sched.wall_s["base"],
        "vmapped_compile_s": res_sched.compile_s["base"],
        "loop_exec_s": res_loop.wall_s["base"],
        "loop_compile_s": res_loop.compile_s["base"],
        "vmapped_speedup": res_loop.wall_s["base"] / res_sched.wall_s["base"],
        "max_abs_dev_vs_loop": max_dev_loop,
        "runs_per_s": sched_spec.n_runs / res_sched.wall_s["base"],
        "loop_runs_per_s": sched_spec.n_runs / res_loop.wall_s["base"],
    }
    emit("torch_fig4/sweep_vs_loop", res_sched.wall_s["base"] * 1e6,
         f"loop={res_loop.wall_s['base'] * 1e6:.0f}us "
         f"x{out['timings']['vmapped_speedup']:.2f} "
         f"max_dev={max_dev_loop:.3g}")
    out["variation"] = {"max_abs_dev_vs_static": _static_parity(
        res_loop, schedules, seeds, epochs, device)}
    emit("torch_fig4/taus_axis_vs_static", 0.0,
         f"dev={out['variation']['max_abs_dev_vs_static']:.3g}")

    write_bench_json("fig4_sweep", out)
    res_sched.save(SWEEP_DIR)
    write_csv("fig4_variation", rows)
    return rows


if __name__ == "__main__":
    args = bench_args(__doc__.splitlines()[0])
    run(args.quick, args.seeds, args.device)
