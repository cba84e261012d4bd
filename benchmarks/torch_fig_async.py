"""Async federation on the port: utility against bytes, synchronous VPA
against buffered FedBuff (``benchmarks/fig_async.py`` on ``repro_torch``).

  PYTHONPATH=src:. python benchmarks/torch_fig_async.py [--quick]
      [--seeds N] [--device cpu] [--eval-streams per-run]

The same geometry as the JAX bench (m = 7, tau = 15, the fig4 runs): the
synchronous baseline, and the four delay points (zero delay, a one-period
lag, geometric 0.5, heavy-tail 1.5) as ONE batched ``delay``-axis run of
(points x seeds). The delay process's uniforms are the JAX package's
(``experiments/bench/ref_fig_async_delay_uniforms.npy``, written by
``benchmarks/ref_fig_streams.py``) when their shape is this run's (m,
n_periods), so the arrivals, the ledger and every ``bytes`` entry are the
committed ``fig_async.csv``'s; otherwise the port's own
``delay_uniforms(eval_seed)``. Also records the batched run against the
loop of one-run calls and ``zero_delay_bitwise_dev``: a zero-delay async
run against the periodic run on the same draws (tau = 3, 2 epochs), which
must be exactly 0.0. Artifacts: ``experiments/bench/torch_fig_async.csv``
(JAX's columns), ``torch_fig_async.json`` and
``experiments/sweeps/torch_fig_async.v<N>``; ``--eval-streams per-run``
evaluates run s on its own stream (``eval_seed`` 5000 + s) and writes
``*.streams.*``.
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
    stream_run_fn,
    stream_suffix,
    sweep_config_rows,
    write_bench_json,
    write_csv,
)
from benchmarks.torch_fmarl_bench import make_cfg  # noqa: E402
from repro_torch.core import make_strategy  # noqa: E402
from repro_torch.core.async_fed import (  # noqa: E402
    DELAY_DISTRIBUTIONS,
    delay_uniforms,
    make_schedule,
)
from repro_torch.rl.fedrl import (  # noqa: E402
    fedrl_bytes_curve,
    fedrl_ledger,
    policy_payload_elems,
    run_fedrl,
)
from repro_torch.sweep import (  # noqa: E402
    SweepAxis,
    SweepSpec,
    mean_ci,
    run_sweep,
    run_sweep_loop,
)

M = 7
TAU = 15
DELAY_POINTS = (
    ("det0", "deterministic", 0.0),
    ("det1", "deterministic", 1.0),
    ("geom0.5", "geometric", 0.5),
    ("heavy1.5", "heavytail", 1.5),
)
JAX_UNIFORMS = os.path.join(_ROOT, "experiments", "bench",
                            "ref_fig_async_delay_uniforms.npy")


def delay_process_uniforms(n_periods: int, eval_seed: int):
    """``(uniforms, source)``: JAX's committed draws when they fit ``(M,
    n_periods)``, else the port's ``delay_uniforms(eval_seed)``."""
    if os.path.exists(JAX_UNIFORMS):
        u = np.load(JAX_UNIFORMS)
        if u.shape == (M, n_periods):
            return u.astype(np.float32), os.path.relpath(JAX_UNIFORMS, _ROOT)
    return delay_uniforms(eval_seed, M, n_periods), "delay_uniforms"


def zero_delay_bitwise(device) -> float:
    """Zero-delay async against periodic on the same draws (tau = 3, 2
    epochs, so boundaries fire): every weight and the correction factor
    are exactly 1.0, so the deviation must be exactly 0.0."""
    tau, epochs = 3, 2
    cfg_sync = make_cfg(make_strategy("periodic", tau=tau, m=M),
                        epochs=epochs)
    n_periods = epochs * cfg_sync.updates_per_epoch // tau
    sched = make_schedule("deterministic", 0.0, M, n_periods,
                          seed=cfg_sync.eval_seed)
    cfg_async = make_cfg(make_strategy("async", tau=tau, schedule=sched),
                         epochs=epochs)
    _, m_s, _ = run_fedrl(cfg_sync, 0, device=device)
    _, m_a, _ = run_fedrl(cfg_async, 0, device=device)
    return max(float(np.max(np.abs(m_a[k] - m_s[k]))) for k in m_s)


def run(quick: bool = False, seeds=None, device: str = "cuda",
        eval_streams: str = "shared") -> list:
    seeds = seed_tuple(seeds)
    epochs = 8 if quick else None
    sfx, run_fn = stream_suffix(eval_streams), stream_run_fn(eval_streams,
                                                               device)

    sync_cfg = make_cfg(make_strategy("periodic", tau=TAU, m=M),
                        epochs=epochs)
    n_periods = sync_cfg.n_epochs * sync_cfg.updates_per_epoch // TAU
    u, u_source = delay_process_uniforms(n_periods, sync_cfg.eval_seed)
    # the base carries the zero-delay schedule and the draws; each point of
    # the delay axis redraws its arrivals from them
    base_sched = make_schedule("deterministic", 0.0, M, n_periods,
                               uniforms=u)
    async_cfg = make_cfg(make_strategy("async", tau=TAU, schedule=base_sched),
                         epochs=epochs)

    res_sync = run_sweep(SweepSpec(name="fig_async_sync", base=sync_cfg,
                                   seeds=seeds, run_fn=run_fn), device=device)
    spec = SweepSpec(
        name=f"fig_async{sfx}", base=async_cfg, seeds=seeds,
        vmapped=(SweepAxis("delay", tuple(
            (float(DELAY_DISTRIBUTIONS[dist]), float(param))
            for _, dist, param in DELAY_POINTS)),),
        run_fn=run_fn)
    res_async = run_sweep(spec, device=device)
    res_loop = run_sweep_loop(spec, device=device)

    out = {
        "schema_version": 1,
        "quick": bool(quick),
        "device": device_line(device),
        "eval_streams": eval_streams,
        "seeds": list(seeds),
        "n_seeds": len(seeds),
        "m": M,
        "tau": TAU,
        "n_periods": n_periods,
        "payload_elems": policy_payload_elems(),
        "delay_uniforms": u_source,
        "points": {},
        "curves": {},
    }
    rows = []

    def add_point(label, cfg, metrics, idx=None):
        entry, rws = sweep_config_rows(label, metrics, len(seeds), idx=idx)
        bytes_curve = fedrl_bytes_curve(cfg)
        entry["bytes"] = bytes_curve.tolist()
        for ep, row in enumerate(rws):
            row["bytes"] = float(bytes_curve[ep])
        out["curves"][label] = entry
        rows.extend(rws)
        sel = metrics["server_grad_sq_norm"]
        if idx is not None:
            sel = sel[idx]
        egn_m, egn_h = mean_ci(sel.mean(-1), 0)
        ledger = fedrl_ledger(cfg)
        total = ledger.total_bytes()
        point = {
            "expected_grad_norm_mean": float(egn_m),
            "expected_grad_norm_ci_hw": float(egn_h),
            "total_bytes": float(total),
            "arrivals": int(ledger.c1_events),
            "bytes_per_utility": float(total * egn_m),
        }
        out["points"][label] = point
        emit(f"torch_fig_async/{label}", 0.0,
             f"grad_norm={egn_m:.4f}+-{egn_h:.4f} bytes={total:.0f} "
             f"arrivals={ledger.c1_events}")
        return point

    sync_point = add_point("sync", sync_cfg, res_sync.metrics["base"])
    for d, (label, dist, param) in enumerate(DELAY_POINTS):
        cfg_pt = make_cfg(make_strategy("async", tau=TAU, schedule=(
            make_schedule(dist, param, M, n_periods, uniforms=u))),
            epochs=epochs)
        point = add_point(label, cfg_pt, res_async.metrics["base"], idx=d)
        point["bytes_vs_sync"] = point["total_bytes"] / sync_point["total_bytes"]

    max_dev = max(
        float(np.max(np.abs(res_async.metrics["base"][k]
                            - res_loop.metrics["base"][k])))
        for k in res_async.metrics["base"])
    out["timings"] = {
        "n_runs": spec.n_runs,
        "vmapped_exec_s": res_async.wall_s["base"],
        "vmapped_compile_s": res_async.compile_s["base"],
        "loop_exec_s": res_loop.wall_s["base"],
        "loop_compile_s": res_loop.compile_s["base"],
        "vmapped_speedup": res_loop.wall_s["base"] / res_async.wall_s["base"],
        "max_abs_dev_vs_loop": max_dev,
        "runs_per_s": spec.n_runs / res_async.wall_s["base"],
        "loop_runs_per_s": spec.n_runs / res_loop.wall_s["base"],
    }
    emit("torch_fig_async/sweep_vs_loop", res_async.wall_s["base"] * 1e6,
         f"loop={res_loop.wall_s['base'] * 1e6:.0f}us "
         f"x{out['timings']['vmapped_speedup']:.2f} max_dev={max_dev:.3g}")

    dev = zero_delay_bitwise(device)
    out["async"] = {"zero_delay_bitwise_dev": dev}
    emit("torch_fig_async/zero_delay_bitwise", 0.0, f"dev={dev:.2g}")

    write_bench_json(f"fig_async{sfx}", out)
    res_async.save(SWEEP_DIR)
    write_csv(f"fig_async{sfx}", rows)
    return rows


if __name__ == "__main__":
    args = bench_args(__doc__.splitlines()[0])
    run(args.quick, args.seeds, args.device, args.eval_streams)
