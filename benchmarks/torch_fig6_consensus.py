"""Paper Fig. 6 on the port: the consensus-based method (CIRL), a
topology / round / eps sweep (``benchmarks/fig6_consensus.py`` on
``repro_torch``).

  PYTHONPATH=src:. python benchmarks/torch_fig6_consensus.py [--quick]
      [--seeds N] [--device cpu] [--eval-streams per-run]

The same configs, axes and ``--quick`` geometry as the JAX bench:
topologies and gossip round counts are static points, the seeds batch into
one run per point, and on the sparse E=1 topology the consensus step size
eps is a batched axis too (each run's ``P = I - eps * La`` and its
mask-folded tables in fp32, stacked ``(S, ...)``). Seeds 0.. through
``TorchDraws``. Artifacts: ``experiments/bench/torch_fig6_consensus.csv``
(JAX's columns) and ``torch_fig6_sweep.json`` (curves, wall clock, the
card's name and power limit). ``--eval-streams per-run`` evaluates run s on
its own stream (``eval_seed`` 5000 + s) and writes ``*.streams.*``.
"""
from __future__ import annotations

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "src")]

import numpy as np  # noqa: E402

from benchmarks.torch_common import (  # noqa: E402
    bench_args,
    device_line,
    emit,
    seed_tuple,
    strategy_axis,
    stream_run_fn,
    stream_suffix,
    sweep_config_rows,
    write_bench_json,
    write_csv,
)
from benchmarks.torch_fmarl_bench import (  # noqa: E402
    make_cfg,
    topo_dense,
    topo_sparse,
)
from repro_torch.core import make_strategy  # noqa: E402
from repro_torch.core import topology as T  # noqa: E402
from repro_torch.rl.fedrl import fedrl_bytes_curve  # noqa: E402
from repro_torch.sweep import SweepAxis, SweepSpec, run_sweep  # noqa: E402


def _config_rows(rows, curves, name, metrics, n_seeds, cfg, lam_idx=None):
    entry, rws = sweep_config_rows(name, metrics, n_seeds, idx=lam_idx)
    # cumulative wire-bytes x-axis (uplink + gossip W1 for consensus configs)
    bytes_curve = fedrl_bytes_curve(cfg)
    entry["bytes"] = bytes_curve.tolist()
    for ep, row in enumerate(rws):
        row["bytes"] = float(bytes_curve[ep])
    curves[name] = entry
    rows += rws
    gn_m = np.asarray(entry["grad_norm_mean"])
    gn_h = np.asarray(entry["grad_norm_ci_hw"])
    return float(gn_m.mean()), float(gn_h.mean())


def run(quick: bool = False, seeds=None, device: str = "cuda",
        eval_streams: str = "shared") -> list:
    m, tau = 7, 10
    sfx, run_fn = stream_suffix(eval_streams), stream_run_fn(eval_streams,
                                                               device)
    seeds = seed_tuple(seeds)
    epochs = 8 if quick else None
    sp, dn = topo_sparse(m), topo_dense(m)
    configs = [
        ("periodic", make_strategy("periodic", tau=tau, m=m)),
        (f"consensus e=1 mu2={T.mu2(sp):.3f}",
         make_strategy("consensus", tau=tau, topo=sp, eps=0.9 / sp.max_degree,
                       rounds=1, m=m)),
        (f"consensus e=1 mu2={T.mu2(dn):.3f}",
         make_strategy("consensus", tau=tau, topo=dn, eps=0.9 / dn.max_degree,
                       rounds=1, m=m)),
        (f"consensus e=2 mu2={T.mu2(sp):.3f}",
         make_strategy("consensus", tau=tau, topo=sp, eps=0.9 / sp.max_degree,
                       rounds=2, m=m)),
    ]
    if quick:
        configs = configs[:2]

    spec = SweepSpec(
        name="fig6_consensus",
        base=make_cfg(configs[0][1], epochs=epochs),
        seeds=seeds,
        static=(strategy_axis("topology", configs),),
        run_fn=run_fn,
    )
    res = run_sweep(spec, device=device)

    rows, curves = [], {}
    for name, strat in configs:
        gm, gh = _config_rows(rows, curves, name, res.metrics[name],
                              len(seeds), make_cfg(strat, epochs=epochs))
        emit(f"torch_fig6/{name}", res.wall_s[name] / len(seeds) * 1e6,
             f"grad_norm={gm:.4f}+-{gh:.4f}")

    # batched eps axis on the sparse E=1 topology: fractions of 1/Delta
    fracs = (0.45, 0.9) if quick else (0.3, 0.6, 0.9)
    eps_vals = tuple(f / sp.max_degree for f in fracs)
    eps_spec = SweepSpec(
        name="fig6_eps",
        base=make_cfg(
            make_strategy("consensus", tau=tau, topo=sp,
                          eps=eps_vals[0], rounds=1, m=m),
            epochs=epochs,
        ),
        seeds=seeds,
        vmapped=(SweepAxis("eps", eps_vals),),
        run_fn=run_fn,
    )
    eps_res = run_sweep(eps_spec, device=device)
    per_run_us = eps_res.wall_s["base"] / eps_spec.n_runs * 1e6
    for i, (frac, eps) in enumerate(zip(fracs, eps_vals)):
        name = f"consensus e=1 eps={frac:.2f}/max_deg"
        gm, gh = _config_rows(rows, curves, name, eps_res.metrics["base"],
                              len(seeds), eps_spec.base, lam_idx=i)
        emit(f"torch_fig6/{name}", per_run_us, f"grad_norm={gm:.4f}+-{gh:.4f}")

    write_bench_json(f"fig6_sweep{sfx}", {
        "schema_version": 1, "quick": bool(quick),
        "device": device_line(device), "eval_streams": eval_streams,
        "seeds": list(seeds), "n_seeds": len(seeds),
        "eps_values": list(eps_vals), "eps_fracs": list(fracs),
        "curves": curves,
        "wall_s": {**res.wall_s, "eps_axis": eps_res.wall_s["base"]},
        "runs_per_s": {"eps_axis": eps_spec.n_runs / eps_res.wall_s["base"]},
    })
    write_csv(f"fig6_consensus{sfx}", rows)
    return rows


if __name__ == "__main__":
    args = bench_args(__doc__.splitlines()[0])
    run(args.quick, args.seeds, args.device, args.eval_streams)
