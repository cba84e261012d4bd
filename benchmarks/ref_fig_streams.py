"""The JAX reference for the one-evaluation-stream-per-run reproduction of
Figs. 4-6 and the async figure.

  JAX_PLATFORMS=cpu PYTHONPATH=src:. python benchmarks/ref_fig_streams.py
      [--figs fig4_variation,fig5_decay,fig6_consensus,fig_async]

The committed figure CSVs evaluate every seed on one shared evaluation
stream (``FedRLConfig.eval_seed`` 1234). This script reruns the ``--quick``
configs of ``fig4_variation.py``, ``fig5_decay.py``, ``fig6_consensus.py``
and ``fig_async.py`` (8 epochs, seeds 0-3) one run at a time, run ``s`` on
its own stream: ``run_fedrl(replace(cfg, eval_seed=5000 + s), key(s))``.
The async points keep their schedules ``make_schedule(dist, param, 7,
n_periods, seed=1234)``. Every draw is made as the committed CSVs' were:
with ``jax_threefry_partitionable`` off, the default before JAX 0.5. Under
the newer default the same keys give other draws (geometric(0.5) /
heavytail(1.5) bill 13 / 15 arrivals instead of 12 / 14; Fig. 4's ``tau=1``
seed means move by up to 0.02 in ``nas`` and 0.91 in ``grad_norm``). So
the runs differ from the committed ones in their evaluation streams only,
and every ``bytes`` entry equals the committed CSVs'.

Writes ``experiments/bench/ref_<fig>.streams.csv`` (the committed CSVs'
columns) and ``experiments/bench/ref_fig_async_delay_uniforms.npy``: the
``(7, n_periods)`` float32 uniforms behind the async points' delay draws,
which the port reads to reproduce JAX's arrivals. Every ``eval_seed``
compiles anew (~2-3 s a run): the 60 runs take a few minutes on a CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "src")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks.common import OUT_DIR, sweep_config_rows, write_csv  # noqa: E402
from benchmarks.fmarl_bench import make_cfg, topo_sparse  # noqa: E402
from repro.core import make_strategy, uniform_taus  # noqa: E402
from repro.core import topology as T  # noqa: E402
from repro.core.async_fed import (  # noqa: E402
    AsyncStrategy,
    delay_axis_key,
    make_schedule,
)
from repro.core.decay import exponential_decay  # noqa: E402
from repro.rl import run_fedrl  # noqa: E402
from repro.rl.fedrl import fedrl_bytes_curve  # noqa: E402

SEEDS = (0, 1, 2, 3)
EPOCHS = 8
EVAL_SEED_BASE = 5000
M = 7
# the threefry mode the committed figure artifacts were drawn in
COMMITTED_THREEFRY_PARTITIONABLE = False
ASYNC_POINTS = (
    ("det0", "deterministic", 0.0),
    ("det1", "deterministic", 1.0),
    ("geom0.5", "geometric", 0.5),
    ("heavy1.5", "heavytail", 1.5),
)


def fig4_configs():
    tau = 15
    return [
        ("tau=1", make_strategy("sync", m=M)),
        ("tau=15", make_strategy("periodic", tau=tau, m=M)),
        ("tau=10~15", make_strategy(
            "periodic", tau=tau, taus=uniform_taus(10, tau, M, seed=0))),
    ]


def fig5_configs():
    tau = 15
    taus = uniform_taus(1, tau, M, seed=0)
    return [("no-decay", make_strategy("periodic", tau=tau, taus=taus))] + [
        (f"lambda={lam}", make_strategy("decay", tau=tau, taus=taus,
                                        decay=exponential_decay(lam)))
        for lam in (0.98, 0.92)
    ]


def fig6_configs():
    tau, sp = 10, topo_sparse(M)
    out = [
        ("periodic", make_strategy("periodic", tau=tau, m=M)),
        (f"consensus e=1 mu2={T.mu2(sp):.3f}",
         make_strategy("consensus", tau=tau, topo=sp, eps=0.9 / sp.max_degree,
                       rounds=1, m=M)),
    ]
    for frac in (0.45, 0.9):
        out.append((f"consensus e=1 eps={frac:.2f}/max_deg",
                    make_strategy("consensus", tau=tau, topo=sp,
                                  eps=frac / sp.max_degree, rounds=1, m=M)))
    return out


def async_n_periods() -> int:
    cfg = make_cfg(make_strategy("periodic", tau=15, m=M), epochs=EPOCHS)
    return cfg.n_epochs * (cfg.epoch_len // cfg.minibatch) // 15


def fig_async_configs():
    tau, n_periods = 15, async_n_periods()
    out = [("sync", make_strategy("periodic", tau=tau, m=M))]
    for label, dist, param in ASYNC_POINTS:
        sched = make_schedule(dist, param, M, n_periods, seed=1234)
        out.append((label, AsyncStrategy(tau=tau, schedule=sched)))
    return out


FIGS = {
    "fig4_variation": (fig4_configs, False),
    "fig5_decay": (fig5_configs, True),
    "fig6_consensus": (fig6_configs, True),
    "fig_async": (fig_async_configs, True),
}


def run_fig(fig: str) -> str:
    configs, with_bytes = FIGS[fig]
    rows = []
    for label, strat in configs():
        cfg = make_cfg(strat, epochs=EPOCHS)
        per_seed = []
        for s in SEEDS:
            t0 = time.perf_counter()
            _, metrics, _ = run_fedrl(
                dataclasses.replace(cfg, eval_seed=EVAL_SEED_BASE + s),
                jax.random.key(s),
            )
            per_seed.append(metrics)
            print(f"# {fig} {label} seed {s}: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        stacked = {k: np.stack([ms[k] for ms in per_seed])
                   for k in per_seed[0]}
        _, rws = sweep_config_rows(label, stacked, len(SEEDS))
        if with_bytes:
            curve = fedrl_bytes_curve(cfg)
            for ep, row in enumerate(rws):
                row["bytes"] = float(curve[ep])
        rows += rws
    return write_csv(f"ref_{fig}.streams", rows)


def save_delay_uniforms() -> str:
    n_periods = async_n_periods()
    u = jax.random.uniform(delay_axis_key(1234), (M, n_periods), jnp.float32,
                           minval=1e-6, maxval=1.0 - 1e-6)
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "ref_fig_async_delay_uniforms.npy")
    np.save(path, np.asarray(jax.device_get(u), np.float32))
    return path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--figs", default=",".join(FIGS))
    figs = [f for f in ap.parse_args().figs.split(",") if f]
    with jax.threefry_partitionable(COMMITTED_THREEFRY_PARTITIONABLE):
        print(f"# wrote {save_delay_uniforms()}", flush=True)
        for fig in figs:
            print(f"# wrote {run_fig(fig)}", flush=True)


if __name__ == "__main__":
    main()
