"""Shared FMARL experiment machinery of the port's paper-table benches.

The port's ``benchmarks/fmarl_bench.py``: the same scaled-down run geometry
(paper: T=1500, U=500, P=250; here T=150, U=24, P=25, eta=5e-3;
``REPRO_BENCH_FULL=1`` enlarges toward paper scale), the same topologies
and the Table II configuration set, on ``repro_torch``.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.core import make_strategy, uniform_taus
from repro_torch.core import topology as T
from repro_torch.core.decay import exponential_decay
from repro_torch.rl import FIGURE_EIGHT, FedRLConfig, run_fedrl
from repro_torch.rl.fedrl import expected_gradient_norm

FULL = bool(int(os.environ.get("REPRO_BENCH_FULL", "0")))

# scaled-down run geometry (paper: T=1500, U=500, P=250)
T_LEN = 300 if FULL else 150
U_EPOCHS = 80 if FULL else 24
P_BATCH = 25 if FULL else 25
ETA = 5e-3


def topo_sparse(m=7):
    """~3-4 connections/agent (paper Fig. 6 'mu2=1.4384' regime)."""
    return T.random_regularish(m, 3, 4, seed=0)


def topo_dense(m=7):
    """~4-6 connections/agent (paper Fig. 6 'mu2=2.5188' regime)."""
    return T.random_regularish(m, 5, 6, seed=0)


def make_cfg(strategy, *, env=FIGURE_EIGHT, algo="ppo", epochs=None):
    """The shared scaled-down run geometry as a FedRLConfig (sweep base)."""
    return FedRLConfig(
        env=env, strategy=strategy, eta=ETA, algo=algo,
        n_epochs=epochs or U_EPOCHS, epoch_len=T_LEN, minibatch=P_BATCH,
    )


def run_config(name: str, strategy, *, env=FIGURE_EIGHT, algo="ppo", seed=0,
               epochs=None, device="cuda"):
    cfg = make_cfg(strategy, env=env, algo=algo, epochs=epochs)
    server, metrics, ledger = run_fedrl(cfg, seed, device=device)
    row = {
        "config": name,
        "expected_grad_norm": expected_gradient_norm(metrics),
        "final_nas": float(np.mean(metrics["nas"][-3:])),
        "first_nas": float(np.mean(metrics["nas"][:3])),
        **ledger.table_row(),
    }
    return row, metrics


def strategies_table2(m=7, tau=10):
    """The Table II configuration set (scaled tau levels preserved)."""
    sp, dn = topo_sparse(m), topo_dense(m)
    eps_s = 0.9 / sp.max_degree
    eps_d = 0.9 / dn.max_degree
    rows = [
        ("tau=1", make_strategy("sync", m=m)),
        ("tau=10", make_strategy("periodic", tau=10, m=m)),
        ("tau=15", make_strategy("periodic", tau=15, m=m)),
        ("tau=10~15", make_strategy("periodic", tau=15,
                                    taus=uniform_taus(10, 15, m, seed=0))),
        ("tau=5~15", make_strategy("periodic", tau=15,
                                   taus=uniform_taus(5, 15, m, seed=0))),
        ("tau=1~15", make_strategy("periodic", tau=15,
                                   taus=uniform_taus(1, 15, m, seed=0))),
        ("tau=1~15 decay l=0.98",
         make_strategy("decay", tau=15, taus=uniform_taus(1, 15, m, seed=0),
                       decay=exponential_decay(0.98))),
        ("tau=1~15 decay l=0.95",
         make_strategy("decay", tau=15, taus=uniform_taus(1, 15, m, seed=0),
                       decay=exponential_decay(0.95))),
        ("tau=1~15 decay l=0.92",
         make_strategy("decay", tau=15, taus=uniform_taus(1, 15, m, seed=0),
                       decay=exponential_decay(0.92))),
        ("tau=10 consensus e=1 mu2=%.3f" % T.mu2(sp),
         make_strategy("consensus", tau=10, topo=sp, eps=eps_s, rounds=1, m=m)),
        ("tau=10 consensus e=1 mu2=%.3f" % T.mu2(dn),
         make_strategy("consensus", tau=10, topo=dn, eps=eps_d, rounds=1, m=m)),
        ("tau=10 consensus e=2 mu2=%.3f" % T.mu2(sp),
         make_strategy("consensus", tau=10, topo=sp, eps=eps_s, rounds=2, m=m)),
        ("tau=1~10 consensus e=1 mu2=%.3f" % T.mu2(sp),
         make_strategy("consensus", tau=10, topo=sp, eps=eps_s, rounds=1,
                       taus=uniform_taus(1, 10, m, seed=0), m=m)),
    ]
    return rows
