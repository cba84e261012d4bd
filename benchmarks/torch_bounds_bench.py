"""Theory benchmark on the port: the closed forms T1 / T2 / T4 / T5, the
largest feasible eta and the utility over a tau sweep
(``benchmarks/bounds_bench.py`` on ``repro_torch.core.bounds``).

  PYTHONPATH=src:. python benchmarks/torch_bounds_bench.py [--quick]

The rows go to ``experiments/bench/torch_bounds_theory.csv``. The bounds are
host float math (numpy and fp32 host tables, no tensor on a device), so the
bench runs on the CPU and takes no ``--device``: a card would have nothing
to do. ``tests/test_torch_bounds.py`` holds the committed ``--quick`` file
bitwise against the JAX bench's rows.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "src")]

import numpy as np  # noqa: E402

from benchmarks.torch_common import emit, write_csv  # noqa: E402
from repro_torch.core import topology as T  # noqa: E402
from repro_torch.core.bounds import (  # noqa: E402
    SgdConstants,
    consensus_bound_t5,
    decay_bound_t4,
    max_feasible_eta,
    periodic_bound_t1,
    resource_cost_periodic,
    utility,
    variation_bound_t2,
)

C = SgdConstants(L=1.0, sigma2=2.0, beta=0.5, eta=1e-4, K=300_000, m=7,
                 f0_minus_finf=10.0)


def run(quick: bool = False) -> list:
    t0 = time.perf_counter()
    rows = []
    topo = T.random_regularish(7, 3, 4, seed=0)
    eps = 0.9 / topo.max_degree
    taus = [1, 2, 5, 10, 15] if not quick else [1, 10]
    for tau in taus:
        psi1_t1 = periodic_bound_t1(C, tau)
        nu, w2 = (1 + tau) / 2, (tau**2 - 1) / 12
        psi1_t2 = variation_bound_t2(C, tau, nu, w2) if tau > 1 else psi1_t1
        psi3 = decay_bound_t4(C, tau, 0.95) if tau > 1 else psi1_t1
        psi5 = consensus_bound_t5(C, tau, topo, eps, 1)
        psi0 = resource_cost_periodic(m=7, taus=np.full(7, tau), tau=tau,
                                      T=1500, U=500, P=250, c1=1.0, c2=0.1)
        psi2 = 2 * psi1_t1  # initial-model bound proxy
        rows.append({
            "tau": tau,
            "psi1_T1": psi1_t1, "psi1_T2_uniform": psi1_t2,
            "psi3_T4_lam095": psi3, "psi1_T5_E1": psi5,
            "max_eta": max_feasible_eta(C, tau),
            "utility_T1": utility(psi1=psi1_t1, psi2=psi2, psi0=psi0),
            "utility_T5": utility(psi1=psi5, psi2=psi2, psi0=psi0),
        })
    write_csv("bounds_theory", rows)
    emit("torch_bounds/sweep", (time.perf_counter() - t0) * 1e6,
         f"taus={len(rows)};T5<T1="
         f"{all(r['psi1_T5_E1'] <= r['psi1_T1'] for r in rows)}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="tau in {1, 10} only (the committed artifact)")
    run(ap.parse_args().quick)
