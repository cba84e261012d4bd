"""Quickstart on the PyTorch port: the paper's three methods on a toy
federated problem, plus the closed-form bounds that predict their ordering.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port's copy of ``examples/quickstart.py``: the same five strategies
(sync, periodic, variation-aware, decay, consensus with E = 2) at m = 7,
tau = 8, 40 * tau local steps on the noisy quadratic of a 16 x 16 leaf, and
the bounds T1 / T2 / T5. It runs on the card (the hand-written kernels)
unless ``--device cpu`` is given. Its noise comes from the run's
``torch.Generator``, so its numbers are the port's own, not JAX's.
"""
import argparse

import torch

from repro_torch.core import (
    FmarlConfig,
    make_strategy,
    run_fmarl,
    uniform_taus,
)
from repro_torch.core import topology as T
from repro_torch.core.bounds import (
    SgdConstants,
    consensus_bound_t5,
    periodic_bound_t1,
    variation_bound_t2,
)
from repro_torch.core.decay import exponential_decay


SIGMA = 0.3              # the gradient noise's standard deviation


def noisy_quadratic(params_m, agent_ids, step, gen):
    """Each agent sees grad(F) + noise, F(x) = 0.5||x||^2: one independent
    standard-normal draw per agent and element from the run's generator."""
    g = {k: x + SIGMA * torch.randn(x.shape, generator=gen, device=x.device)
         for k, x in params_m.items()}
    loss = sum(torch.sum(x ** 2, dim=tuple(range(1, x.ndim)))
               for x in params_m.values())
    return g, {"loss": loss}


M, TAU, ETA = 7, 8, 0.05
TOPO = T.random_regularish(M, 3, 4, seed=0)


def initial_params() -> dict:
    return {"w": torch.full((16, 16), 2.0)}


def configs() -> dict:
    """The five strategies' configs, 40 * tau local steps each."""
    strategies = {
        "sync (tau=1)": make_strategy("sync", m=M),
        "periodic": make_strategy("periodic", tau=TAU, m=M),
        "variation-aware": make_strategy(
            "periodic", tau=TAU, taus=uniform_taus(1, TAU, M, seed=0)),
        "decay (lam=0.9)": make_strategy(
            "decay", tau=TAU, m=M, decay=exponential_decay(0.9)),
        "consensus (E=2)": make_strategy(
            "consensus", tau=TAU, topo=TOPO, eps=0.9 / TOPO.max_degree,
            rounds=2, m=M),
    }
    return {name: FmarlConfig(strategy=s, eta=ETA,
                              n_periods=40 * TAU // s.tau)
            for name, s in strategies.items()}


def main(device: str = "cuda") -> None:
    m, tau, topo, init = M, TAU, TOPO, initial_params()
    print(f"{'strategy':20s} {'final ||gradF||^2':>18s} {'C1 events':>10s} "
          f"{'W1 events':>10s}")
    for name, cfg in configs().items():
        _, metrics, ledger = run_fmarl(cfg, init, noisy_quadratic, 0,
                                       eval_grad_fn=lambda p, gen: p,
                                       device=device)
        final = float(metrics["server_grad_sq_norm"][-1])
        row = ledger.table_row()
        print(f"{name:20s} {final:18.5f} "
              f"{row['communication_overheads_C1']:>10d} "
              f"{row['inter_communication_W1']:>10d}")

    print("\nClosed-form bounds (paper T1/T2/T5) at matching settings:")
    c = SgdConstants(L=1.0, sigma2=SIGMA ** 2, beta=0.0, eta=ETA,
                     K=40 * tau, m=m,
                     f0_minus_finf=float(torch.sum(init["w"] ** 2) / 2))
    print(f"  T1 periodic: {periodic_bound_t1(c, tau):.4f}")
    print(f"  T2 variation-aware (uniform): "
          f"{variation_bound_t2(c, tau, (1 + tau) / 2, (tau**2 - 1) / 12):.4f}")
    print(f"  T5 consensus E=2: "
          f"{consensus_bound_t5(c, tau, topo, 0.9 / topo.max_degree, 2):.4f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    main(ap.parse_args().device)
