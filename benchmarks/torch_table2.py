"""Paper Table II on the port: expected gradient norm per method, with the
C1/C2/W1/W2 costs (``benchmarks/table2.py`` on ``repro_torch``).

  PYTHONPATH=src:. python benchmarks/torch_table2.py [--quick] [--device cpu]

One seeded run (seed 0, ``TorchDraws``) per configuration at the geometry
of ``benchmarks/torch_fmarl_bench.py``; the rows go to
``experiments/bench/torch_table2.csv`` with the card's name and power limit
and each run's wall seconds.
"""
from __future__ import annotations

import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "src")]

from benchmarks.torch_common import (  # noqa: E402
    bench_args,
    device_line,
    emit,
    write_csv,
)
from benchmarks.torch_fmarl_bench import (  # noqa: E402
    run_config,
    strategies_table2,
)


def run(quick: bool = False, device: str = "cuda") -> list:
    rows = []
    configs = strategies_table2()
    if quick:
        configs = configs[:4]
    card = device_line(device)
    for name, strat in configs:
        t0 = time.perf_counter()
        row, _ = run_config(name, strat, device=device)
        dt = time.perf_counter() - t0
        row.update(wall_s=dt, device=card)
        rows.append(row)
        emit(f"torch_table2/{name}", dt * 1e6,
             f"grad_norm={row['expected_grad_norm']:.4f};"
             f"C1={row['communication_overheads_C1']};"
             f"C2={row['computation_overheads_C2']};"
             f"W1={row['inter_communication_W1']}")
    write_csv("table2", rows)
    return rows


if __name__ == "__main__":
    args = bench_args(__doc__.splitlines()[0])
    run(args.quick, args.device)
