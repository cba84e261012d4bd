"""Shared helpers of the port's benches (``benchmarks/torch_*.py``).

The counterpart of ``benchmarks/common.py`` for ``repro_torch``: the same
``name,us_per_call,derived`` lines and the same CSV / JSON layouts, with
every artifact named ``torch_<name>`` under ``experiments/bench/`` (or
``$REPRO_BENCH_OUT``; sweep artifacts under ``experiments/sweeps/`` or
``$REPRO_SWEEP_OUT``), beside the JAX package's and never over one. Imports
neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import csv
import json
import os
import subprocess
import sys
import time

OUT_DIR = os.environ.get("REPRO_BENCH_OUT", "experiments/bench")
SWEEP_DIR = os.environ.get("REPRO_SWEEP_OUT", "experiments/sweeps")
PREFIX = "torch_"
DEFAULT_SEEDS = (0, 1, 2, 3)


def artifact(name: str, ext: str) -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    base = name if name.startswith(PREFIX) else PREFIX + name
    return os.path.join(OUT_DIR, f"{base}.{ext}")


def write_csv(name: str, rows: list) -> str:
    path = artifact(name, "csv")
    if rows:
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    return path


def write_bench_json(name: str, payload: dict) -> str:
    path = artifact(name, "json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"# wrote {path}")
    return path


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    """``name,us_per_call,derived`` on stdout, as ``benchmarks/run.py``."""
    print(f"{name},{us_per_call:.3f},{derived}")
    sys.stdout.flush()


def device_line(device) -> str:
    """The card's name and power limit (``nvidia-smi``), or ``cpu``."""
    if str(device).startswith("cuda"):
        try:
            return subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True, timeout=60).stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError):
            import torch

            return torch.cuda.get_device_name(0)
    return "cpu"


def seed_tuple(seeds) -> tuple:
    """Normalise a --seeds value: int count, iterable of seeds, or None."""
    if seeds is None:
        return DEFAULT_SEEDS
    if isinstance(seeds, int):
        if seeds < 1:
            raise SystemExit("--seeds must be >= 1")
        return tuple(range(seeds))
    out = tuple(int(s) for s in seeds)
    if not out:
        raise SystemExit("--seeds must be >= 1")
    return out


def strategy_axis(name, configs):
    """A StaticAxis whose points swap the strategy of the base config."""
    import dataclasses

    from repro_torch.sweep import StaticAxis

    return StaticAxis(name, tuple(
        (label, lambda cfg, s=strat: dataclasses.replace(cfg, strategy=s))
        for label, strat in configs
    ))


def sweep_config_rows(config, metrics, n_seeds, *, idx=None, include_grad=True):
    """Seed-reduce one plotted config's curves from raw sweep metric arrays
    (``benchmarks/common.py``'s reduction, on the port's ``mean_ci``):
    returns ``(curve_entry, rows)``."""
    from repro_torch.sweep import mean_ci

    sel = (lambda a: a) if idx is None else (lambda a: a[idx])
    nas_m, nas_h = mean_ci(sel(metrics["nas"]), 0)
    entry = {"nas_mean": nas_m.tolist(), "nas_ci_hw": nas_h.tolist()}
    if include_grad:
        gn_m, gn_h = mean_ci(sel(metrics["server_grad_sq_norm"]), 0)
        entry["grad_norm_mean"] = gn_m.tolist()
        entry["grad_norm_ci_hw"] = gn_h.tolist()
    rows = []
    for ep in range(len(nas_m)):
        row = {"config": config, "epoch": ep,
               "nas": float(nas_m[ep]), "nas_ci_hw": float(nas_h[ep])}
        if include_grad:
            row["grad_norm"] = float(gn_m[ep])
            row["grad_norm_ci_hw"] = float(gn_h[ep])
        row["n_seeds"] = n_seeds
        rows.append(row)
    return entry, rows


# --eval-streams per-run: run s evaluates on its own stream, eval_seed
# EVAL_STREAM_BASE + s (benchmarks/ref_fig_streams.py runs JAX the same way)
EVAL_STREAM_BASE = 5000


def stream_draws(eval_streams: str, seed: int, device):
    """The draw source of seed ``seed``'s run: the seed itself (its config's
    shared ``eval_seed`` stream) for ``shared``, or a ``TorchDraws`` whose
    evaluation stream is ``EVAL_STREAM_BASE + seed`` for ``per-run``."""
    if eval_streams == "shared":
        return int(seed)
    if eval_streams != "per-run":
        raise ValueError(f"eval streams {eval_streams!r}: shared or per-run")
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.rl.draws import TorchDraws

    return TorchDraws(int(seed), resolve_device(device),
                      eval_seed=EVAL_STREAM_BASE + int(seed))


def stream_run_fn(eval_streams: str, device):
    """A ``SweepSpec.run_fn`` giving each run :func:`stream_draws` (None,
    the runner's default, for ``shared``)."""
    if eval_streams == "shared":
        return None

    def run(cfgs, seeds):
        from repro_torch.rl.fedrl import run_fedrl_batch

        return run_fedrl_batch(
            cfgs, [stream_draws(eval_streams, s, device) for s in seeds],
            device=device)[1]

    return run


def stream_suffix(eval_streams: str) -> str:
    """The artifacts' suffix: none for ``shared``, ``.streams`` else."""
    return "" if eval_streams == "shared" else ".streams"


def bench_args(description: str):
    """``--quick``, ``--seeds``, ``--device`` (default cuda) and
    ``--eval-streams`` (default shared)."""
    import argparse

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--quick", action="store_true",
                    help="the reduced geometry of the committed artifacts")
    ap.add_argument("--seeds", type=int, default=None,
                    help="seed count (default 4)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--eval-streams", default="shared",
                    choices=("shared", "per-run"),
                    help="shared: every run evaluates on its config's "
                         "eval_seed stream; per-run: run s on eval_seed "
                         f"{EVAL_STREAM_BASE} + s, artifacts *.streams.*")
    return ap.parse_args()


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.seconds = time.perf_counter() - self.t0
