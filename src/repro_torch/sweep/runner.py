"""Batched sweep execution (``repro.sweep.runner``): one batched run over the
whole (hypers x seeds) grid per static point, plus the equivalent one-run
loop.

``run_sweep`` flattens the cartesian product of every batched axis and the
seed list into one leading run axis S, builds each run's config with the
axis overrides (``repro_torch.sweep.overrides``) and runs the S configs as
one batched federated run (``repro_torch.rl.fedrl.run_fedrl_batch``): the
flat ``(m, n)`` carry becomes ``(S, m, n)``, the per-agent work runs on
S * m agent rows, and every aggregation primitive takes the run axis in one
dispatch call (one launch on the card). Static axes (tau, topology,
scenario, compression — anything shape-changing) run as an outer Python
loop, one batched run each.

``run_sweep_loop`` runs the identical grid as S one-run calls. It is the
reference within the port: each run draws from its own source in its own
order, so on the CPU its metrics equal ``run_sweep``'s bitwise (as the JAX
package's do on its jnp backend, ``src/repro/sweep/runner.py:12-15``); on
the card a library matrix product in the PPO gradient may pick another
algorithm for S * m rows than for m, and PERF.md states the tolerance
reached there.

There is no compile step in eager PyTorch: ``compile_s`` records each
static point's first, untimed warm-up call (the kernels' build, if any,
and first-call costs), ``wall_s`` the timed call after it.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Iterator, List, Tuple, Union

import numpy as np
import torch

from repro_torch.sweep.overrides import apply_overrides
from repro_torch.sweep.results import SweepResult
from repro_torch.sweep.spec import SweepSpec


def _default_run_fn(device):
    """Metrics of S federated RL runs as one batched run."""
    def run(cfgs, seeds):
        from repro_torch.rl.fedrl import run_fedrl_batch

        return run_fedrl_batch(cfgs, seeds, device=device)[1]

    return run


def static_points(spec: SweepSpec) -> Iterator[Tuple[str, Callable]]:
    """Cartesian product of the static axes -> (label, composed transform).

    Labels key the result dicts, so a collision would silently overwrite a
    grid point's runs — raise instead.
    """
    if not spec.static:
        yield "base", lambda cfg: cfg
        return
    seen = set()
    for combo in itertools.product(*(ax.points for ax in spec.static)):
        label = "/".join(lab for lab, _ in combo if lab) or "base"
        if label in seen:
            raise ValueError(f"duplicate static-point label {label!r}")
        seen.add(label)

        def transform(cfg, fns=tuple(fn for _, fn in combo)):
            for fn in fns:
                cfg = fn(cfg)
            return cfg

        yield label, transform


def _grid_arrays(spec: SweepSpec) -> Tuple[List[np.ndarray], np.ndarray]:
    """Flatten the (axes x seeds) product into per-axis value arrays.

    Returns ``(axis_value_arrays, seed_vector)``, each with leading length
    ``spec.n_runs`` — row i holds grid cell i's coordinates (C-order over
    ``spec.grid_shape``, seeds innermost), fp32 values as the JAX runner
    hands them to its overrides.
    """
    axes_vals = [np.asarray(a.values, np.float32) for a in spec.vmapped]
    seeds = np.asarray(spec.seeds, np.int64)
    mesh = np.meshgrid(
        *(np.arange(len(v)) for v in axes_vals), np.arange(len(seeds)),
        indexing="ij",
    )
    idx = [ix.reshape(-1) for ix in mesh]
    return [v[ix] for v, ix in zip(axes_vals, idx[:-1])], seeds[idx[-1]]


def _run_configs(spec: SweepSpec, cfg, axis_vals, rows) -> list:
    names = [a.name for a in spec.vmapped]
    return [apply_overrides(cfg, names, tuple(v[i] for v in axis_vals))
            for i in rows]


def _reshape(spec: SweepSpec, stacked: dict) -> dict:
    shape = spec.grid_shape
    return {k: np.asarray(v).reshape(shape + np.shape(v)[1:])
            for k, v in stacked.items()}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _result(spec, metrics, wall_s, compile_s, mode) -> SweepResult:
    return SweepResult(
        name=spec.name,
        axes={a.name: list(a.values) for a in spec.vmapped},
        seeds=list(spec.seeds),
        metrics=metrics,
        wall_s=wall_s,
        compile_s=compile_s,
        mode=mode,
    )


def run_sweep(spec: SweepSpec, *, device: Union[str, torch.device] = "cuda",
              warmup: bool = True) -> SweepResult:
    """Execute the sweep: one batched run of all ``spec.n_runs`` runs per
    static point. ``compile_s`` records the untimed warm-up call
    (``warmup=False`` skips it), ``wall_s`` the timed one. Runs on the
    card unless ``device="cpu"``."""
    axis_vals, seeds = _grid_arrays(spec)
    run_fn = spec.run_fn or _default_run_fn(device)
    metrics, wall_s, compile_s = {}, {}, {}
    for label, transform in static_points(spec):
        cfgs = _run_configs(spec, transform(spec.base), axis_vals,
                            range(len(seeds)))
        run_seeds = [int(s) for s in seeds]
        if warmup:
            t0 = time.perf_counter()
            run_fn(cfgs, run_seeds)
            _sync(device)
            compile_s[label] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = run_fn(cfgs, run_seeds)
        _sync(device)
        wall_s[label] = time.perf_counter() - t0
        metrics[label] = _reshape(spec, out)
    return _result(spec, metrics, wall_s, compile_s, "vmapped")


def run_sweep_loop(spec: SweepSpec, *,
                   device: Union[str, torch.device] = "cuda",
                   warmup: bool = True) -> SweepResult:
    """The same grid as S one-run calls of the same run function.

    Semantically identical to :func:`run_sweep` (bitwise on the CPU); the
    reference and the wall-clock baseline of the batched engine.
    ``compile_s`` records one untimed warm-up run (the grid's first).
    """
    axis_vals, seeds = _grid_arrays(spec)
    run_fn = spec.run_fn or _default_run_fn(device)
    metrics, wall_s, compile_s = {}, {}, {}
    for label, transform in static_points(spec):
        cfg = transform(spec.base)
        if warmup:
            t0 = time.perf_counter()
            run_fn(_run_configs(spec, cfg, axis_vals, [0]), [int(seeds[0])])
            _sync(device)
            compile_s[label] = time.perf_counter() - t0
        t0 = time.perf_counter()
        per_run = []
        for i in range(len(seeds)):
            per_run.append(run_fn(_run_configs(spec, cfg, axis_vals, [i]),
                                  [int(seeds[i])]))
        _sync(device)
        wall_s[label] = time.perf_counter() - t0
        stacked = {k: np.concatenate([np.asarray(r[k]) for r in per_run])
                   for k in per_run[0]}
        metrics[label] = _reshape(spec, stacked)
    return _result(spec, metrics, wall_s, compile_s, "loop")
