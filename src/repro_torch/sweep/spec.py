"""Sweep specifications (``repro.sweep.spec``): which experiment dimensions
batch into one run, which stay static.

The paper's headline results are *grids* — decay lambda x tau (Fig. 5),
consensus eps x topology (Fig. 6), every cell averaged over seeds. A sweep
splits those grid dimensions into two kinds of axis:

* **vmapped axes** — seeds and any hyperparameter that only changes *values*
  flowing through the computation: the seed, the learning rate
  eta, the decay constant lambda (a ``(tau,)`` weight table), the consensus
  step size eps (an ``(m, m)`` mixing matrix), the per-agent tau_i schedule
  at fixed period length (an ``(m, tau)`` variation mask), the fleet
  heterogeneity scale (per-agent ``EnvParams`` magnitudes). All vmapped axes
  and the seed axis form one cartesian product that is flattened into a
  single leading sweep axis S, so one batched run covers every cell — the
  flat ``(m, n)`` carry of the driver becomes ``(S, m, n)`` and the
  dispatch primitives take the run axis in one launch each. Axis points may
  be scalars or equal-length vectors (a tau_i schedule is a whole (m,)
  point); each override builds one run's config from one point, and the
  runs' tables are stacked per run.

* **static axes** — anything that changes *shapes or the program's structure*: the
  period length tau (the variation mask is ``(m, tau)`` and the inner scan
  length is tau), the gossip topology (adjacency fixes the ``(m, m)``
  sparsity and the agent count), the scenario / environment structure, the
  backend. These run in an outer Python loop, one batched run each.

A :class:`SweepSpec` names the experiment, carries the base config, the seed
list, the vmapped hyperparameter axes, and the static axes (label +
config-transform pairs). ``repro_torch.sweep.runner`` executes it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SweepAxis:
    """One vmapped hyperparameter axis.

    ``name`` must be a registered override (see
    ``repro_torch.sweep.overrides``): the override maps ``(cfg, value) ->
    cfg`` for one run, and the runner stacks the runs' configs into one
    batched run.

    Points are scalars (eta, lam, eps, hetero_scale) or equal-length vectors
    (a per-agent tau_i schedule, a per-agent lam vector); a vector point
    reaches the override as a 1-D fp32 array. Scalar and vector points
    cannot mix on one axis — the runs' tables must share one shape.
    """

    name: str
    values: Tuple

    def __post_init__(self):
        if not self.values:
            raise ValueError(f"vmapped axis {self.name!r} needs >= 1 value")
        norm, point_len = [], None
        for v in self.values:
            arr = np.asarray(v, dtype=np.float64)
            if arr.ndim == 0:
                cur, val = None, float(v)
            elif arr.ndim == 1 and arr.size:
                cur, val = arr.size, tuple(float(x) for x in arr)
            else:
                raise ValueError(
                    f"vmapped axis {self.name!r}: points must be scalars or "
                    f"non-empty 1-D vectors, got shape {arr.shape}"
                )
            if norm and cur != point_len:
                raise ValueError(
                    f"vmapped axis {self.name!r}: all points must share one "
                    f"shape (scalar or fixed-length vector); got a mix"
                )
            point_len = cur
            norm.append(val)
        object.__setattr__(self, "values", tuple(norm))

    @property
    def point_len(self) -> Optional[int]:
        """Vector-point length, or None for a scalar-valued axis."""
        first = np.asarray(self.values[0])
        return None if first.ndim == 0 else int(first.size)


@dataclasses.dataclass(frozen=True)
class StaticAxis:
    """One static (shape-changing) axis: labelled config transforms.

    Each point is ``(label, transform)`` where ``transform(cfg) -> cfg`` is
    applied before the batched run (it may swap strategies, taus, topologies,
    scenarios — anything). Multiple static axes combine by cartesian product,
    composing their transforms.
    """

    name: str
    points: Tuple[Tuple[str, Callable], ...]

    def __post_init__(self):
        if not self.points:
            raise ValueError(f"static axis {self.name!r} needs >= 1 point")


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A batched multi-seed experiment over one base config.

    Attributes:
      name: experiment name (used for the emitted JSON/CSV artifacts).
      base: the template config (``FedRLConfig`` by default; any object when
        ``run_fn`` is supplied).
      seeds: seeds of the runs' draw sources — always a batched axis (the
        innermost one).
      vmapped: hyperparameter axes batched into the one run (JAX's name).
      static: shape-changing axes looped in Python (cartesian product).
      run_fn: ``(cfgs, seeds) -> metrics``: the S runs' configs and seeds
        (or draw sources) to a dict of arrays with a leading S; defaults to
        the metrics of ``repro_torch.rl.fedrl.run_fedrl_batch`` on the
        runner's device.
    """

    name: str
    base: Any
    seeds: Tuple[int, ...]
    vmapped: Tuple[SweepAxis, ...] = ()
    static: Tuple[StaticAxis, ...] = ()
    run_fn: Optional[Callable] = None

    def __post_init__(self):
        if not self.seeds:
            raise ValueError("SweepSpec needs >= 1 seed")
        object.__setattr__(self, "seeds", tuple(int(s) for s in self.seeds))
        names = [a.name for a in self.vmapped]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate vmapped axis names: {names}")

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        """Shape of the vmapped grid: (*axis lengths, n_seeds)."""
        return tuple(len(a.values) for a in self.vmapped) + (len(self.seeds),)

    @property
    def n_runs(self) -> int:
        """Full federated runs per static point (product of the grid)."""
        n = 1
        for s in self.grid_shape:
            n *= s
        return n
