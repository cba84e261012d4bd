"""Hyperparameter overrides for the batched sweep axes (``repro.sweep.overrides``).

An override builds one run's config from the base config and one axis point.
The runner builds the S runs' configs of a static point this way and stacks
them into one batched run (``repro_torch.core.strategies.stack_runs``,
``repro_torch.rl.fedrl.run_fedrl_batch``): per-run tables where the JAX
package traces them under ``vmap``. The arithmetic is the JAX package's
(``src/repro/sweep/overrides.py``), in fp32, not the port's static builders
where the two differ: ``lam^(j/2)`` tabulated in fp32 (:101-111), ``P = I -
eps * La`` and its powers rebuilt in fp32 (:133-147, where the port's
``mixing_powers`` rounds a float64 matrix), the sparse edge weights
retabulated in fp32 (:128-132).

As in JAX, an override does not run the eager validation of strategy
construction (A3 monotonicity of the decay, 0 < eps < 1/Delta): callers keep
their sweep values inside the ranges the paper's assumptions demand. A
concrete ``taus`` point is checked against A2.

Built-in axes: ``eta``, ``lam`` (scalar or ``(m,)`` points), ``eps`` (dense
and sparse), ``taus`` (``(m,)`` schedules at fixed tau), ``hetero_scale``
(scalar or ``(scale, dir_seed)`` points), ``delay`` (``(dist_id, param)``
points) and ``k`` (buffer sizes) on an async base. Payload compression
changes the program, not its values, so :func:`compression_axis` builds it
as a *static* axis; so does :func:`algebraic_connectivity_axis` for graph
families.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.decay import exponential_decay_table
from repro_torch.core.strategies import ConsensusStrategy, DecayStrategy
from repro_torch.core.topology import laplacian, neighbor_weights
from repro_torch.core.variation import mask_from_taus, validate_a2

# The direction seed of the hetero_scale axis (the JAX package folds the
# same constant into its eval key).
HETERO_FOLD = 2026


def override_eta(cfg, eta):
    """Learning-rate axis (the fp32 value of the point, as JAX traces it)."""
    return dataclasses.replace(cfg, eta=float(np.float32(eta)))


def override_lam(cfg, lam):
    """Decay-constant axis: retabulates ``D(j) = lam^{j/2}`` (eq. 21).

    A scalar point gives the shared ``(tau,)`` table; an (m,)-vector point
    gives every agent its own decay constant — a ``(m, tau)`` table.
    """
    strat = cfg.strategy
    if not isinstance(strat, DecayStrategy):
        raise TypeError(
            f"'lam' axis needs a DecayStrategy base, got {type(strat).__name__}"
        )
    lam_arr = np.asarray(lam, np.float32)
    if lam_arr.ndim != 0 and lam_arr.shape != (strat.m,):
        raise ValueError(
            f"'lam' axis vector points must be ({strat.m},) for this "
            f"strategy, got shape {lam_arr.shape}"
        )
    w = exponential_decay_table(lam_arr, strat.tau)
    return dataclasses.replace(cfg, strategy=strat._copy(decay_weights=w))


def override_eps(cfg, eps):
    """Consensus step-size axis: rebuilds P, P^E and the mask-folded tables
    in fp32, or on a sparse strategy the ``(m, k_max)`` edge weights."""
    strat = cfg.strategy
    if not isinstance(strat, ConsensusStrategy):
        raise TypeError(
            f"'eps' axis needs a ConsensusStrategy base, got {type(strat).__name__}"
        )
    eps32 = np.float32(eps)
    if strat.sparse:
        strat = strat._copy(nl_w=neighbor_weights(strat.nl, eps32),
                            eps=float(eps32))
        return dataclasses.replace(cfg, strategy=strat)
    lap = np.asarray(laplacian(strat.topo), np.float32)
    p = np.eye(strat.m, dtype=np.float32) - eps32 * lap
    p_e = p
    for _ in range(strat.rounds - 1):
        p_e = np.matmul(p_e, p)
    mask_t = np.asarray(strat.mask, np.float32).T[:, None, :]   # (tau, 1, m)
    strat = strat._copy(p=p, p_e=p_e, p_masked=p[None] * mask_t,
                        p_e_masked=p_e[None] * mask_t, eps=float(eps32))
    return dataclasses.replace(cfg, strategy=strat)


def override_taus(cfg, taus):
    """Variation axis: the ``(m, tau)`` indicator mask of an (m,) schedule
    at the strategy's fixed period length tau (A2 checked; float32 carries
    integer schedules exactly), through ``with_mask``."""
    strat = cfg.strategy
    taus = np.asarray(taus)
    if taus.ndim != 1 or taus.shape[0] != strat.m:
        raise ValueError(
            f"'taus' axis points must be ({strat.m},) vectors for this "
            f"strategy, got shape {taus.shape}"
        )
    static_taus = np.asarray(taus, int)
    validate_a2(static_taus, strat.tau)
    mask = mask_from_taus(taus, strat.tau)
    return dataclasses.replace(cfg, strategy=strat.with_mask(mask, static_taus))


def hetero_uniforms(cfg, dir_seed: Optional[int], fields) -> torch.Tensor:
    """The ``(len(fields), m)`` U(-1, 1) directions of the hetero_scale axis
    from a CPU ``torch.Generator`` seeded by ``cfg.eval_seed``, the fold
    constant and the cell's ``dir_seed`` (when the point has one)."""
    seed = (int(cfg.eval_seed) * 1_000_003 + HETERO_FOLD) * 1_000_003
    if dir_seed is not None:
        seed += int(dir_seed) + 1
    gen = torch.Generator().manual_seed(seed % (2 ** 63))
    return 2.0 * torch.rand((len(fields), cfg.strategy.m), generator=gen) - 1.0


def override_hetero_scale(cfg, point, uniforms=None):
    """Fleet-heterogeneity axis: per-agent EnvParams magnitudes.

    Rebuilds ``cfg.env_params`` with :func:`repro_torch.rl.env.perturb_params`
    along fixed directions times the point's scale (scale 0: the homogeneous
    fleet). A scalar point shares one direction draw across the axis; a
    ``(scale, dir_seed)`` point draws its own. The directions are
    ``uniforms`` when given (e.g. the JAX package's draws of the same key),
    else :func:`hetero_uniforms`.
    """
    from repro_torch.rl.env import HETERO_FIELDS, perturb_params

    point = np.asarray(point, np.float32)
    if point.ndim == 0:
        scale, dir_seed = float(point), None
    elif point.shape == (2,):
        scale, dir_seed = float(point[0]), int(point[1])
    else:
        raise ValueError(
            "'hetero_scale' axis points must be scalars or (scale, dir_seed) "
            f"2-vectors, got shape {point.shape}"
        )
    if uniforms is None:
        uniforms = hetero_uniforms(cfg, dir_seed, HETERO_FIELDS)
    params = perturb_params(cfg.env, cfg.strategy.m, scale, HETERO_FIELDS,
                            uniforms=uniforms)
    return dataclasses.replace(cfg, env_params=params)


def _async_base(cfg, axis: str):
    from repro_torch.core.async_fed import AsyncStrategy

    strat = cfg.strategy
    if not isinstance(strat, AsyncStrategy):
        raise TypeError(f"'{axis}' axis needs an AsyncStrategy base, got "
                        f"{type(strat).__name__}")
    return strat


def _axis_uniforms(cfg, sched, uniforms):
    """The delay process's draws of a sweep point: ``uniforms`` when given,
    else those the base schedule was made from, else
    ``delay_uniforms(cfg.eval_seed, ...)`` (the JAX package's
    ``delay_axis_key(cfg.eval_seed)`` stream)."""
    from repro_torch.core.async_fed import delay_uniforms

    if uniforms is None:
        uniforms = sched.uniforms
    if uniforms is None:
        return delay_uniforms(cfg.eval_seed, sched.m, sched.n_periods)
    u = np.asarray(uniforms, np.float32)
    if u.shape != (sched.m, sched.n_periods):
        raise ValueError(f"uniforms must be ({sched.m}, {sched.n_periods}), "
                         f"got {u.shape}")
    return u


def override_delay(cfg, point, uniforms=None):
    """Asynchronous-arrival axis: a ``(dist_id, param)`` point redraws the
    run's schedule (:func:`repro_torch.core.async_fed.make_schedule`: its
    delays, renewal arrivals and staleness weights) on the base schedule's
    shape, from :func:`_axis_uniforms`.

    The run's schedule is concrete, so its own ledger bills its arrivals; a
    stacked run's accounting is the first run's (``stack_runs``), so
    benches rebuild each point's ledger from ``make_schedule`` on the same
    draws, as in JAX.
    """
    from repro_torch.core.async_fed import DELAY_DISTRIBUTIONS, make_schedule

    strat = _async_base(cfg, "delay")
    point = np.asarray(point, np.float32)
    if point.shape != (2,):
        raise ValueError("'delay' axis points must be (dist_id, param) "
                         f"2-vectors, got shape {point.shape}")
    names = {v: k for k, v in DELAY_DISTRIBUTIONS.items()}
    if int(point[0]) not in names:
        raise ValueError(f"'delay' axis: unknown distribution id {point[0]}")
    sched = strat.schedule
    return dataclasses.replace(cfg, strategy=strat.with_schedule(
        make_schedule(names[int(point[0])], float(point[1]), sched.m,
                      sched.n_periods,
                      uniforms=_axis_uniforms(cfg, sched, uniforms))))


def override_k(cfg, k, uniforms=None):
    """FedBuff buffer-size axis: a scalar point ``k`` re-selects the K
    freshest arrivals (:func:`repro_torch.core.async_fed.kofm_schedule`) on
    the lag process recorded on the K-of-m base schedule, drawn from
    :func:`_axis_uniforms`. Points must lie in ``1 <= k <= m``."""
    from repro_torch.core.async_fed import kofm_schedule

    strat = _async_base(cfg, "k")
    sched = strat.schedule
    if sched.k is None or sched.dist is None:
        raise ValueError(
            "'k' axis needs a K-of-m base schedule that records its lag "
            "process — build it with kofm_schedule(...)")
    k = np.asarray(k, np.float32)
    if k.ndim != 0:
        raise ValueError(f"'k' axis points must be scalars, got shape "
                         f"{k.shape}")
    return dataclasses.replace(cfg, strategy=strat.with_schedule(
        kofm_schedule(sched.m, sched.n_periods, int(k), dist=sched.dist,
                      param=sched.param,
                      uniforms=_axis_uniforms(cfg, sched, uniforms))))


OVERRIDES: Dict[str, Callable] = {
    "eta": override_eta,
    "lam": override_lam,
    "eps": override_eps,
    "taus": override_taus,
    "delay": override_delay,
    "k": override_k,
    "hetero_scale": override_hetero_scale,
}


def register_override(name: str, fn: Callable) -> None:
    """Register a custom batched axis: ``fn(cfg, value) -> cfg``."""
    if not callable(fn):
        raise TypeError("override must be callable")
    OVERRIDES[name] = fn


def compression_axis(points, name: str = "compression"):
    """Static sweep axis over payload transforms (``repro_torch.comm``).

    ``points`` is a sequence of :class:`~repro_torch.comm.PayloadTransform`
    objects (labelled by their ``label`` property) or explicit ``(label,
    transform)`` pairs. Each point swaps the strategy's ``comm`` via
    ``with_comm`` — static because the transform changes the program (its
    state and kernels), so the runner runs each point on its own.
    """
    from repro_torch.comm.transforms import PayloadTransform
    from repro_torch.sweep.spec import StaticAxis

    labelled = []
    for point in points:
        if isinstance(point, PayloadTransform):
            label, tr = point.label, point
        else:
            label, tr = point
            if not isinstance(tr, PayloadTransform):
                raise TypeError(
                    f"compression point {label!r} must carry a "
                    f"PayloadTransform, got {type(tr).__name__}"
                )

        def swap(cfg, _tr=tr):
            return dataclasses.replace(
                cfg, strategy=cfg.strategy.with_comm(_tr)
            )

        labelled.append((label, swap))
    return StaticAxis(name, tuple(labelled))


def algebraic_connectivity_axis(
    m: int,
    families=None,
    seed: int = 0,
    eps_frac: float = 0.5,
    name: str = "algebraic_connectivity",
    sparse=None,
):
    """Static sweep axis over graph families at fixed m: the lambda_2 figure.

    Each point builds one ``repro_torch.core.topology.GRAPH_FAMILIES`` member
    (``families`` optionally restricts/orders the labels), labels it with its
    exact algebraic connectivity ``mu2``, and swaps the base config's
    ConsensusStrategy for one on that topology with ``eps = eps_frac / Delta``
    (the per-family step size that keeps 0 < eps < 1/Delta as the degree
    changes). ``sparse`` forces the path (None = the density rule).
    """
    from repro_torch.core.topology import GRAPH_FAMILIES, mu2
    from repro_torch.sweep.spec import StaticAxis

    if not (0.0 < eps_frac < 1.0):
        raise ValueError(f"eps_frac={eps_frac} must be in (0, 1)")
    labels = list(families) if families is not None else list(GRAPH_FAMILIES)
    points = []
    for label in labels:
        try:
            build = GRAPH_FAMILIES[label]
        except KeyError:
            raise KeyError(
                f"unknown graph family {label!r}; have {sorted(GRAPH_FAMILIES)}"
            ) from None
        topo = build(m, seed)
        lam2 = mu2(topo)

        def swap(cfg, _topo=topo, _sparse=sparse):
            strat = cfg.strategy
            if not isinstance(strat, ConsensusStrategy):
                raise TypeError(
                    "'algebraic_connectivity' axis needs a ConsensusStrategy "
                    f"base, got {type(strat).__name__}"
                )
            if strat.m != _topo.m:
                raise ValueError(
                    f"axis topology has m={_topo.m} but the base strategy "
                    f"has m={strat.m}"
                )
            new = ConsensusStrategy(
                tau=strat.tau,
                topo=_topo,
                eps=eps_frac / _topo.max_degree,
                rounds=strat.rounds,
                taus=strat.taus,
                fused=strat.fused,
                sparse=_sparse,
            )
            if strat.comm.enabled:
                new = new.with_comm(strat.comm)
            return dataclasses.replace(cfg, strategy=new)

        points.append((f"{label}(mu2={lam2:.3f})", swap))
    return StaticAxis(name, tuple(points))


def apply_overrides(cfg, names, values):
    """Apply registered overrides in axis order (one run's config)."""
    for name, value in zip(names, values):
        try:
            fn = OVERRIDES[name]
        except KeyError:
            raise KeyError(
                f"no override registered for vmapped axis {name!r}; "
                f"have {sorted(OVERRIDES)}"
            ) from None
        cfg = fn(cfg, value)
    return cfg
