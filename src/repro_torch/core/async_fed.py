"""Asynchronous, staleness-aware federation: FedBuff-style buffered averaging.

The counterpart of ``repro.core.async_fed``. Arrival delays are a per-agent
staleness schedule over the T period boundaries, an ``(m, T)`` table made
on the host before the run; at each boundary the server averages whichever
replicas have "arrived", weighted by their staleness, and only those
replicas rebase onto the new server reference.

Pieces:

* :func:`delay_uniforms` — the ``(m, T)`` U(1e-6, 1 - 1e-6) draws behind a
  schedule, from a CPU ``torch.Generator`` seeded by the config's
  ``eval_seed`` and a fold constant. The JAX package's threefry stream
  cannot be reproduced, so every constructor also takes ``uniforms`` (e.g.
  the JAX package's draws of the same key).
* :func:`delay_draws` — per-(agent, period) delays for three families
  (deterministic lag / geometric / heavy-tail discrete Pareto), in fp32 and
  in the JAX package's order of operations.
* :func:`renewal_arrivals` — delays to the ``(m, T)`` arrival mask and
  staleness ages: an agent whose last sync was ``s`` boundaries ago arrives
  once ``s`` exceeds its current draw, with age ``s - 1``.
* :func:`kofm_schedule` — the buffered FedBuff variant: at every boundary
  exactly the K agents of smallest effective staleness arrive (ties by agent
  index). This one host implementation stands in for the JAX package's
  ``kofm_schedule`` and its traced twin ``kofm_arrivals`` (the ``k`` axis).
* :func:`masked_server_step` — the staleness-weighted mean over the arrived
  replicas, from the dispatch's ``scale_rows`` and ``row_mean`` (the
  ``decay_accum`` and ``row_mean`` kernels on the card).
* :class:`AsyncStrategy` — the strategy: at boundary ``t`` the server
  averages the arrivals of schedule column ``t``, arrived replicas rebase
  onto the new reference, the others keep training against their last-seen
  one (``ref`` in the comm state).

Zero delay is bitwise synchronous: every weight is exactly 1.0 and the
correction ``m / sum(w)`` exactly 1.0, so the server step is the
synchronous ``row_mean`` bit for bit (on the card ``scale_rows`` computes
``g + 0 * g``, which is ``g``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.decay import DecayFn, no_decay
from repro_torch.core.strategies import AggregationStrategy
from repro_torch.core.variation import masked_update_counts, validate_a2
from repro_torch.kernels import dispatch

# Distribution ids: a ``delay`` sweep-axis point is the 2-vector
# (dist_id, param).
DELAY_DISTRIBUTIONS = {"deterministic": 0, "geometric": 1, "heavytail": 2}

# The fold constant of the delay process's uniforms (the JAX package folds
# the same constant into its eval key; the hetero_scale axis uses 2026).
DELAY_FOLD = 2027
_U_LO, _U_HI = 1e-6, 1.0 - 1e-6


def delay_uniforms(eval_seed: int, m: int, n_periods: int) -> np.ndarray:
    """The ``(m, n_periods)`` fp32 U(1e-6, 1 - 1e-6) draws of the delay
    process of a config with ``eval_seed``, from a CPU ``torch.Generator``
    seeded by ``eval_seed`` and :data:`DELAY_FOLD`."""
    seed = (int(eval_seed) * 1_000_003 + DELAY_FOLD) * 1_000_003
    gen = torch.Generator().manual_seed(seed % (2 ** 63))
    u = torch.rand((int(m), int(n_periods)), generator=gen)
    lo = torch.tensor(_U_LO, dtype=torch.float32)
    hi = torch.tensor(_U_HI, dtype=torch.float32)
    return torch.clamp(u * (hi - lo) + lo, lo, hi).numpy()


def delay_draws(dist_id, param, n_periods: int, uniforms) -> np.ndarray:
    """Per-(agent, period) delay draws from ``uniforms (m, T)``: ``(m, T)``
    fp32, values in ``[0, n_periods]``.

    * ``0`` deterministic — every draw is ``floor(param + 0.5)``;
    * ``1`` geometric — ``floor(log1p(-u) / log1p(-p))``, ``p = param``
      clipped to [1e-4, 1 - 1e-4] (failures before the first success);
    * ``2`` heavy-tail — discrete Pareto ``floor(u ** (-1 / alpha)) - 1``,
      ``alpha = max(param, 1e-2)``.

    Clipped to ``n_periods``: a longer delay never arrives within the run.
    """
    u = torch.from_numpy(np.array(uniforms, np.float32))
    dist_id = int(dist_id)
    if dist_id not in DELAY_DISTRIBUTIONS.values():
        raise ValueError(f"unknown delay distribution id {dist_id}")
    param = torch.tensor(float(param), dtype=torch.float32)
    if dist_id == DELAY_DISTRIBUTIONS["deterministic"]:
        out = torch.floor(param + 0.5) * torch.ones_like(u)
    elif dist_id == DELAY_DISTRIBUTIONS["geometric"]:
        p = torch.clamp(param, 1e-4, 1.0 - 1e-4)
        out = torch.floor(torch.log1p(-u) / torch.log1p(-p))
    else:
        alpha = torch.clamp(param, min=1e-2)
        out = torch.floor(torch.pow(u, -1.0 / alpha)) - 1.0
    return torch.clamp(out, 0.0, float(n_periods)).numpy()


def renewal_arrivals(delays):
    """Delay draws -> ``(arrive, age)``, both ``(m, T)`` fp32.

    Per agent, ``since`` counts the boundaries since its last sync (every
    replica starts freshly broadcast). At boundary ``t`` the agent arrives
    iff ``since > delays[:, t]``; ``age[:, t] = since - 1`` is the staleness
    its contribution would carry (0 = fresh).
    """
    delays = np.asarray(delays, np.float32)
    m, T = delays.shape
    c = np.zeros(m, np.float32)
    arrive = np.zeros((m, T), np.float32)
    age = np.zeros((m, T), np.float32)
    for t in range(T):
        since = c + np.float32(1.0)
        arrive[:, t] = (since > delays[:, t]).astype(np.float32)
        age[:, t] = since - np.float32(1.0)
        c = np.where(arrive[:, t] > 0.0, np.float32(0.0), since)
    return arrive, age


@dataclasses.dataclass(frozen=True)
class DelaySchedule:
    """A precomputed arrival schedule over ``n_periods`` boundaries.

    ``arrive`` / ``age`` are ``(m, n_periods)`` fp32 numpy arrays. ``k`` is
    the FedBuff buffer size of a K-of-m schedule (None for renewal ones);
    ``dist`` / ``param`` the lag process that made it, and ``uniforms`` the
    draws it was made from when they were given (the ``delay`` and ``k``
    sweep axes redraw from them, else from the config's ``eval_seed``).
    """

    arrive: np.ndarray
    age: np.ndarray
    n_periods: int
    label: str
    k: Optional[int] = None
    dist: Optional[str] = None
    param: Optional[float] = None
    uniforms: Optional[np.ndarray] = dataclasses.field(default=None,
                                                       compare=False)

    @property
    def m(self) -> int:
        return int(np.shape(self.arrive)[0])

    def arrivals_per_period(self) -> np.ndarray:
        """(n_periods,) int arrival counts."""
        return np.asarray(self.arrive).sum(axis=0).astype(int)

    def total_arrivals(self, start: int = 0, n: Optional[int] = None) -> int:
        counts = self.arrivals_per_period()
        n = len(counts) - start if n is None else n
        return int(counts[start:start + n].sum())


def _dist_id(dist: str) -> int:
    try:
        return DELAY_DISTRIBUTIONS[dist]
    except KeyError:
        raise KeyError(
            f"unknown delay distribution {dist!r}; "
            f"have {sorted(DELAY_DISTRIBUTIONS)}"
        ) from None


def _uniforms(uniforms, seed: int, m: int, n_periods: int) -> np.ndarray:
    if uniforms is None:
        return delay_uniforms(seed, m, n_periods)
    u = np.asarray(uniforms, np.float32)
    if u.shape != (m, n_periods):
        raise ValueError(f"uniforms must be ({m}, {n_periods}), got {u.shape}")
    return u


def make_schedule(dist: str, param: float, m: int, n_periods: int, *,
                  seed: int = 0, uniforms=None) -> DelaySchedule:
    """Renewal schedule of one named delay distribution.

    The draws are ``uniforms`` when given, else :func:`delay_uniforms` of
    ``seed`` (the run config's ``eval_seed`` when the schedule must equal a
    ``delay``-axis cell). ``dist='deterministic', param=0`` is the
    zero-delay schedule: every agent arrives at every boundary with age 0.
    """
    dist_id = _dist_id(dist)
    u = _uniforms(uniforms, seed, m, n_periods)
    arrive, age = renewal_arrivals(delay_draws(dist_id, param, n_periods, u))
    return DelaySchedule(
        arrive=arrive, age=age, n_periods=int(n_periods),
        label=f"{dist}({param:g})", dist=dist, param=float(param),
        uniforms=None if uniforms is None else u,
    )


def kofm_schedule(m: int, n_periods: int, k: int, *,
                  dist: str = "geometric", param: float = 0.5,
                  seed: int = 0, uniforms=None) -> DelaySchedule:
    """FedBuff buffered schedule: the K freshest replicas arrive each period.

    On the lag draws of ``(dist, param)`` (from ``uniforms`` or
    :func:`delay_uniforms` of ``seed``), per boundary: effective staleness
    ``eff = since - 1 + lag``; the ``k`` smallest-``eff`` agents arrive (a
    stable sort: ties by agent index), their clocks reset, and the recorded
    age is ``eff`` for everyone. With ``k = m`` and zero lag this is the
    synchronous schedule.
    """
    if not 1 <= k <= m:
        raise ValueError(f"need 1 <= k <= m, got k={k} m={m}")
    u = _uniforms(uniforms, seed, m, n_periods)
    lag = delay_draws(_dist_id(dist), param, n_periods, u)
    c = np.zeros(m, np.float32)
    arrive = np.zeros((m, n_periods), np.float32)
    age = np.zeros((m, n_periods), np.float32)
    for t in range(n_periods):
        since = c + np.float32(1.0)
        eff = since - np.float32(1.0) + lag[:, t]
        sel = np.lexsort((np.arange(m), eff))[:k]
        arrive[sel, t] = 1.0
        age[:, t] = eff
        c = since
        c[sel] = 0.0
    return DelaySchedule(
        arrive=arrive, age=age, n_periods=int(n_periods),
        label=f"fedbuff(k={k},{dist}({param:g}))", k=int(k), dist=dist,
        param=float(param), uniforms=None if uniforms is None else u,
    )


def stale_weight_table(decay: Optional[DecayFn], n_periods: int) -> np.ndarray:
    """Staleness-decay lookup ``D(age)`` for ages ``0..n_periods``, fp32.

    The ``repro_torch.core.decay`` families over ages instead of period
    offsets, under A3: ``D(0) = 1`` (a fresh arrival is never down-weighted,
    which keeps zero delay bitwise synchronous), non-increasing, >= 0.
    """
    decay = decay or no_decay()
    w = torch.as_tensor(decay(torch.arange(n_periods + 1))).to(
        torch.float32).numpy()
    if w[0] != 1.0 or np.any(np.diff(w) > 1e-7) or np.any(w < -1e-7):
        raise ValueError(
            "staleness decay must satisfy D(0)=1, non-increasing, >= 0 "
            "over the schedule horizon (A3 over ages)"
        )
    return w


def sync_weight_table(arrive, age, table) -> np.ndarray:
    """Per-boundary server weights ``arrive * D(age)``, fp32 ``(m, T)``.
    Zero delay gives exactly 1.0 everywhere."""
    table = np.asarray(table, np.float32)
    idx = np.clip(np.asarray(age).astype(np.int32), 0, table.shape[0] - 1)
    return np.asarray(arrive, np.float32) * table[idx]


def masked_server_step(flat: torch.Tensor, w):
    """FedBuff server row: the staleness-weighted mean over the arrived
    replicas, ``row_mean(scale_rows(flat, w)) * m / sum(w)`` in fp32.

    ``flat`` is ``(m, n)`` with ``(m,)`` weights, or ``(S, m, n)`` with
    ``(S, m)`` weights (never 1-D: with S == m that would be ambiguous).
    Returns ``(row, denom)``, both on ``flat``'s device: ``row`` ``(n,)`` /
    ``(S, n)`` in ``flat.dtype``, ``denom`` the weights' sum ``()`` /
    ``(S,)``. Where nothing arrived (``denom == 0``) the row is not finite;
    the caller keeps its previous reference there.
    """
    m = flat.shape[-2]
    w = torch.as_tensor(w, dtype=torch.float32, device=flat.device)
    if tuple(w.shape) != tuple(flat.shape[:-1]):
        raise ValueError(f"masked_server_step: w must be "
                         f"{tuple(flat.shape[:-1])} for flat "
                         f"{tuple(flat.shape)}, got {tuple(w.shape)}")
    mean = dispatch.row_mean(dispatch.scale_rows(flat, w))
    denom = w.sum(-1)
    row = (mean.float() * (m / denom).unsqueeze(-1)).to(flat.dtype)
    return row, denom


@dataclasses.dataclass(frozen=True)
class AsyncStrategy(AggregationStrategy):
    """Asynchronous staleness-aware federation (FedBuff-style buffering).

    At boundary ``t`` the server averages the replicas of schedule column
    ``t`` with staleness-decay weights (:func:`masked_server_step`), the
    arrived replicas rebase onto the new server reference and the others
    keep training against their last-seen one (``ref`` in the comm state).
    The per-agent tau_i masks apply within periods as usual.

    The drivers' epoch evaluations and final readout poll every replica,
    as on the synchronous path. Optimizer moments stay local at a boundary
    (FedBuff keeps no server momentum). Compressed uplinks are refused.
    """

    schedule: DelaySchedule = None
    stale_table: np.ndarray = None   # (n_periods + 1,) D(age)
    sync_weights: np.ndarray = None  # (m, n_periods); stacked (S, m, T)

    is_async = True
    uniform_sync = False
    # the runs' (S, m, T) arrivals when stacked (stack_runs); a class
    # attribute, not a field
    run_arrive = None

    def __init__(self, tau: int, schedule: DelaySchedule, taus=None,
                 m: Optional[int] = None,
                 stale_decay: Optional[DecayFn] = None):
        if not isinstance(schedule, DelaySchedule):
            raise TypeError(f"AsyncStrategy needs a DelaySchedule, got "
                            f"{type(schedule).__name__}")
        m_s = schedule.m
        if m is not None and int(m) != m_s:
            raise ValueError(f"m={m} but the schedule carries m={m_s} agents")
        if taus is None:
            taus = np.full(m_s, tau, int)
        taus = np.asarray(taus, int)
        if len(taus) != m_s:
            raise ValueError(
                f"taus carries {len(taus)} agents, schedule m={m_s}")
        validate_a2(taus, tau)
        table = stale_weight_table(stale_decay, schedule.n_periods)
        AggregationStrategy.__init__(
            self, name=f"async({schedule.label},tau={tau})", tau=tau,
            taus=taus, mask=self._build_mask(taus, tau))
        object.__setattr__(self, "schedule", schedule)
        object.__setattr__(self, "stale_table", table)
        object.__setattr__(self, "sync_weights", sync_weight_table(
            schedule.arrive, schedule.age, table))

    def with_schedule(self, schedule: DelaySchedule) -> "AsyncStrategy":
        """Copy with another schedule of the same shape (a sweep point),
        its weights refolded through this strategy's staleness table."""
        if (schedule.m, schedule.n_periods) != (self.m,
                                                self.schedule.n_periods):
            raise ValueError(
                f"with_schedule: schedule is ({schedule.m}, "
                f"{schedule.n_periods}), this strategy ({self.m}, "
                f"{self.schedule.n_periods})")
        return self._copy(
            schedule=schedule,
            sync_weights=sync_weight_table(schedule.arrive, schedule.age,
                                           self.stale_table))

    # --- driver seams -------------------------------------------------------
    def validate_horizon(self, n_periods: int) -> None:
        """Fail fast when a run outlives the schedule."""
        if self.schedule.n_periods < n_periods:
            raise ValueError(
                f"delay schedule covers {self.schedule.n_periods} periods "
                f"but the run has {n_periods}")

    def with_comm(self, comm) -> "AsyncStrategy":
        if getattr(comm, "enabled", False):
            raise NotImplementedError(
                "compressed uplinks are not supported on the async path")
        return super().with_comm(comm)

    def init_comm_state(self, flat: torch.Tensor) -> dict:
        """The fp32 server reference non-arrivals train against (all
        replicas start broadcast, so row 0 is the server)."""
        return {"ref": flat[..., 0, :].to(torch.float32, copy=True)}

    def _column_tables(self, device):
        """The weights and arrivals by boundary, ``(T, m)`` (stacked: ``(T,
        S, m)``), on ``device`` once, so that ``[period]`` is a contiguous
        operand."""
        def by_period(table):
            return lambda: np.ascontiguousarray(
                np.moveaxis(np.asarray(table, np.float32), -1, 0))

        arrive = self.schedule.arrive if self.runs is None else self.run_arrive
        return (self._on("sync_weights_t", by_period(self.sync_weights),
                         device),
                self._on("arrive_t", by_period(arrive), device))

    def flat_sync(self, flat: torch.Tensor, comm_state: dict, *, period=None):
        """Buffered aggregation at boundary ``period``, in place.

        Reads column ``period`` of the weight and arrival tables; where the
        weights sum to 0 (nothing arrived) the reference is kept, per run,
        by ``torch.where`` (no value is read back to the host); only the
        arrived rows are rebased onto the reference. Returns ``(flat,
        comm_state)`` with ``flat`` the same buffer.
        """
        if period is None:
            raise ValueError(
                "AsyncStrategy.flat_sync needs the period index; the flat "
                "driver passes it")
        weights, arrive = self._column_tables(flat.device)
        row, denom = masked_server_step(flat, weights[period])
        ref = torch.where((denom > 0.0).unsqueeze(-1), row.float(),
                          comm_state["ref"])
        flat.copy_(torch.where(arrive[period].unsqueeze(-1) > 0.0,
                               ref.unsqueeze(-2).to(flat.dtype), flat))
        return flat, dict(comm_state, ref=ref)

    def server_row(self, flat: torch.Tensor, comm_state: dict) -> torch.Tensor:
        """The buffered server reference (replicas are not re-broadcast)."""
        return comm_state["ref"].to(flat.dtype)

    # --- accounting -----------------------------------------------------------
    def comm_events_per_period(self) -> dict:
        raise NotImplementedError(
            "async arrivals are non-uniform across periods; the ledger "
            "bills them via comm_events_span")

    def comm_events_span(self, start: int, n_periods: int) -> dict:
        """Totals over boundaries ``[start, start + n_periods)``: C1 the
        arrivals (only an arrived replica uplinks), C2 ``sum(tau_i)`` per
        period (every agent trains)."""
        if start < 0 or start + n_periods > self.schedule.n_periods:
            raise ValueError(
                f"period span [{start}, {start + n_periods}) outside the "
                f"schedule horizon {self.schedule.n_periods}")
        return {"c1": self.schedule.total_arrivals(start, n_periods),
                "c2": int(np.sum(self.taus)) * n_periods, "w1": 0, "w2": 0}

    def comm_events_partial_period(self, n_offsets: int) -> dict:
        """A trailing partial period reaches no boundary: no uplinks, only
        its local updates, so a run's wire bytes are its arrivals times
        the payload."""
        n_offsets = int(n_offsets)
        if not 0 <= n_offsets < self.tau:
            raise ValueError(
                f"partial period must satisfy 0 <= n_offsets < tau="
                f"{self.tau}, got {n_offsets}")
        return {"c1": 0,
                "c2": int(masked_update_counts(self.taus, n_offsets).sum()),
                "w1": 0, "w2": 0}
