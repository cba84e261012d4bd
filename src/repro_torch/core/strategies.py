"""Aggregation strategies: the paper's methods on the flat ``(m, n)`` carry.

The counterpart of ``repro.core.strategies``. A strategy owns (a) the
within-period transform applied at each local update (the variation mask,
times the decay factor for the decay method, or the consensus gossip mix),
(b) the variation masks I(tau_i > s - t0), (c) the period length tau and
(d) the payload transform ``comm`` (``repro_torch.comm``) applied to what it
communicates. The server averaging step (eq. 11) is the same for every
strategy: the mean over the replica axis.

The hot path runs through the port's dispatch: the weighted SGD step is one
``decay_accum`` launch with ``d = -eta * w`` (the weight folds into the
coefficient), the momentum/Adam steps one fused optimizer launch, the dense
gossip one ``consensus_step`` launch with the mask folded into ``P^E``, the
sparse gossip E ``consensus_gather`` launches, and the period sync one
``row_mean`` launch whose row is copied back into every row of the carry
(one ``topk_scatter`` launch for a top-k uplink). Where the buffers lie
picks the path: the hand-written kernels on the card, the plain PyTorch
versions on the CPU. Every table a step reads (weights, mixing matrices,
neighbour lists) is copied to a device once and kept there.

Runs. :func:`stack_runs` makes one strategy of S strategies that differ
only in their values (the sweep's runs: masks, decay tables, mixing
matrices, edge weights): every hot-path table gains a run axis (the weight
table ``(tau, S, m)``, ``P`` ``(S, m, m)``, the folded tables ``(tau, S, m,
m)``, the edge weights ``(S, m, k_max)``), and the same methods step an
``(S, m, n)`` carry, one dispatch call (one launch) per primitive for all
runs. The learning rate may then be one number or an ``(S,)`` tensor, one
per run.

Trees. :meth:`AggregationStrategy.transform`, ``local_update`` and
``server_average`` take nested dicts of ``(m, ...)`` tensors, as the JAX
package's tree-space methods do. Like its kernel backends
(``src/repro/core/strategies.py:216-218``, ``:257-259``) they ravel the tree
once (``dispatch.stacked_ravel_spec``), run the flat method and unravel, so
there is no second, tree-shaped arithmetic: on the card they launch
``scale_rows`` / ``decay_accum``, ``consensus_step`` or
``consensus_gather``, and ``row_mean``. Where the JAX package's jnp tree
path rounds otherwise (``p - eta * (w * g)`` against the fused ``p + (-eta *
w) * g``) the port computes the flat form.

``AsyncStrategy`` (FedBuff-style buffered averaging over a delay
schedule) lives in ``repro_torch.core.async_fed``; ``make_strategy("async",
...)`` builds it and :func:`stack_runs` stacks its schedules.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import hashlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.comm.transforms import IDENTITY, PayloadTransform
from repro_torch.core.decay import DecayFn, no_decay
from repro_torch.core.topology import (
    NeighborList,
    Topology,
    density,
    mixing_matrix,
    neighbor_list,
    neighbor_weights_from_matrix,
)
from repro_torch.core.variation import masked_update_counts, validate_a2
from repro_torch.kernels import dispatch


# --- mixing-matrix power cache ---------------------------------------------------
#
# ConsensusStrategy needs P = I - eps*La (cheap) and, on the dense path, P^E via
# np.linalg.matrix_power (O(m^3 log E)). Keyed by (adjacency digest, m, eps,
# rounds) in a bounded LRU; P^E is filled lazily so sparse strategies never pay
# the matrix power. Cache hits return the same ndarray objects.

_POWER_CACHE_MAXSIZE = 32
_POWER_CACHE: "collections.OrderedDict" = collections.OrderedDict()


def _topology_digest(topo: Topology) -> str:
    return hashlib.sha1(
        np.ascontiguousarray(topo.adj, np.int8).tobytes()
    ).hexdigest()


def clear_power_cache() -> None:
    """Drop all cached mixing-matrix powers (tests)."""
    _POWER_CACHE.clear()


def mixing_powers(topo: Topology, eps: float, rounds: int, *,
                  need_power: bool = True):
    """Cached ``(P_float64, P_fp32, P^rounds_fp32)`` for one consensus config.

    ``P^rounds`` is ``None`` until some caller passes ``need_power=True`` (the
    dense path); it is computed from the fp32 ``P`` exactly as the JAX package
    computes it, so the tables are identical.
    """
    key = (_topology_digest(topo), topo.m, float(eps), int(rounds))
    entry = _POWER_CACHE.get(key)
    if entry is None:
        p64 = mixing_matrix(topo, eps)
        entry = {"p64": p64, "p": p64.astype(np.float32), "p_e": None}
        _POWER_CACHE[key] = entry
        if len(_POWER_CACHE) > _POWER_CACHE_MAXSIZE:
            _POWER_CACHE.popitem(last=False)
    else:
        _POWER_CACHE.move_to_end(key)
    if need_power and entry["p_e"] is None:
        entry["p_e"] = np.linalg.matrix_power(entry["p"], rounds).astype(
            np.float32
        )
    return entry["p64"], entry["p"], entry["p_e"]


# Sparse-path auto selection: gather beats the dense mix once the graph is
# sparse AND the agent count is big enough for O(m*k) vs O(m^2) to matter.
SPARSE_DENSITY_THRESHOLD = 0.25
SPARSE_MIN_AGENTS = 64


@dataclasses.dataclass(frozen=True)
class AggregationStrategy:
    """Variation-aware periodic averaging (the paper's base method, T2).

    Attributes:
      tau: local updates per period for the pacing agent (period length).
      taus: per-agent tau_i (A2); shape (m,).
      mask: (m, tau) float32 indicator I(tau_i > j) for period offset j.
      comm: payload transform applied to what the strategy communicates
        (``repro_torch.comm``): uplink deltas at the period sync and, on the
        consensus path, the gossip payloads. The identity default keeps the
        dense behaviour exactly; a compressed transform adds per-agent
        error-feedback state to the run's ``comm_state``.
    """

    name: str
    tau: int
    taus: np.ndarray
    mask: np.ndarray
    comm: PayloadTransform = IDENTITY

    # runs of a stacked strategy (stack_runs); None for one run (a class
    # attribute, not a field)
    runs = None
    # the async strategy (core/async_fed.py) syncs only the replicas that
    # arrive, at non-uniform boundaries; the ledger and the driver ask
    is_async = False
    uniform_sync = True

    @staticmethod
    def _build_mask(taus: np.ndarray, tau: int) -> np.ndarray:
        offs = np.arange(tau)[None, :]
        return (np.asarray(taus)[:, None] > offs).astype(np.float32)

    def _copy(self, **fields) -> "AggregationStrategy":
        """A copy with ``fields`` replaced; device tables and scratch
        buffers are not shared with the original."""
        new = copy.copy(self)
        for k, v in fields.items():
            object.__setattr__(new, k, v)
        new.__dict__.pop("_scratch", None)
        new.__dict__.pop("_on_device", None)
        return new

    def with_mask(self, mask, taus=None) -> "AggregationStrategy":
        """Copy with a replacement ``(m, tau)`` variation mask (the sweep's
        ``taus`` axis); ``tau`` and the topology stay. ``taus`` refreshes the
        per-agent schedule the host-side accounting reads; without it the
        accounting keeps the previous one."""
        mask = np.asarray(mask, np.float32)
        if mask.shape != (self.m, self.tau):
            raise ValueError(f"with_mask: mask must be ({self.m}, {self.tau}),"
                             f" got {mask.shape}")
        fields = {"mask": mask}
        if taus is not None:
            fields["taus"] = np.asarray(taus, int)
        return self._copy(**fields)

    def with_comm(self, comm: PayloadTransform) -> "AggregationStrategy":
        """Copy with a replacement payload transform."""
        if not isinstance(comm, PayloadTransform):
            raise TypeError(
                f"with_comm expects a PayloadTransform, got {type(comm).__name__}"
            )
        return self._copy(comm=comm)

    @property
    def m(self) -> int:
        return len(self.taus)

    def _scaled(self, c, w):
        """``c * w``: a coefficient (a number, or one per run ``(S,)``) times
        the weights (``(m,)``, or ``(S, m)`` stacked), in fp32."""
        if isinstance(c, torch.Tensor) and c.ndim == 1:
            return c[:, None] * w
        return c * w

    def _per_run(self, c, like: torch.Tensor):
        """A coefficient of the stacked carry ``like`` (S, m, n) as the
        dispatch takes it unambiguously: a per-run ``(S,)`` tensor becomes
        ``(S, m)``; a number stays as it is."""
        if isinstance(c, torch.Tensor) and c.ndim == 1:
            return c[:, None].expand(like.shape[0], like.shape[1]).contiguous()
        return c

    # --- tables on the device, scratch buffers -----------------------------------
    def _on(self, name: str, table, device) -> torch.Tensor:
        """The host table ``table()`` as a tensor on ``device``, copied once
        per device and kept (a step never copies a table)."""
        cache: Dict = self.__dict__.setdefault("_on_device", {})
        key = (name, str(torch.device(device)))
        if key not in cache:
            cache[key] = torch.tensor(table(), device=device)
        return cache[key]

    def _buffers(self, like: torch.Tensor):
        """Two preallocated buffers shaped like ``like``, for the gossip
        rounds to ping-pong between (gossip cannot run in place)."""
        cache: Dict = self.__dict__.setdefault("_scratch", {})
        key = (tuple(like.shape), like.dtype, str(like.device))
        if key not in cache:
            cache[key] = tuple(torch.empty(like.shape, dtype=like.dtype,
                                           device=like.device)
                               for _ in range(2))
        return cache[key]

    # --- per-step weights ---------------------------------------------------------
    def weight_table(self) -> np.ndarray:
        """``(tau, m)`` fp32: row j is the per-agent weight at offset j (the
        mask column by default); ``(tau, S, m)`` when stacked."""
        if self.runs is not None:
            return self.run_weights
        return np.ascontiguousarray(self.mask.T)

    def weights_on(self, device) -> torch.Tensor:
        """:meth:`weight_table` on ``device``, made once per device; row j
        is a contiguous ``(m,)`` (stacked: ``(S, m)``) view."""
        return self._on("weights", self.weight_table, device)

    def weight(self, offset: int, device="cpu") -> torch.Tensor:
        """Per-agent weight vector ``(m,)`` (stacked: ``(S, m)``) at period
        offset ``offset``."""
        return self.weights_on(device)[offset]

    # --- flat (m, n) hot path -----------------------------------------------------
    def flat_transform(self, g: torch.Tensor, offset: int) -> torch.Tensor:
        """The within-period transform on flat ``(m, n)`` grads, into a new
        tensor: each row times its weight at ``offset`` (``scale_rows``)."""
        return dispatch.scale_rows(g, self.weight(offset, g.device))

    def flat_update(self, params: torch.Tensor, g: torch.Tensor, offset: int,
                    eta: float, *, out: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """Fused transform + local SGD step: ``params - eta * w * g``.

        The weight folds into the accumulation coefficient ``-eta * w`` (fp32,
        as ``strategies.py:243`` computes it), so the whole local update is
        one ``decay_accum`` pass. ``out`` may be ``params``.
        """
        return dispatch.decay_accum(
            params, g, self._scaled(-eta, self.weight(offset, params.device)),
            out=out)

    def flat_opt_step(self, params, g, offset: int, eta: float, opt,
                      opt_state: dict, *, inplace: bool = False):
        """Fused transform + optimizer update on the flat carry; the weight
        folds into the gradient before moment accumulation. Returns
        ``(params, opt_state)``."""
        return opt.update(params, g, self.weight(offset, params.device),
                          opt_state, eta, inplace=inplace)

    def flat_server_average(self, flat: torch.Tensor) -> torch.Tensor:
        """Eq. (11) on the flat carry: the ``(n,)`` mean over the agent axis
        (fp32 accumulation, in ``flat.dtype``)."""
        return dispatch.row_mean(flat)

    # --- tree space ---------------------------------------------------------------
    def transform(self, grads_m, offset: int):
        """:meth:`flat_transform` on a tree of ``(m, ...)`` grads: a new tree
        of the same layout."""
        flat, spec = dispatch.stacked_ravel_spec(grads_m)
        return spec.unravel(self.flat_transform(flat, offset))

    def local_update(self, params_m, grads_m, offset: int, eta: float):
        """One local step on trees of ``(m, ...)`` replicas: the transform
        and the SGD step of :meth:`flat_update`, into a new tree. The grads
        must have the params' layout."""
        p, spec = dispatch.stacked_ravel_spec(params_m)
        g = spec.ravel(grads_m, out=torch.empty_like(p))
        return spec.unravel(self.flat_update(p, g, offset, eta, out=p))

    def server_average(self, params_m):
        """Eq. (11) on a tree of ``(m, ...)`` replicas: the tree of the
        replica means (leaves without the agent axis), by ``row_mean``."""
        flat, spec = dispatch.stacked_ravel_spec(params_m)
        return spec.unravel_one(self.flat_server_average(flat))

    @staticmethod
    def _broadcast_rows(flat: torch.Tensor, row: torch.Tensor) -> None:
        """Copy the server row (``(n,)``; stacked ``(S, n)``) into every
        agent row of ``flat``."""
        flat.copy_(row.unsqueeze(-2).expand_as(flat))

    # --- comm layer (payload transforms + error feedback) -------------------------
    def init_comm_state(self, flat: torch.Tensor) -> dict:
        """Comm-layer state for a flat ``(m, n)`` run: ``{}`` when dense.

        With a compressed ``comm``: ``ref``, the fp32 server reference the
        uplink deltas are taken against (a copy of row 0: all replicas start
        equal), plus the ``(m, n)`` fp32 ``err_up`` uplink error-feedback
        accumulator when enabled.
        """
        if not self.comm.enabled:
            return {}
        state = {"ref": flat[..., 0, :].to(torch.float32, copy=True)}
        if self.comm.error_feedback:
            state["err_up"] = torch.zeros(flat.shape, dtype=torch.float32,
                                          device=flat.device)
        return state

    def flat_local_step(self, flat: torch.Tensor, g: torch.Tensor,
                        offset: int, eta: float, opt, opt_state: dict,
                        comm_state: dict):
        """One local step on the flat carry, in place: plain SGD
        (``opt is None``) or the fused optimizer step. The base strategies
        communicate nothing within a period, so ``comm_state`` passes
        through. Returns ``(flat, opt_state, comm_state)`` with ``flat`` the
        same buffer, updated."""
        if opt is None:
            self.flat_update(flat, g, offset, eta, out=flat)
        else:
            flat, opt_state = self.flat_opt_step(flat, g, offset, eta, opt,
                                                 opt_state, inplace=True)
        return flat, opt_state, comm_state

    def flat_sync(self, flat: torch.Tensor, comm_state: dict, *, period=None):
        """Period-boundary server sync, in place; returns ``(flat,
        comm_state)`` with ``flat`` the same buffer, every row the server row.

        Dense (identity comm): eq. (11), the row mean copied into every row
        of the contiguous carry (the JAX package broadcasts; a stride-0 view
        here would alias every row of a buffer the kernels later write in
        place). Compressed: each agent uplinks ``encode(flat_i - ref +
        err_i)``; the server averages the reconstructions in fp32
        (``PayloadTransform.reduce_mean``: the ``topk_scatter`` kernel for
        top-k), advances ``ref`` by the mean payload, and the unsent
        remainder becomes the next ``err_up``. ``period`` is the index of
        the boundary; the synchronous strategies ignore it.
        """
        del period
        if not self.comm.enabled:
            self._broadcast_rows(flat, self.flat_server_average(flat))
            return flat, comm_state
        ref = comm_state["ref"]
        delta = flat.float() - ref.unsqueeze(-2)
        if self.comm.error_feedback:
            delta = delta + comm_state["err_up"]
        mean_sent, residual = self.comm.reduce_mean(delta)
        row = ref + mean_sent
        new_state = dict(comm_state, ref=row)
        if self.comm.error_feedback:
            new_state["err_up"] = residual
        self._broadcast_rows(flat, row.to(flat.dtype))
        return flat, new_state

    def server_row(self, flat: torch.Tensor, comm_state: dict) -> torch.Tensor:
        """The server's parameter row after a ``flat_sync``: every row is the
        server row on the synchronous path, ``flat[0]`` by convention."""
        del comm_state
        return flat[..., 0, :]

    # --- accounting ---------------------------------------------------------------
    def comm_bytes_per_event(self, payload_elems: int) -> dict:
        """Wire bytes of one C1 uplink / one W1 gossip receive of
        ``payload_elems`` parameters under the payload transform."""
        per = self.comm.payload_bytes(payload_elems)
        return {"c1": per, "w1": per}

    def comm_events_per_period(self) -> dict:
        """Event counts in units of C1/C2/W1/W2 for one period (eq. 7)."""
        return {
            "c1": self.m,                      # each agent uploads once per period
            "c2": int(np.sum(self.taus)),      # tau_i local updates each
            "w1": 0,
            "w2": 0,
        }

    def comm_events_partial_period(self, n_offsets: int) -> dict:
        """Event counts for a trailing partial period of ``n_offsets`` steps:
        the first ``n_offsets`` mask columns of local updates (C2) and, when
        any step ran, the final every-replica aggregation read (C1)."""
        n_offsets = int(n_offsets)
        if not 0 <= n_offsets < self.tau:
            raise ValueError(
                f"partial period must satisfy 0 <= n_offsets < tau={self.tau}, "
                f"got {n_offsets}"
            )
        return {
            "c1": self.m if n_offsets else 0,
            "c2": int(masked_update_counts(self.taus, n_offsets).sum()),
            "w1": 0,
            "w2": 0,
        }


class SyncStrategy(AggregationStrategy):
    """tau = 1: classic federated SGD (eq. 4) — the communication-heavy baseline."""

    def __init__(self, m: int):
        taus = np.ones(m, int)
        super().__init__(name="sync", tau=1, taus=taus,
                         mask=self._build_mask(taus, 1))


class PeriodicStrategy(AggregationStrategy):
    """Variation-aware periodic averaging (Alg. 1 / T2). tau_i = tau gives T1."""

    def __init__(self, tau: int, taus: Optional[np.ndarray] = None,
                 m: Optional[int] = None):
        if taus is None:
            if m is None:
                raise ValueError("need taus or m")
            taus = np.full(m, tau, int)
        taus = np.asarray(taus, int)
        validate_a2(taus, tau)
        super().__init__(name=f"periodic(tau={tau})", tau=tau, taus=taus,
                         mask=self._build_mask(taus, tau))


@dataclasses.dataclass(frozen=True)
class DecayStrategy(AggregationStrategy):
    """Decay-based method (T3/T4): weight local grads by D(offset)."""

    decay_weights: np.ndarray = dataclasses.field(default=None)  # (tau,) fp32

    def __init__(self, tau: int, taus=None, m=None, decay: DecayFn = None):
        if taus is None:
            if m is None:
                raise ValueError("need taus or m")
            taus = np.full(m, tau, int)
        taus = np.asarray(taus, int)
        validate_a2(taus, tau)
        decay = decay or no_decay()
        w = decay(torch.arange(tau)).numpy().astype(np.float32)
        if w[0] != 1.0 or np.any(np.diff(w) > 1e-7) or np.any(w < -1e-7):
            raise ValueError("decay function violates A3 over this period")
        object.__setattr__(self, "decay_weights", w)
        AggregationStrategy.__init__(
            self, name=f"decay(tau={tau})", tau=tau, taus=taus,
            mask=self._build_mask(taus, tau),
        )

    def weight_table(self) -> np.ndarray:
        # mask[:, j] * D(j) for every offset j: the fp32 product the JAX
        # strategy takes per step (strategies.py:474-479); decay_weights is
        # (tau,) shared or (m, tau) per agent (the sweep's vector lam)
        if self.runs is not None:
            return self.run_weights
        dw = np.asarray(self.decay_weights, np.float32)
        dw = dw[:, None] if dw.ndim == 1 else dw.T
        return np.ascontiguousarray(self.mask.T * dw)


@dataclasses.dataclass(frozen=True)
class ConsensusStrategy(AggregationStrategy):
    """Consensus-based method (Alg. 2 / T5): E gossip rounds before each
    local update.

    Three forms, as in the JAX package:

    * dense, fused (default): the E rounds are one precomputed ``P^E``, and
      the variation mask is folded into its columns per period offset
      (``p_e_masked``, ``(tau, m, m)``), so the masked gossip is ONE
      ``consensus_step`` launch;
    * dense, ``fused=False``: ``p_masked[offset]`` then ``rounds - 1`` mixes
      by ``P`` (the paper's explicit loop);
    * sparse (``density <= SPARSE_DENSITY_THRESHOLD and m >=
      SPARSE_MIN_AGENTS``, or ``sparse=True``): no dense tables; the mask
      is a ``scale_rows`` and the gossip E ``consensus_gather`` rounds over
      the padded ``(m, k_max)`` neighbour list. ``nl_w`` gathers its weights
      out of the float64 mixing matrix, so sparse and dense see the same
      fp32 weights.

    The mask is already folded into the gossip, so the optimizer step takes
    the weight 1.0 (``weight`` stays the mask alone; consensus has no decay).
    """

    p_e: np.ndarray = dataclasses.field(default=None)   # (m, m) = P^E (dense)
    p: np.ndarray = dataclasses.field(default=None)     # (m, m) = P
    p_e_masked: np.ndarray = dataclasses.field(default=None)  # (tau, m, m)
    p_masked: np.ndarray = dataclasses.field(default=None)    # (tau, m, m)
    rounds: int = 1
    fused: bool = True
    topo: Topology = None
    eps: float = 0.0
    sparse: bool = False
    nl: NeighborList = None                             # sparse neighbor layout
    nl_w: np.ndarray = None                             # (m, k_max) P gathered

    def __init__(self, tau: int, topo: Topology, eps: float, rounds: int = 1,
                 taus=None, m: Optional[int] = None, fused: bool = True,
                 sparse: Optional[bool] = None):
        m = m if m is not None else topo.m
        if taus is None:
            taus = np.full(m, tau, int)
        taus = np.asarray(taus, int)
        validate_a2(taus, tau)
        if topo.m != m:
            raise ValueError("topology size must match agent count")
        if sparse is None:
            sparse = (density(topo) <= SPARSE_DENSITY_THRESHOLD
                      and m >= SPARSE_MIN_AGENTS)
        p64, p, p_e = mixing_powers(topo, eps, rounds, need_power=not sparse)
        mask = self._build_mask(taus, tau)
        set_ = lambda k, v: object.__setattr__(self, k, v)
        set_("p", p)
        set_("p_e", p_e)
        set_("sparse", bool(sparse))
        if sparse:
            nl = neighbor_list(topo)
            # the card's gather reads idx unchecked: check it once, here
            if nl.idx.min() < 0 or nl.idx.max() >= m:
                raise ValueError(f"neighbor list rows must lie in [0, {m})")
            set_("nl", nl)
            set_("nl_w", neighbor_weights_from_matrix(nl, p64))
            set_("p_e_masked", None)
            set_("p_masked", None)
        else:
            # mask-folded mixing per offset:
            # (P^E @ diag(w_j))[i, l] = P^E[i, l] * w_j[l]
            set_("nl", None)
            set_("nl_w", None)
            set_("p_e_masked", p_e[None, :, :] * mask.T[:, None, :])
            set_("p_masked", p[None, :, :] * mask.T[:, None, :])
        set_("rounds", rounds)
        set_("fused", fused)
        set_("topo", topo)
        set_("eps", eps)
        AggregationStrategy.__init__(
            self,
            name=(f"consensus(tau={tau},E={rounds},eps={eps:.3f}"
                  + (",sparse)" if sparse else ")")),
            tau=tau, taus=taus, mask=mask,
        )

    def _gossip(self, x: torch.Tensor, bufs) -> torch.Tensor:
        """E sparse gossip rounds over the neighbour list, round r writing
        ``bufs[(r + 1) % 2]`` (``x`` must not be ``bufs[1]``)."""
        idx = self._on("idx", lambda: self.nl.idx, x.device)
        w = self._on("nl_w", lambda: self.nl_w, x.device)
        out = x
        for r in range(self.rounds):
            out = dispatch.consensus_gather(out, idx, w, out=bufs[(r + 1) % 2])
        return out

    def _transform(self, g: torch.Tensor, offset: int, bufs) -> torch.Tensor:
        dev = g.device
        if self.sparse:
            # mask first (diag(w_j) commutes out of the product), then E
            # O(m*k) gather rounds
            x = dispatch.scale_rows(g, self.weight(offset, dev), out=bufs[0])
            return self._gossip(x, bufs)
        if self.fused:
            mix = self._on("p_e_masked", lambda: self.p_e_masked, dev)
            return dispatch.consensus_mix(g, mix[offset], out=bufs[0])
        mix = self._on("p_masked", lambda: self.p_masked, dev)
        out = dispatch.consensus_mix(g, mix[offset], out=bufs[0])
        p = self._on("p", lambda: self.p, dev)
        for r in range(self.rounds - 1):
            out = dispatch.consensus_mix(out, p, out=bufs[(r + 1) % 2])
        return out

    def flat_transform(self, g: torch.Tensor, offset: int) -> torch.Tensor:
        """The masked gossip mix of flat ``(m, n)`` grads, into new buffers
        (the tree-space methods hand the result out)."""
        return self._transform(g, offset, (torch.empty_like(g),
                                           torch.empty_like(g)))

    def with_mask(self, mask, taus=None) -> "ConsensusStrategy":
        """Mask copy that also refolds the per-offset masked mixing tables
        (fp32 products, as ``src/repro/core/strategies.py:577-595``); the
        sparse path folds the mask at transform time, so its copy only
        swaps the mask."""
        new = AggregationStrategy.with_mask(self, mask, taus)
        if self.sparse:
            return new
        mask_t = new.mask.T[:, None, :]                      # (tau, 1, m)
        object.__setattr__(new, "p_masked", self.p[None] * mask_t)
        object.__setattr__(new, "p_e_masked", self.p_e[None] * mask_t)
        return new

    def flat_update(self, params, g, offset, eta, *, out=None):
        mixed = self._transform(g, offset, self._buffers(g))
        return dispatch.decay_accum(params, mixed, self._per_run(-eta, params),
                                    out=out)

    def flat_opt_step(self, params, g, offset, eta, opt, opt_state, *,
                      inplace: bool = False):
        """Masked gossip mix (mask folded into the mix) then the optimizer
        pass with weight 1.0."""
        mixed = self._transform(g, offset, self._buffers(g))
        return opt.update(params, mixed, 1.0, opt_state, eta, inplace=inplace)

    def init_comm_state(self, flat: torch.Tensor) -> dict:
        """Adds the ``(m, n)`` fp32 gossip error-feedback accumulator
        ``err_gossip``: the consensus path communicates every local step."""
        state = AggregationStrategy.init_comm_state(self, flat)
        if self.comm.enabled and self.comm.error_feedback:
            state["err_gossip"] = torch.zeros(flat.shape, dtype=torch.float32,
                                              device=flat.device)
        return state

    def flat_local_step(self, flat, g, offset, eta, opt, opt_state,
                        comm_state):
        """Gossip step with the broadcast payload compressed.

        Each agent masks its gradient, folds in its gossip residual, encodes
        once and broadcasts; the neighbours mix the reconstructions through
        ``P^E`` (dense) or E gather rounds (sparse): compress-then-gossip,
        one encode per agent per step whatever E. The unsent remainder
        becomes the next residual. Identity comm takes the base step.
        """
        if not self.comm.enabled:
            return AggregationStrategy.flat_local_step(
                self, flat, g, offset, eta, opt, opt_state, comm_state)
        dev = flat.device
        x = dispatch.scale_rows(g.float(), self.weight(offset, dev))
        if self.comm.error_feedback:
            x = x + comm_state["err_gossip"]
        payload, residual = self.comm.encode(x)
        bufs = self._buffers(payload)
        if self.sparse:
            mixed = self._gossip(payload, bufs)
        else:
            mixed = dispatch.consensus_mix(
                payload, self._on("p_e", lambda: self.p_e, dev), out=bufs[0])
        if self.comm.error_feedback:
            comm_state = dict(comm_state, err_gossip=residual)
        mixed = mixed.to(flat.dtype)
        if opt is None:
            dispatch.decay_accum(flat, mixed, self._per_run(-eta, flat),
                                 out=flat)
        else:
            flat, opt_state = opt.update(flat, mixed, 1.0, opt_state, eta,
                                         inplace=True)
        return flat, opt_state, comm_state

    def comm_events_partial_period(self, n_offsets: int) -> dict:
        base = AggregationStrategy.comm_events_partial_period(self, n_offsets)
        gossip = int(self.topo.degrees.sum()) * self.rounds * int(n_offsets)
        base["w1"] = gossip
        base["w2"] = gossip
        return base

    def comm_events_per_period(self) -> dict:
        base = AggregationStrategy.comm_events_per_period(self)
        # every local iteration (tau of them; all agents listen even when
        # their own g is masked to zero, Alg. 2 lines 14-17) costs |Omega_i|
        # receives per round
        gossip = int(self.topo.degrees.sum()) * self.rounds * self.tau
        base["w1"] = gossip
        base["w2"] = gossip
        return base


# --- runs ---------------------------------------------------------------------------

# The hot-path tables of each strategy kind, by how they gain the run axis:
# tables indexed by the period offset first keep it first, (tau, S, ...), so
# that ``table[offset]`` is one contiguous per-run operand.
_OFFSET_TABLES = ("p_masked", "p_e_masked")
_RUN_TABLES = ("p", "p_e", "nl_w")


def _same_structure(a: AggregationStrategy, b: AggregationStrategy) -> bool:
    if type(a) is not type(b) or a.tau != b.tau or a.m != b.m or \
            a.comm != b.comm:
        return False
    if a.is_async and a.schedule.n_periods != b.schedule.n_periods:
        return False
    if isinstance(a, ConsensusStrategy):
        if (a.rounds, a.fused, a.sparse) != (b.rounds, b.fused, b.sparse) or \
                not np.array_equal(a.topo.adj, b.topo.adj):
            return False
        if a.sparse and not np.array_equal(a.nl.idx, b.nl.idx):
            return False
    return True


def stack_runs(strats: Sequence[AggregationStrategy]) -> AggregationStrategy:
    """One strategy for S runs that differ only in their values.

    Every run must have the first one's kind, tau, m, payload transform
    and (consensus) topology, rounds and path; each may have its own mask,
    decay table, mixing matrices and edge weights. The result steps an
    ``(S, m, n)`` carry with per-run tables: the weights ``(tau, S, m)``
    (each run's own :meth:`weight_table`), ``P`` / ``P^E`` ``(S, m, m)``,
    the mask-folded tables ``(tau, S, m, m)`` and the edge weights ``(S, m,
    k_max)``. Its host-side accounting (ledger, events) is the first run's.
    """
    strats = list(strats)
    if not strats:
        raise ValueError("stack_runs: need at least one strategy")
    first = strats[0]
    for i, st in enumerate(strats):
        if st.runs is not None:
            raise ValueError(f"stack_runs: strategy {i} is already stacked")
        if not _same_structure(first, st):
            raise ValueError(
                f"stack_runs: run {i} ({st.name}) differs from run 0 "
                f"({first.name}) in more than values (kind, tau, m, comm, "
                f"topology, rounds, path or schedule horizon)")
    fields = {"runs": len(strats),
              "run_weights": np.ascontiguousarray(
                  np.stack([st.weight_table() for st in strats], axis=1))}
    if first.is_async:
        fields["sync_weights"] = np.stack(
            [np.asarray(st.sync_weights, np.float32) for st in strats])
        fields["run_arrive"] = np.stack(
            [np.asarray(st.schedule.arrive, np.float32) for st in strats])
    for name in _OFFSET_TABLES + _RUN_TABLES:
        tabs = [getattr(st, name, None) for st in strats]
        if any(t is None for t in tabs):
            continue
        axis = 1 if name in _OFFSET_TABLES else 0
        fields[name] = np.ascontiguousarray(
            np.stack([np.asarray(t, np.float32) for t in tabs], axis=axis))
    return first._copy(**fields)


_UNSET = object()   # a make_strategy keyword that was not given


def make_strategy(kind: str, *, m: Optional[int] = None,
                  tau: Optional[int] = None, taus=None,
                  decay: Optional[DecayFn] = None,
                  topo: Optional[Topology] = None, eps: Optional[float] = None,
                  rounds: Optional[int] = None, fused: Optional[bool] = None,
                  sparse: Optional[bool] = None,
                  comm: Optional[PayloadTransform] = None,
                  schedule=_UNSET, stale_decay=_UNSET,
                  ) -> AggregationStrategy:
    """``sync`` (``m``), ``periodic`` (``tau`` and ``taus`` or ``m``),
    ``decay`` (the same, plus ``decay``), ``consensus`` (``tau``, ``topo``,
    ``eps``; ``rounds`` = 1, ``fused`` = True and ``sparse`` = auto by
    default; ``taus`` / ``m`` as for periodic) or ``async`` (``tau`` and a
    ``schedule``, a :class:`~repro_torch.core.async_fed.DelaySchedule`;
    ``taus``, ``m`` and ``stale_decay`` optional), with the JAX package's
    keyword names; ``comm`` sets the payload transform of any kind (async
    takes none but the identity). A keyword the kind does not take raises
    ``TypeError`` (``schedule`` and ``stale_decay`` even when given as
    None)."""
    if kind not in ("sync", "periodic", "decay", "consensus", "async"):
        raise ValueError(f"unknown strategy kind: {kind}")
    if decay is not None and kind != "decay":
        raise TypeError(f"make_strategy: {kind!r} takes no decay")
    if kind != "async":
        for name, v in (("schedule", schedule), ("stale_decay", stale_decay)):
            if v is not _UNSET:
                raise TypeError(f"make_strategy: {kind!r} takes no {name}")
    if kind != "consensus":
        for name, v in (("topo", topo), ("eps", eps), ("rounds", rounds),
                        ("fused", fused), ("sparse", sparse)):
            if v is not None:
                raise TypeError(f"make_strategy: {kind!r} takes no {name}")
    if kind == "sync":
        if tau is not None or taus is not None:
            raise TypeError("make_strategy: 'sync' takes m only (its tau is 1)")
        strat = SyncStrategy(m=m)
    elif tau is None:
        raise TypeError(f"make_strategy: {kind!r} needs tau")
    elif kind == "periodic":
        strat = PeriodicStrategy(tau=tau, taus=taus, m=m)
    elif kind == "decay":
        strat = DecayStrategy(tau=tau, taus=taus, m=m, decay=decay)
    elif kind == "async":
        if schedule is _UNSET or schedule is None:
            raise TypeError("make_strategy: 'async' needs a schedule")
        # core.async_fed imports this module
        from repro_torch.core.async_fed import AsyncStrategy

        strat = AsyncStrategy(
            tau=tau, schedule=schedule, taus=taus, m=m,
            stale_decay=None if stale_decay is _UNSET else stale_decay)
    else:
        if topo is None or eps is None:
            raise TypeError("make_strategy: 'consensus' needs topo and eps")
        strat = ConsensusStrategy(
            tau=tau, topo=topo, eps=eps, rounds=1 if rounds is None else rounds,
            taus=taus, m=m, fused=True if fused is None else fused,
            sparse=sparse)
    if comm is not None:
        strat = strat.with_comm(comm)
    return strat
