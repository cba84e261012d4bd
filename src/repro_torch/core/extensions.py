"""Beyond-paper aggregation strategies (``repro.core.extensions``).

1. :class:`HierarchicalStrategy` — the paper's future work: agents are
   partitioned into clusters; clusters average among themselves every
   period (a cheap intra-cluster link, billed like W1) and the global
   virtual agent averages everyone every ``global_every`` periods (the C1
   link).
2. :class:`QuantizedSyncStrategy` — the synced deltas quantised to int8
   (one scale per agent row of each leaf) with error feedback, so the
   utility (eq. 13) can weigh "send less often" against "send smaller".
3. :class:`ElasticAveragingStrategy` — EASGD: agents are pulled toward an
   anchor elastically instead of reset to the mean.

Each composes with the variation masks (A2) like the built-ins. Their
``server_average`` overrides take the extra argument (the period index, the
anchor and the error-feedback residuals, the anchor) that the JAX package's
own drivers never pass: ``repro_torch.core.fmarl.run_fmarl`` syncs every
strategy through the plain mean, as ``repro.core.fmarl.run_fmarl`` does.

The overrides follow the JAX module op for op. The hierarchical one ravels
the tree once and runs the flat primitives: on global periods the mean by
``row_mean``, copied back over the rows; on the others the cluster mean
``P_local @ flat`` by ``consensus_mix`` with the fp32 cluster-mean matrix
(the ``row_mean`` and ``consensus_step`` kernels on the card). The elastic
pull is one ``decay_accum`` (``x - alpha * (x - anchor)``) and the anchor's
step a ``row_mean``. The int8 quantiser has no kernel in either package:
plain torch ops on either device (round half to even, as ``jnp.round``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.strategies import AggregationStrategy
from repro_torch.core.variation import validate_a2
from repro_torch.kernels import dispatch


def _taus(tau: int, taus, m) -> np.ndarray:
    if taus is None:
        if m is None:
            raise ValueError("need taus or m")
        taus = np.full(m, tau, int)
    taus = np.asarray(taus, int)
    validate_a2(taus, tau)
    return taus


@dataclasses.dataclass(frozen=True)
class HierarchicalStrategy(AggregationStrategy):
    """Two-level periodic averaging: every tau local updates an
    intra-cluster average, every ``tau * global_every`` a global one. The
    level is picked by the period index the caller passes to
    :meth:`server_average`."""

    clusters: tuple = ()          # tuple of tuples of agent indices
    global_every: int = 2         # global sync every this many periods

    def __init__(self, tau: int, clusters, global_every: int = 2,
                 taus=None, m=None):
        m = m if m is not None else sum(len(c) for c in clusters)
        taus = _taus(tau, taus, m)
        object.__setattr__(self, "clusters", tuple(tuple(c) for c in clusters))
        object.__setattr__(self, "global_every", int(global_every))
        ids = sorted(i for c in clusters for i in c)
        if ids != list(range(m)):
            raise ValueError("clusters must partition agents 0..m-1")
        AggregationStrategy.__init__(
            self, name=f"hierarchical(tau={tau},g={global_every})", tau=tau,
            taus=taus, mask=self._build_mask(taus, tau))

    def cluster_mean_matrix(self) -> np.ndarray:
        """``(m, m)`` fp32 ``P_local``: row i averages i's cluster."""
        p = np.zeros((self.m, self.m))
        for c in self.clusters:
            for i in c:
                p[i, list(c)] = 1.0 / len(c)
        return p.astype(np.float32)

    def is_global(self, period_idx: int) -> bool:
        return (int(period_idx) + 1) % self.global_every == 0

    def server_average(self, params_m, period_idx=None):
        """Without ``period_idx``: the plain mean tree (eq. 11). With it: a
        tree of ``(m, ...)`` replicas, every row the full mean on a global
        period, its cluster's mean otherwise."""
        if period_idx is None:
            return AggregationStrategy.server_average(self, params_m)
        flat, spec = dispatch.stacked_ravel_spec(params_m)
        if self.is_global(period_idx):
            row = dispatch.row_mean(flat)
            flat.copy_(row.unsqueeze(0).expand_as(flat))
            return spec.unravel(flat)
        p_local = self._on("p_local", self.cluster_mean_matrix, flat.device)
        return spec.unravel(dispatch.consensus_mix(flat, p_local))

    def comm_events_per_period(self) -> dict:
        base = AggregationStrategy.comm_events_per_period(self)
        # the global upload (C1) only every global_every periods; the local
        # cluster exchange billed like gossip (W1) the rest of the time
        base["c1"] = self.m // self.global_every
        base["w1"] = self.m - base["c1"]
        base["w2"] = base["w1"]
        return base


def quantize_int8(x: torch.Tensor):
    """Per-row symmetric int8 codes of ``(m, k)`` fp32 ``x``: ``(q, scale)``
    with ``scale = max|x_i| / 127 + 1e-12`` and ``q = clip(round(x / scale),
    -127, 127)``, rounding half to even."""
    scale = x.abs().amax(dim=1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


@dataclasses.dataclass(frozen=True)
class QuantizedSyncStrategy(AggregationStrategy):
    """Periodic averaging whose synced quantity is int8-quantised with error
    feedback (EF-SGD): each agent keeps its quantisation residual and adds
    it back next period. Local updates are untouched; C1 events carry a
    quarter of the fp32 bytes."""

    bits: int = 8

    def __init__(self, tau: int, taus=None, m=None, bits: int = 8):
        taus = _taus(tau, taus, m)
        object.__setattr__(self, "bits", bits)
        AggregationStrategy.__init__(
            self, name=f"quantized(tau={tau},b={bits})", tau=tau, taus=taus,
            mask=self._build_mask(taus, tau))

    def server_average(self, params_m, anchor=None, errors=None):
        """Without ``anchor``: the plain mean tree. With it: each agent's
        delta from the anchor plus its residual, per leaf, quantised per
        agent row; the server averages the dequantised deltas. Returns
        ``(params_m, errors)``: the replicas all set to ``anchor + mean``,
        and the fp32 residuals."""
        if anchor is None:
            return AggregationStrategy.server_average(self, params_m)
        paths = dispatch.tree_paths(params_m)
        new_p, new_e = [], []
        for pm, a, e in zip(dispatch.tree_leaves(params_m),
                            dispatch.tree_leaves(anchor),
                            dispatch.tree_leaves(errors)):
            a32 = a.float()
            delta = pm.float() - a32[None] + e
            q, scale = quantize_int8(delta.reshape(pm.shape[0], -1))
            deq = (q.float() * scale[:, None]).reshape(delta.shape)
            new_e.append(delta - deq)
            avg = a32 + torch.mean(deq, dim=0)
            new_p.append(avg.expand(pm.shape).to(pm.dtype))
        return (dispatch.tree_from_leaves(paths, new_p),
                dispatch.tree_from_leaves(paths, new_e))

    def comm_events_per_period(self) -> dict:
        base = AggregationStrategy.comm_events_per_period(self)
        base["c1_bytes_factor"] = self.bits / 32.0
        return base


@dataclasses.dataclass(frozen=True)
class ElasticAveragingStrategy(AggregationStrategy):
    """EASGD: ``x_i <- x_i - alpha (x_i - anchor)``; the anchor moves toward
    the agent mean by ``alpha``. The paper leaves its bound open; the
    benches measure it."""

    alpha: float = 0.5

    def __init__(self, tau: int, taus=None, m=None, alpha: float = 0.5):
        taus = _taus(tau, taus, m)
        object.__setattr__(self, "alpha", float(alpha))
        AggregationStrategy.__init__(
            self, name=f"elastic(tau={tau},a={alpha})", tau=tau, taus=taus,
            mask=self._build_mask(taus, tau))

    def server_average(self, params_m, anchor=None):
        """Without ``anchor``: the plain mean tree. With it: the elastic
        pull; returns ``(params_m, anchor)``, each in its own dtype."""
        if anchor is None:
            return AggregationStrategy.server_average(self, params_m)
        flat, spec = dispatch.stacked_ravel_spec(params_m)
        anc = spec.ravel_one(anchor)
        diff = flat.float() - anc.float()[None]
        pulled = dispatch.decay_accum(flat.float(), diff, -self.alpha)
        new_anc = anc.float() + self.alpha * dispatch.row_mean(diff)
        return (spec.unravel(pulled.to(flat.dtype)),
                spec.unravel_one(new_anc.to(anc.dtype)))
