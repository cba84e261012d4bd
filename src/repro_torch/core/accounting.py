"""Resource-cost ledger in units of C1/C2/W1/W2 (paper eqs. 7, 27; Table II).

The counterpart of ``repro.core.accounting``.

C1: one agent->server upload.                C2: one local update.
W1: one neighbor->agent gossip receive.      W2: one gossip combine.

The ledger counts events and, when told the payload size, wire bytes: each
communication event (C1 uplink, W1 gossip receive) carries one encoded
payload, whose size the strategy's payload transform gives
(``AggregationStrategy.comm_bytes_per_event`` ->
``PayloadTransform.payload_bytes``; dense fp32 is ``payload_elems * 4``). A
trailing partial period bills its events and bytes like the JAX ledger does.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CostLedger:
    c1_events: int = 0
    c2_events: int = 0
    w1_events: int = 0
    w2_events: int = 0
    c1_bytes: int = 0
    w1_bytes: int = 0
    # period boundaries billed so far: a non-uniform (async) schedule is
    # billed over the concrete span each call covers
    periods_billed: int = 0

    def _add_events(self, per: dict, strategy,
                    payload_elems: int | None) -> None:
        self.c1_events += per["c1"]
        self.c2_events += per["c2"]
        self.w1_events += per["w1"]
        self.w2_events += per["w2"]
        if payload_elems is not None:
            per_b = strategy.comm_bytes_per_event(payload_elems)
            self.c1_bytes += per["c1"] * per_b["c1"]
            self.w1_bytes += per["w1"] * per_b["w1"]

    def add_periods(self, strategy, n_periods: int,
                    payload_elems: int | None = None) -> None:
        """Bill ``n_periods`` further full periods.

        Uniform strategies (every agent syncs at every boundary) bill the
        closed-form per-period counts; a strategy with non-uniform arrivals
        (``uniform_sync`` false: the async path) is billed over the span
        ``[periods_billed, periods_billed + n_periods)`` of its schedule, so
        successive calls cover disjoint spans and sum to its arrivals."""
        if getattr(strategy, "uniform_sync", True):
            per = strategy.comm_events_per_period()
            per = {k: v * n_periods for k, v in per.items()}
        else:
            per = strategy.comm_events_span(self.periods_billed, n_periods)
        self._add_events(per, strategy, payload_elems)
        self.periods_billed += n_periods

    def add_partial_period(self, strategy, n_offsets: int,
                           payload_elems: int | None = None) -> None:
        """Bill a trailing partial period of ``n_offsets`` local steps: the
        strategy's counts (uniform strategies: its local updates plus the
        final every-replica aggregation read; a buffered async schedule
        reaches no boundary mid-period, so no uplinks). A no-op when
        ``n_offsets`` is 0."""
        if n_offsets == 0:
            return
        per = strategy.comm_events_partial_period(n_offsets)
        self._add_events(per, strategy, payload_elems)

    def total_bytes(self) -> int:
        """Total wire bytes across the federated links (uplink + gossip)."""
        return self.c1_bytes + self.w1_bytes

    def psi0(self, c1: float, c2: float, w1: float = 0.0, w2: float = 0.0) -> float:
        """Total resource cost; equals eq. (7) (or (27) with gossip events)."""
        return (
            c1 * self.c1_events
            + c2 * self.c2_events
            + w1 * self.w1_events
            + w2 * self.w2_events
        )

    def table_row(self) -> dict:
        """Table II columns (symbolic units) plus the wire-byte totals."""
        return {
            "communication_overheads_C1": self.c1_events,
            "computation_overheads_C2": self.c2_events,
            "inter_communication_W1": self.w1_events,
            "inter_computation_W2": self.w2_events,
            "uplink_bytes_C1": self.c1_bytes,
            "gossip_bytes_W1": self.w1_bytes,
            "total_bytes": self.total_bytes(),
        }
