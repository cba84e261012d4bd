"""Micro-batching request queue + seeded open-loop client schedules.

The port's own copy of ``repro.serve.queue``: numpy only, with the same
seeded streams, so one seed gives one schedule and one sequence of batch
compositions in both packages (pinned by ``tests/test_torch_serve.py``).

The seam between "many concurrent clients, one observation each" and the
bucket-shaped batches the engine serves. The queue is host-side and
deterministic: requests are coalesced strictly in arrival order (FIFO, ties
broken by enqueue sequence), and each drain takes ``min(pending, max_batch)``
requests — so a replayed seeded client schedule produces the identical
sequence of batch compositions, which with the engine's seeded noise stream
makes whole serving runs reproducible bit-for-bit.

The load generators (:func:`poisson_arrivals`, :func:`simulate_clients`) are
open-loop (arrival times drawn up front, independent of service times): a
closed loop would slow its own offered load down whenever the server lags.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ObsRequest:
    """One client's decision request: an observation plus arrival metadata.

    ``t_arrival`` is in schedule time units (seconds for the bench's Poisson
    clock); ``seq`` is the queue-assigned enqueue sequence number used for
    deterministic FIFO tie-breaking and set by :meth:`MicroBatchQueue.push`.
    """

    client_id: int
    t_arrival: float
    obs: np.ndarray
    seq: int = -1


class MicroBatchQueue:
    """Coalesce pending requests into bucket-shaped observation batches.

    ``max_batch`` caps a single drain (the engine's largest bucket — bigger
    backlogs drain over several calls). The queue never pads: padding to the
    covering bucket is the engine's job, so the queue stays a pure
    arrival-order scheduler.
    """

    def __init__(self, max_batch: int, obs_dim: int):
        if max_batch < 1:
            raise ValueError(f"queue: max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.obs_dim = int(obs_dim)
        self._pending: Deque[ObsRequest] = deque()
        self._seq = 0

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, req: ObsRequest) -> ObsRequest:
        obs = np.asarray(req.obs, np.float32)
        if obs.shape != (self.obs_dim,):
            raise ValueError(
                f"queue: obs must be ({self.obs_dim},), got {obs.shape}"
            )
        stamped = dataclasses.replace(req, obs=obs, seq=self._seq)
        self._seq += 1
        self._pending.append(stamped)
        return stamped

    def push_all(self, reqs: Sequence[ObsRequest]) -> None:
        for r in reqs:
            self.push(r)

    def next_batch(self) -> Optional[Tuple[np.ndarray, List[ObsRequest]]]:
        """Pop the next ``min(pending, max_batch)`` requests in FIFO order.

        Returns ``(obs_batch, requests)`` with ``obs_batch`` of shape
        ``(n, obs_dim)`` ready for ``ServeEngine.decide``, or ``None`` when
        the queue is empty.
        """
        if not self._pending:
            return None
        n = min(len(self._pending), self.max_batch)
        reqs = [self._pending.popleft() for _ in range(n)]
        obs = np.stack([r.obs for r in reqs])
        return obs, reqs


def poisson_arrivals(rate: float, horizon: float, *,
                     seed: int = 0) -> np.ndarray:
    """Open-loop Poisson arrival times on ``[0, horizon)``.

    Exponential inter-arrival gaps at ``rate`` per time unit, drawn up front
    from a seeded generator — the offered load is fixed before any service
    happens. Returns a sorted float64 vector (possibly empty).
    """
    if rate <= 0.0:
        raise ValueError(f"poisson_arrivals: rate must be > 0, got {rate}")
    if horizon <= 0.0:
        raise ValueError(
            f"poisson_arrivals: horizon must be > 0, got {horizon}"
        )
    rng = np.random.default_rng(seed)
    # Draw in chunks of the expected count until past the horizon.
    expected = max(16, int(rate * horizon * 1.2))
    times: List[np.ndarray] = []
    t = 0.0
    while t < horizon:
        gaps = rng.exponential(1.0 / rate, size=expected)
        chunk = t + np.cumsum(gaps)
        times.append(chunk)
        t = float(chunk[-1])
    all_t = np.concatenate(times)
    return all_t[all_t < horizon]


def simulate_clients(m: int, rate_per_client: float, horizon: float, *,
                     obs_dim: int, seed: int = 0) -> List[ObsRequest]:
    """A seeded fleet of ``m`` open-loop clients, each an independent Poisson
    process at ``rate_per_client``, each request carrying a fresh random
    observation. Returns requests sorted by ``(t_arrival, client_id)`` —
    the deterministic arrival order the queue will see.
    """
    if m < 1:
        raise ValueError(f"simulate_clients: m must be >= 1, got {m}")
    rng = np.random.default_rng(seed)
    # One merged Poisson stream at m * rate, with client ids assigned
    # uniformly — statistically identical to m independent streams and O(N)
    # instead of O(m) generator setups for the 10k-agent bench.
    t = poisson_arrivals(m * rate_per_client, horizon, seed=seed + 1)
    ids = rng.integers(0, m, size=t.shape[0])
    obs = rng.standard_normal((t.shape[0], obs_dim)).astype(np.float32)
    return [
        ObsRequest(client_id=int(ids[i]), t_arrival=float(t[i]), obs=obs[i])
        for i in range(t.shape[0])
    ]
