"""Token data pipeline: synthetic Zipf streams and memmap-backed corpora.

The port's own copy of ``repro.data.pipeline`` (numpy only, so it imports
nothing of the JAX package): the same draws from the same
``SeedSequence([seed, agent, step])``, so a batch is bitwise the JAX
package's for the same ``(seed, agent, step)``. Batches are numpy int32
arrays on the host; the trainer moves them to its device.

Host-sharded: in a multi-process launch each process reads its slice of the
global batch (``process_index``). Each agent's stream is seeded by its agent
id, so federated agents draw from one distribution but disjoint streams.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    """Zipf-distributed token stream with a Markov copy channel: the next
    token is a Zipf draw or, with probability ``copy_prob``, the current
    token plus one, so a model can reduce its loss on it."""

    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2
    copy_prob: float = 0.35

    def batch(self, step: int, batch: int, seq: int, agent: int = 0
              ) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, agent, step]))
        base = rng.zipf(self.zipf_a, size=(batch, seq)).astype(np.int64)
        base = np.minimum(base - 1, self.vocab_size - 1)
        copy = rng.random((batch, seq)) < self.copy_prob
        for t in range(1, seq):
            base[:, t] = np.where(
                copy[:, t], (base[:, t - 1] + 1) % self.vocab_size, base[:, t])
        return base.astype(np.int32)


@dataclasses.dataclass
class MemmapTokens:
    """Flat binary token file (uint16 / uint32); random crops per step."""

    path: str
    vocab_size: int
    dtype: str = "uint16"
    seed: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")

    def batch(self, step: int, batch: int, seq: int, agent: int = 0
              ) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, agent, step]))
        n = len(self._data) - seq - 1
        starts = rng.integers(0, max(n, 1), size=batch)
        out = np.stack([self._data[s:s + seq] for s in starts])
        return np.minimum(out.astype(np.int32), self.vocab_size - 1)


def make_batch_iterator(source, batch: int, seq: int, *, agent: int = 0,
                        start_step: int = 0, process_index: int = 0,
                        process_count: int = 1) -> Iterator[dict]:
    """Yields ``{'tokens': (batch // process_count, seq)}`` host shards
    forever, one step after another from ``start_step``."""
    if batch % process_count:
        raise ValueError("global batch must divide process count")
    local = batch // process_count
    step = start_step
    while True:
        full = source.batch(step, batch, seq, agent=agent)
        yield {"tokens": full[process_index * local:(process_index + 1)
                              * local]}
        step += 1
