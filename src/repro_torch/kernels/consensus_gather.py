"""Sparse neighbour-list gossip: ``out[i] = sum_k w[i,k] * g[idx[i,k]]``.

The port of the Pallas TPU kernel ``consensus_gather_pallas``
(``src/repro/kernels/consensus_gather.py:51``): one consensus round over a
padded ``(m, k_max)`` neighbour list (``repro_torch.core.topology``'s
``NeighborList`` layout), O(m*k) instead of the dense O(m^2) mix.

* :func:`consensus_gather_cuda` wraps the two hand-written Hopper kernels
  of ``csrc/consensus_gather.cu`` (one launch on the current stream, no
  synchronisation; launches counted in :data:`launches`), the one
  :func:`gather_plan` picks for the shape: the staged kernel (groups of
  rows that load each source row's tile into shared memory once) from
  MIN_STAGED_ROWS rows, the row kernel below that and past MAX_SLOTS;
* :func:`consensus_gather_plain` is the ascending-k loop of the jnp path of
  ``repro.kernels.dispatch.consensus_gather`` (``dispatch.py:428-434``) in
  torch: ``w[:, 0] * g32[idx[:, 0]]``, then ``out + w[:, k] * g32[idx[:,
  k]]``, each a separately rounded fp32 operation. The kernel performs the
  same roundings in the same order, so the two are bitwise equal.

Callers go through :func:`repro_torch.kernels.dispatch.consensus_gather`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.consensus_step import overlaps
from repro_torch.kernels.decay_accum import (
    DTYPE_CODE,
    check_buffer,
    raise_on,
    stream_of,
)

launches = 0          # kernel launches made by consensus_gather_cuda

# Mirrors csrc/consensus_gather.cu: the staged kernel gives each of its 512
# threads at most one (row, k) slot of a group of rows (one row a warp),
# stages a source
# row's 512-byte column tile in ROW_BYTES (16 more for the row's phase),
# holds up to MAX_STAGES tiles in a ring of at most RING_CAP bytes, and its
# slot tables and HASH_TABLE-entry hash table take STATIC_SMEM bytes;
# BLOCKS_PER_SM such blocks fit an SM.
MAX_SLOTS = 186
GROUP_ROWS = 16
ROW_BYTES = 528
MAX_STAGES = 8
RING_CAP = 98304
HASH_TABLE = 512
STATIC_SMEM = 8 * HASH_TABLE + 4 * 2 * MAX_SLOTS + 8 * 2 * MAX_SLOTS + 4 * 16
BLOCKS_PER_SM = 2
ROW_KERNEL_COLS = 1024
# The staged kernel's block loads its slots, de-duplicates them and waits
# for its first tile before it computes, a fixed cost that its run of tiles
# must outweigh: on the H100 it lost to the row kernel at m = 64 and 128 and
# won from 256 (chip_smoke.gather_crossover, PERF.md).
MIN_STAGED_ROWS = 256


class GatherPlan(NamedTuple):
    """What :func:`consensus_gather_cuda` launches for a shape."""
    kernel: str           # "staged" or "rows"
    rows: int             # output rows a block's group (0: the row kernel)
    tile_cols: int        # columns a tile
    blocks: int           # grid size
    ring_bytes: int       # dynamic shared memory (the staged kernel's ring)
    smem_bytes: int       # all shared memory a block takes


def staged_plan(m: int, n: int, k_max: int, itemsize: int,
                sms: int) -> GatherPlan:
    """The staged kernel's group, grid and shared memory for a gather over
    an ``(m, k_max)`` list (``k_max <= MAX_SLOTS``) on ``(m, n)`` elements
    of ``itemsize`` bytes on a card of ``sms`` SMs: groups of ``R = min(16,
    MAX_SLOTS // k_max, m)`` rows, a ring that holds ``MAX_STAGES`` stages
    of the most source rows a group can have, ``U = min(R * k_max, m)`` (at
    most ``RING_CAP``, one stage of U rows at least), and one wave of
    ``BLOCKS_PER_SM * sms`` blocks: with fewer groups than that, a whole
    number of blocks a group (a block's run of tiles then stays in one
    group), else one run of the (group, tile) sequence a block; never more
    blocks than tiles."""
    rows = min(GROUP_ROWS, MAX_SLOTS // k_max, m)
    u_max = min(rows * k_max, m)
    ring = min(RING_CAP, MAX_STAGES * u_max * ROW_BYTES)
    cols = (ROW_BYTES - 16) // itemsize
    groups = -(-m // rows)
    wave = BLOCKS_PER_SM * sms
    blocks = wave if groups >= wave else groups * (wave // groups)
    return GatherPlan("staged", rows, cols,
                      min(blocks, groups * -(-n // cols)), ring,
                      ring + STATIC_SMEM)


def gather_plan(m: int, n: int, k_max: int, itemsize: int,
                sms: int) -> GatherPlan:
    """What :func:`consensus_gather_cuda` launches for a gather over an
    ``(m, k_max)`` list on ``(m, n)`` elements of ``itemsize`` bytes on a
    card of ``sms`` SMs. By shape alone: from ``MIN_STAGED_ROWS`` rows with
    ``k_max <= MAX_SLOTS`` (the consensus path's lists at m = 1024 and
    10,000), the staged kernel (:func:`staged_plan`); otherwise (m = 64 on
    the consensus path; the full-list gather at large m) the row kernel,
    one block per row and 1,024-column tile, 2 KB of slot tables."""
    if m < MIN_STAGED_ROWS or k_max > MAX_SLOTS:
        tiles = -(-n // ROW_KERNEL_COLS)
        return GatherPlan("rows", 0, ROW_KERNEL_COLS, m * tiles, 0,
                          2 * 4 * 256)
    return staged_plan(m, n, k_max, itemsize, sms)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def consensus_gather_plain(g: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                           *, out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain version: the fp32 ascending-k chain, cast to ``g.dtype``."""
    g32 = g.float()
    idx = idx.long()
    acc = w[:, 0, None] * g32[idx[:, 0]]
    for k in range(1, idx.shape[1]):
        acc = acc + w[:, k, None] * g32[idx[:, k]]
    res = acc.to(g.dtype)
    return res if out is None else out.copy_(res)


def consensus_gather_cuda(g: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                          *, out: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Launch ``consensus_gather_kernel``: one sparse gossip round.

    ``g`` is a contiguous ``(m, n)`` CUDA buffer (fp32, bf16 or fp16),
    ``idx`` a contiguous ``(m, k_max)`` int32 neighbour list and ``w`` the
    matching fp32 weights, on the same device. ``idx`` must hold rows in
    ``[0, m)`` and ``w`` must be 0.0 on padding: the kernel gathers every
    slot, and a row out of range would read foreign memory, so the caller
    checks ``idx`` once on the host (the strategy does, when it builds its
    neighbour list), not on every launch. ``out`` (allocated when not given)
    must not overlap ``g``.

    The kernel and its grid come from :func:`gather_plan` (by shape alone);
    both kernels do the same roundings in the same order, so either is
    bitwise equal to :func:`consensus_gather_plain`.

    The same function is one sparse-dense product, ``W @ g`` with ``W`` the
    ``(m, m)`` matrix of ``(idx, w)``: ``chip_smoke.py`` times
    ``torch.sparse.mm`` of its CSR form (cuSPARSE SpMM) as the yardstick.
    The port never calls it.
    """
    global launches
    fn = "consensus_gather_cuda"
    device = g.device
    if device.type != "cuda":
        raise ValueError(f"{fn}: tensors must be on a CUDA device, got {device}")
    if g.ndim != 2 or idx.ndim != 2:
        raise ValueError(f"{fn}: g and idx must be 2-D, got {tuple(g.shape)} "
                         f"and {tuple(idx.shape)}")
    m, n = g.shape
    check_buffer(fn, "g", g, g.shape, tuple(DTYPE_CODE), device)
    check_buffer(fn, "idx", idx, (m, idx.shape[1]), (torch.int32,), device)
    check_buffer(fn, "w", w, tuple(idx.shape), (torch.float32,), device)
    if out is None:
        out = torch.empty_like(g)
    else:
        check_buffer(fn, "out", out, g.shape, (g.dtype,), device)
        if overlaps(out, g):
            raise ValueError(f"{fn}: out overlaps g (gossip cannot run in "
                             f"place)")
    if g.numel() == 0:
        return out
    if idx.shape[1] == 0:
        raise ValueError(f"{fn}: k_max must be >= 1")
    k_max = int(idx.shape[1])
    plan = gather_plan(m, n, k_max, g.element_size(),
                       _sm_count(device.index))
    lib = _build.load()
    raise_on(fn, lib, lib.repro_consensus_gather(
        g.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), m, n,
        k_max, DTYPE_CODE[g.dtype], plan.rows, plan.blocks, plan.ring_bytes,
        device.index, stream_of(device)))
    launches += 1
    return out
