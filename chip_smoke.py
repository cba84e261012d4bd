#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, consensus and language-model
serving paths (RWKV6 and sliding-window attention) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the repository root on a machine with a CUDA card, PyTorch built
for CUDA and ``nvcc``; it imports ``repro_torch`` from ``src/`` and nothing of
JAX or the JAX package. Phases, each of which fails the run when it fails:

1. device — the card, its power limit, torch / CUDA / nvcc versions; TF32
   off for the plain reference's fp32 matmuls;
2. build — every kernel of ``src/repro_torch/kernels/csrc`` with ``nvcc``;
3. kernel vs plain — the hand-written ``policy_infer`` kernel against its
   plain PyTorch version on the card, over widths, batch sizes, modes, init
   scales and dtypes, and the in-place write into the noise buffer; and at
   its edges (``policy_infer_edges``: every bucket +-1, odd hidden widths,
   weights, obs and noise at element offsets 1-3, the kernel's limits);
4. serving — a seeded 6-64-1 policy through ``save_for_serving`` ->
   ``ServeEngine.from_checkpoint(device="cuda")`` -> ``MicroBatchQueue`` ->
   ``ServeEngine.decide``: full-fleet backlogs at m in {64, 1024, 10000}
   (decisions/sec) and an open-loop Poisson schedule at half that rate on a
   virtual clock (p50/p99 ms), in both modes; every decision is checked
   against a ``device="cpu"`` engine replaying the same batches with the
   same seed; the kernel's launches must equal the engine calls, with no
   build and no device allocation on the hot path;
5. times — per bucket, the kernel's and the plain version's device time
   (median of per-launch CUDA-event times; the kernel also by CUPTI and
   with the L2 flushed before each call) beside the card's bound;
6. flat kernels vs plain — the hand-written ``decay_accum``, ``row_mean``,
   ``momentum_update`` and ``adam_update`` kernels against their plain
   PyTorch versions on the card: shapes (n,), every (m, 9347) matrix of the
   training path (m in {7, 64, 1024, 10000}; m = 10000 in fp32 only) and odd
   sizes, scalar / device-scalar / per-row coefficients, fp32 / bf16 / fp16
   buffers, Nesterov on and off, Adam with weight decay 0 and 0.01, outputs
   written in place; ``decay_accum`` also bitwise where its 16-byte vectors
   straddle rows or meet an unaligned head and tail (n in {1, 3, 7, 8,
   9347}, acc / g / out at element offsets 0-3 of larger allocations, in
   place and into a separate buffer, all three coefficient forms);
7. training — federated PPO (``repro_torch.rl.run_fedrl(device="cuda")``)
   with the periodic (tau 10) and decay (tau 15, tau_i ~ U{1..15}, lambda
   0.95) strategies, each with SGD, momentum and Adam: the Table II geometry
   (shared FIGURE_EIGHT env, m = 7, T = 150, P = 25, eta = 5e-3), fleets of
   m in {64, 1024, 10000} agents with B = 1 (m = 64 also with B = 4 and 2 PPO
   epochs of 2 minibatches) and one run with bf16 buffers, each seeded and
   drawing on the card (these give updates/sec per m). The m = 7 and m = 64
   configurations run again on draws made on the host, on the card and on
   the CPU, which must agree; every kernel's launches must equal the count
   the loop implies, with no build on the hot path; the final server
   parameters go through ``save_for_serving`` ->
   ``ServeEngine.from_checkpoint(device="cuda")`` -> one ``decide``;
6b. gossip and compression kernels vs plain — the hand-written
   ``consensus_step`` (against ``torch.matmul`` within its rounding bound,
   and bitwise against ``consensus_gather`` over the full list; also at its
   tile edges, m in {1, 7, 31, 33, 64, 127, 129, 1024, 1025} x n in {1,
   127, 9347} with dense random P, and a NaN / Inf in a row of G whose
   column of P is 0 giving NaN where ``torch.matmul`` does),
   ``consensus_gather`` (bitwise, on the k-NN rings of the sparse path, at
   m = 10000, on a padded list, and at both kernels' edges:
   ``gather_edges``) and ``topk_scatter`` (residual bitwise,
   sum within its rounding bound; k = 584, ties, a zero row), fp32 / bf16 /
   fp16;
7b. consensus and compression — ``run_fedrl`` with the consensus strategy
   at m = 7 on the Fig. 6 topologies (E in {1, 2}, SGD / momentum / Adam),
   sparse (auto-selected) and dense (forced) on k-NN rings at m = 64 and
   1024, a top-k uplink, an int8 uplink and top-k gossip; seeded runs on the
   card, the m = 7 and m = 64 ones again on host-made draws on the card and
   on the CPU, launches held to the loop's count (consensus_step once per
   dense update, consensus_gather E times per sparse update, topk_scatter
   once per top-k sync);
8. times — per kernel at (1024, 9347) and a second shape of its path
   (``consensus_step`` and ``consensus_gather`` also at (64, 9347), the
   gather with the plan that picked its kernel), fp32: the kernel's, the plain
   version's and the library call's device time by CUDA events and by
   CUPTI (``torch.profiler``) beside the bound, the L2 evicted by a
   read-only pass before each call, the SM clock sampled by ``nvidia-smi``
   over each row's window; one profiled window of training updates at
   m = 1024 (device idle share, time by phase). ``consensus_step_alone``
   times ``consensus_step`` the same way from a copy of the repository
   whose kernel source was edited (to price a variant on the same card);
   ``policy_infer_gather_alone`` times ``policy_infer`` and
   ``consensus_gather`` from a copy at another commit, and
   ``gather_crossover`` the gather's two kernels against each other;
9. wkv6 vs plain — the hand-written ``wkv6`` kernel against the plain
   recurrence, both held to the plain loop in float64: (8, 512, 32, 64) and
   (1, 4096, 32, 64) (prefill), (8 | 1, 1, 32, 64) (decode), odd T (7,
   1000), zero and nonzero initial states, a slow decay, a split sequence
   chained through the state in place;
10. language-model serving (slice 4) — ``rwkv6-1.6b`` at full width and
   depth (24 layers, d 2048, 1,584,144,384 seeded bf16 parameters on the
   card) through ``make_prefill_step`` (8 x 512, 1 x 4096),
   ``make_serve_step`` (32 tokens at B = 8) and a ``ServingLoop`` of 8
   slots over 16 requests (prompts of 16-512 tokens, 32-64 new tokens):
   prefill / decode / loop tokens per second; wkv6 launched exactly 24
   times per prefill call and per decode step, no build. Checks: every
   completion token by token against single-request greedy decoding on the
   card (bf16: prefill and decode_step at B = 1 fed the loop's tokens, each
   token the argmax, or at a near-tie a logit within 2 bf16 ulp of the max,
   counted; the same requests in fp32: equal outright, each request's logits
   by one B = 1 prefill over its prompt and the loop's tokens); an admission
   leaves the other slots' state rows bitwise unchanged, where the JAX
   loop's admission (the control) moves them; the fp32 model with the
   kernel against the same with the plain loop (logits within 1e-3, greedy
   tokens equal wherever the margin exceeds twice that); the fp32 model on
   the card against the same on the CPU (2 x 16 prompt tokens, 4 decode
   steps, atol 1e-3);
11. times — wkv6 at the prefill and decode shapes (CUDA events and CUPTI,
   L2 flushed and warm) beside its bound and the plain loop's time; one
   profiled window of 16 decode steps at B = 8 (device idle share, wkv6 and
   matmul device time);
12. swa_attention vs plain — the hand-written ``swa_attention`` kernels
   (bf16: tensor cores, TMA, a K/V ring; fp32: CUDA cores) against their
   plain version, both held to the plain version in float64: (8, 512) and
   (1, 8192) with 32 / 8 heads of 120 and W = 4096, in bf16 and fp32; no
   window with causal on and off; W = 40 (below a tile) and W = 1; ragged
   lengths (7, 1000, 4097); D = 128 with 24 / 8 heads; Sq != Sk either way;
   in bf16 the 128-row tile edges (Sq, Sk of 129 and 255 both ways, W = 1
   and 100, causal off, B = 3 with H / KV = 4 and 1, D = 128). In bf16 also
   the mean error: the kernel's within 1.1x the plain version's, a rule
   that the control (the same function with one bf16 ``p``) must break
   wherever W > 1. The build phase counts the bf16 kernel's ``HGMMA``
   instructions (``cuobjdump -sass``) and fails on none;
13. sliding-window attention serving (slice 5) — ``h2o-danube-3-4b`` at
   full width and depth (24 layers, d 3840, 32 / 8 heads of 120, W 4096,
   3,961,839,360 seeded bf16 parameters on the card) through
   ``make_prefill_step`` (8 x 512, 1 x 8192), ``make_serve_step`` (32
   tokens at B = 8) and a ``ServingLoop`` of 8 slots over 16 requests
   (max_seq 4736; request 0's 4600-token prompt wraps its ring):
   prefill / decode / loop tokens per second; swa_attention launched
   exactly 24 times per prefill call and per admission, never in a decode
   step, no build. Checks: every completion against single-request greedy
   decoding on the card (bf16 with counted near-ties; fp32 outright); an
   admission leaves the other slots' cache rows bitwise unchanged; a bf16
   prefill at 8 x 512 and 1 x 8192 whose every layer's kernel output is
   held against the plain version on that layer's q, k, v by phase 12's
   rules (the control's ratio reported); in fp32 (the CUDA-core kernel)
   the card against the CPU (2 x 16 tokens, 4 decode steps), a prefill of
   4100 tokens and 8 decode steps against one forward over the 4108 (the
   ring wrapped) and the model with the kernel against the same with the
   plain attention (atol 1e-3);
14. times — swa_attention in bf16 at (8, 512), (1, 8192) and (1, 16384),
   W = 4096 (CUDA events and CUPTI, L2 flushed and warm) beside its bound
   (tensor-core FLOP with p_hi + p_lo, bytes, the SFU's exponentials), the
   plain version's time and SDPA's (the default call by CUDA events and
   CUPTI with the backend it picks, and each of flash, efficient and cuDNN
   that accepts the call); one profiled 1 x 8192 prefill (device idle share,
   the kernel's and the matmuls' device time) and one profiled window of 16
   decode steps at B = 8 (idle share, matmul share, top device ops);
15. sweep — the batched forms of the seven flat and gossip kernels
   (``sweep_kernels_vs_loop``): every ``(S, m, n)`` call one launch, bitwise
   equal to S unbatched launches on the runs' slices and to the plain
   version where phases 6 / 6b pin it (else within their tolerances), at
   (S, m, n) in {(12, 7, 9347), (16, 64, 9347), (4, 1024, 9347)}, fp32 /
   bf16 / fp16, scalar / shared / per-run / per-row coefficients, shared /
   per-run learning rates, mixing matrices and edge weights, and the S == m
   refusals; then ``repro_torch.sweep.run_sweep(device="cuda")`` on Fig. 5's
   lambda grid (3 x 4 seeds), Fig. 6's eps grid (3 x 4, dense and sparse),
   Fig. 4's taus grid (4 x 4), an eta x momentum / Adam grid and a top-k
   uplink point, m = 7, T 150, P 25, 2 epochs: each against
   ``run_sweep_loop`` (bitwise or within rtol / atol 1e-4, stated), its
   first 4 runs against the CPU on the same draws (1e-4), launches S times
   fewer than the loop's, runs/s of both forms; and each batched kernel's
   time (events and CUPTI, L2 flushed) against its loop of S launches,
   beside the bound of the S runs' work.

Its last lines are the kernel summary JSON, the card's name and power limit,
and ``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result. Details go to ``build/chip_smoke/result.json``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke", "ckpt")

SEED = 0
OBS_DIM, HIDDEN, ACT_DIM = 6, 64, 1          # the serving width
FLEETS = (64, 1024, 10000)
LOAD_FRACTION = 0.5
HORIZON_S = 0.25                             # open-loop schedule length
THROUGHPUT_REPEATS = 3
TIMED_LAUNCHES = 200
CHUNK = 25
# Published H100 SXM peaks at 700 W (NVIDIA data sheet): HBM3 rate, fp32
# outside the tensor cores, and dense bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# Kernel vs plain. Both are held against the plain version evaluated in
# float64 on the same (fp32-valued) inputs. The kernel's fp32 error must be
# within max(ATOL_F32, 2x the fp32 plain version's own error): at the
# init_policy scales that is 2e-6; with unit-scale weights the 64-term sums
# reach ~8 and fp32 itself is off by up to ~1e-5, in the kernel (FMA chains)
# and in cuBLAS (another blocking) alike. bf16 outputs may in addition round
# one bf16 ulp (2^-7 relative) away.
ATOL_F32 = 2e-6
BF16_REL = 2.0 ** -7
SERVE_ATOL = 2e-6                            # card engine vs CPU engine
# policy_infer's edges (same rule): every serving bucket and one row either
# side (one row a warp, 8 a block: the grid's edges), odd hidden widths (a
# lane's last unit past hidden, an odd layer-2 chain), the weights, biases,
# log_std, norm stats, obs and noise at element offsets 1-3 into larger
# allocations (the kernel's 4-byte head and tail copies beside its 16-byte
# body), and the kernel's limits (obs_dim 128, hidden 128, act_dim 32), fp32
# and bf16, the actions written into the noise buffer.
PI_BUCKETS = (8, 64, 256, 1024)
PI_BUCKET_EDGES = (7, 8, 9, 63, 64, 65, 255, 256, 257, 1023, 1024, 1025)
PI_ODD_DIMS = ((5, 33, 2), (3, 97, 4))
PI_OFFSETS = (1, 2, 3)
PI_LIMITS = (128, 128, 32)

# Flat kernels vs plain: the kernels spell each operation with the IEEE
# round-to-nearest intrinsics in the plain versions' order, so they are held
# to 2 ulp of the output's dtype (they come out bitwise equal); row_mean sums
# in another order than torch: 1e-6 of the column's mean |g| (+ one rounding
# to the dtype). The shapes hold every (m, n) matrix the training path hands
# the kernels, (m, 9347) for m in {7, 64, 1024, 10000}, in the dtypes it
# hands them (bf16 buffers only at m = 64, where the bf16 run is), and odd
# sizes.
FLAT_KERNELS = ("decay_accum", "row_mean", "momentum_update", "adam_update")
GOSSIP_KERNELS = ("consensus_step", "consensus_gather", "topk_scatter")
TRAIN_KERNELS = FLAT_KERNELS + GOSSIP_KERNELS
ALL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
FLAT_SHAPES = (((9347,), ALL_DTYPES), ((4097,), ALL_DTYPES),
               ((1,), ALL_DTYPES), ((7, 9347), ALL_DTYPES),
               ((64, 9347), ALL_DTYPES), ((1024, 9347), ALL_DTYPES),
               ((10000, 9347), (torch.float32,)), ((64, 4097), ALL_DTYPES),
               ((7, 1), ALL_DTYPES))
FLAT_ULPS = 2
ROW_MEAN_REL = 1e-6
TIMED_SHAPES = ((1024, 9347), (7, 9347))
# decay_accum's edges: n where a 16-byte vector straddles rows (odd, < 8) and
# element offsets of acc, g and out into larger allocations (16-byte
# alignments that differ), each case in place and into a separate out.
DACC_EDGE_N = (1, 3, 7, 8, 9347)
DACC_EDGE_OFFSETS = ((0, 0, 0), (1, 1, 1), (1, 3, 2), (3, 2, 1), (2, 2, 0))
# row_mean's edges: n in each residue mod 8 (a row starts at its own phase
# inside the kernel's 16-byte vectors of 4 fp32 or 8 bf16 / fp16 elements),
# n below one vector, and n where the tile width steps (tiles of about one a
# SM: 528 and 1,056 columns are one and two fp32 vectors a tile on 132
# SMs); m at the switch between the kernel for few rows and the tiled one
# (64 / 65), one row past each step of the tiled kernel's row groups (8
# more a step, m = 33, 97, ..., up to its cap) and past batch edges; g at
# element offsets 0-7 into a larger allocation. Each case is also called
# twice and must repeat bitwise.
ROW_MEAN_EDGE_N = (1, 3, 7, 8, 9, 10, 11, 528, 529, 1057, 9347)
ROW_MEAN_EDGE_M = (1, 2, 33, 64, 65, 97, 129, 161, 193, 257, 385, 1031)
ROW_MEAN_EDGE_OFFSETS = tuple(range(8))
# row_mean is timed at the training path's other fleets too
ROW_MEAN_TIMED = ((64, 9347), (10000, 9347))
# consensus_step's tile edges: the small-m kernel (m <= 32), the 64- and
# 128-row tiles and one past each; 96-column tiles and short rows.
STEP_EDGE_M = (1, 7, 31, 33, 64, 127, 129, 1024, 1025)
STEP_EDGE_N = (1, 127, 9347)
# consensus_gather's edges, each bitwise against the plain version: n in
# every residue mod 8 (a source row's phase in the staged kernel's 16-byte
# copies; one to three column tiles) with g at element offsets 0-7, three
# dtypes, over the lists of GATHER_EDGE_LISTS (built by gather_edge_lists).
GATHER_EDGE_N = (129, 130, 131, 132, 133, 134, 135, 136)
GATHER_EDGE_OFFSETS = tuple(range(8))
CUPTI_CALLS = 50
CUPTI_WINDOWS = 8     # profiler windows tried before a lost trace fails

# Training: the Table II geometry of benchmarks/fmarl_bench.py:23-26 (T, P,
# eta), 3 epochs = 18 local updates so that the decay strategy's tau = 15
# period closes once.
TRAIN_T, TRAIN_P, TRAIN_ETA, TRAIN_EPOCHS = 150, 25, 5e-3, 3
# Phases 7 and 7b run their tau = 10 configurations (periodic, consensus,
# the top-k ones) for 2 epochs (12 updates, one sync): phase 15 took the
# time they give back, so that the whole script stays in its 642 s.
CUT_EPOCHS = 2
TRAIN_FLEETS = (64, 1024, 10000)
# Card vs CPU on the same draws: per-epoch metrics within rtol 1e-4 (the
# figure tests/test_flat_loop.py allows between the JAX package's own
# backends), server parameters within atol 1e-4 (Adam divides by sqrt(nu):
# a few-ulp change in a near-zero gradient entry moves its step by up to
# eta). With bf16 buffers the row is bf16: + one bf16 ulp (rtol 2^-7) on the
# parameters and rtol 1e-3 on the metrics.
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-4
TRAIN_BF16_RTOL = 1e-3
PROFILE_M = 1024


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# --- phase 3: kernel vs plain ---------------------------------------------------

def make_inputs(obs_dim, hidden, act_dim, batch, init, seed):
    """fp32 weights, norm stats, obs and noise on the card."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    if init == "unit":        # unit-scale weights: the tanh layers saturate
        pi = {"w1": f(obs_dim, hidden), "b1": f(hidden),
              "w2": f(hidden, hidden), "b2": f(hidden),
              "w3": f(hidden, act_dim), "b3": f(act_dim),
              "log_std": 0.3 * f(act_dim)}
    else:                     # the init_policy scales: w3 is 0.01x
        pi = {"w1": f(obs_dim, hidden) / np.sqrt(obs_dim),
              "b1": np.zeros(hidden, np.float32),
              "w2": f(hidden, hidden) / np.sqrt(hidden),
              "b2": np.zeros(hidden, np.float32),
              "w3": 0.01 * f(hidden, act_dim) / np.sqrt(hidden),
              "b3": np.zeros(act_dim, np.float32),
              "log_std": np.full(act_dim, -0.5, np.float32)}
    nm = 0.5 * f(obs_dim)
    ns = rng.uniform(0.5, 2.0, obs_dim).astype(np.float32)
    obs = 2.0 * f(batch, obs_dim)
    noise = f(batch, act_dim)
    cuda = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")
    return ({k: cuda(v) for k, v in pi.items()}, cuda(nm), cuda(ns),
            cuda(obs), cuda(noise))


def kernel_vs_plain(pinf) -> dict:
    f32, bf16 = torch.float32, torch.bfloat16
    worst = {"float32": 0.0, "bfloat16": 0.0, "plain_fp32_vs_fp64": 0.0}
    n_cases = 0
    for dims in ((6, 64, 1), (6, 16, 2)):
        for batch in (1, 37, 1024, 10000):
            for init in ("jax_like", "unit"):
                pi, nm, ns, obs32, noise32 = make_inputs(*dims, batch, init,
                                                         seed=n_cases)
                pi64 = {k: v.double() for k, v in pi.items()}
                for sample in (False, True):
                    ref64 = pinf.policy_infer_plain(
                        obs32.double(), pi64, nm.double(), ns.double(),
                        noise32.double(), sample=sample)
                    ref32 = pinf.policy_infer_plain(obs32, pi, nm, ns, noise32,
                                                    sample=sample)
                    e_plain = (ref32.double() - ref64).abs().max().item()
                    tol = max(ATOL_F32, 2.0 * e_plain)
                    worst["plain_fp32_vs_fp64"] = max(
                        worst["plain_fp32_vs_fp64"], e_plain)
                    for obs_dt, noise_dt in ((f32, f32), (bf16, bf16),
                                             (bf16, f32), (f32, bf16)):
                        # bf16 cases take the bf16-rounded values as inputs
                        obs, noise = obs32.to(obs_dt), noise32.to(noise_dt)
                        r64 = ref64
                        if (obs_dt, noise_dt) != (f32, f32):
                            r64 = pinf.policy_infer_plain(
                                obs.double(), pi64, nm.double(), ns.double(),
                                noise.double(), sample=sample)
                        plain = pinf.policy_infer_plain(obs, pi, nm, ns, noise,
                                                        sample=sample)
                        if obs_dt == noise_dt:      # actions into noise
                            buf = noise.clone()
                            got = pinf.policy_infer_cuda(
                                obs, pi, nm, ns, buf, sample=sample, out=buf)
                            if got.data_ptr() != buf.data_ptr():
                                raise AssertionError("output does not alias "
                                                     "the noise buffer")
                        else:
                            got = pinf.policy_infer_cuda(obs, pi, nm, ns,
                                                         noise, sample=sample)
                        torch.cuda.synchronize()
                        if got.dtype != obs_dt or got.shape != plain.shape:
                            raise AssertionError(
                                f"kernel gave {got.dtype}{tuple(got.shape)}, "
                                f"expected {obs_dt}{tuple(plain.shape)}")
                        err = (got.double() - r64).abs()
                        bound = tol + (BF16_REL * r64.abs() if obs_dt == bf16
                                       else 0.0)
                        if not torch.isfinite(got.float()).all() or \
                                bool((err > bound).any()):
                            raise AssertionError(
                                f"kernel vs plain: dims={dims} B={batch} "
                                f"init={init} obs={obs_dt} noise={noise_dt} "
                                f"sample={sample}: max err vs fp64 "
                                f"{err.max().item():.3e}, fp32 plain's own "
                                f"{e_plain:.3e}")
                        key = str(obs_dt).replace("torch.", "")
                        worst[key] = max(worst[key], (got.float() - plain.float())
                                         .abs().max().item())
                        n_cases += 1
    # B == 0 launches nothing; a non-fp32 weight is refused.
    pi, nm, ns, obs, noise = make_inputs(6, 64, 1, 4, "unit", 0)
    before = pinf.launches
    empty = pinf.policy_infer_cuda(obs[:0], pi, nm, ns, noise[:0])
    if empty.shape != (0, 1) or pinf.launches != before:
        raise AssertionError("B == 0 must return (0, act_dim) without a launch")
    try:
        pinf.policy_infer_cuda(obs, {**pi, "w2": pi["w2"].double()}, nm, ns,
                               noise)
    except TypeError:
        pass
    else:
        raise AssertionError("a float64 weight was not refused")
    edges = policy_infer_edges(pinf)
    log(f"phase kernel_vs_plain: {n_cases} cases ok; max |kernel - plain| "
        f"fp32 {worst['float32']!r}, bf16 {worst['bfloat16']!r}; fp32 plain vs "
        f"fp64 up to {worst['plain_fp32_vs_fp64']!r}; tolerance vs fp64: "
        f"max({ATOL_F32}, 2x fp32 plain's error) (+ 2^-7 |ref| in bf16); "
        f"edges: {edges['cases']} cases ok (buckets {PI_BUCKET_EDGES}, odd "
        f"dims {PI_ODD_DIMS}, offsets {PI_OFFSETS}, limits {PI_LIMITS}), max "
        f"|kernel - plain| {edges['max_abs_err']}")
    return {"cases": n_cases, "max_abs_err": worst, "edges": edges}


def policy_infer_edges(pinf) -> dict:
    """policy_infer at its edges (PI_* above) under kernel_vs_plain's rule:
    within max(ATOL_F32, 2x the fp32 plain version's own error) of the plain
    version in float64 (+ BF16_REL |ref| for bf16 outputs)."""
    f32, bf16 = torch.float32, torch.bfloat16
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = 0

    def check(pi, nm, ns, obs, noise, sample, inplace, label):
        nonlocal cases
        pi64 = {k: v.double() for k, v in pi.items()}
        r64 = pinf.policy_infer_plain(obs.double(), pi64, nm.double(),
                                      ns.double(), noise.double(),
                                      sample=sample)
        plain32 = pinf.policy_infer_plain(obs.float(), pi, nm, ns,
                                          noise.float(), sample=sample)
        e_plain = (plain32.double() - r64).abs().max().item()
        if inplace:
            buf = noise.clone()
            got = pinf.policy_infer_cuda(obs, pi, nm, ns, buf, sample=sample,
                                         out=buf)
            if got.data_ptr() != buf.data_ptr():
                raise AssertionError(f"policy_infer edge {label}: output does "
                                     f"not alias the noise buffer")
        else:
            got = pinf.policy_infer_cuda(obs, pi, nm, ns, noise,
                                         sample=sample)
        torch.cuda.synchronize()
        err = (got.double() - r64).abs()
        bound = max(ATOL_F32, 2.0 * e_plain) + (
            BF16_REL * r64.abs() if obs.dtype == bf16 else 0.0)
        if got.dtype != obs.dtype or not torch.isfinite(got.float()).all() \
                or bool((err > bound).any()):
            raise AssertionError(
                f"policy_infer edge {label} sample={sample}: max err vs fp64 "
                f"{err.max().item():.3e}, fp32 plain's own {e_plain:.3e}")
        plain = pinf.policy_infer_plain(obs, pi, nm, ns, noise, sample=sample)
        key = str(obs.dtype).replace("torch.", "")
        worst[key] = max(worst[key],
                         (got.float() - plain.float()).abs().max().item())
        cases += 1

    seed = 1000
    for dims, batches in (((OBS_DIM, HIDDEN, ACT_DIM), PI_BUCKET_EDGES),
                          *[(d, (1, 65)) for d in PI_ODD_DIMS]):
        for batch in batches:
            for init in ("jax_like", "unit"):
                seed += 1
                pi, nm, ns, obs, noise = make_inputs(*dims, batch, init, seed)
                for sample in (False, True):
                    check(pi, nm, ns, obs, noise, sample, sample,
                          f"dims={dims} B={batch} init={init}")
    for off in PI_OFFSETS:
        for dims in ((OBS_DIM, HIDDEN, ACT_DIM), PI_LIMITS):
            for batch in (64, 1025):
                seed += 1
                pi, nm, ns, obs, noise = make_inputs(*dims, batch, "jax_like",
                                                     seed)
                pi = {k: at_offset(v, off) for k, v in pi.items()}
                nm, ns = at_offset(nm, off), at_offset(ns, off)
                obs, noise = at_offset(obs, off), at_offset(noise, off)
                for sample in (False, True):
                    check(pi, nm, ns, obs, noise, sample, False,
                          f"dims={dims} B={batch} offset={off}")
    for batch in (1, 37, 64, 1024):
        for init in ("jax_like", "unit"):
            seed += 1
            pi, nm, ns, obs, noise = make_inputs(*PI_LIMITS, batch, init, seed)
            for sample in (False, True):
                for dt in (f32, bf16):
                    check(pi, nm, ns, obs.to(dt), noise.to(dt), sample, True,
                          f"limits B={batch} init={init} {dt} in place")
    return {"cases": cases, "max_abs_err": worst}


# --- phase 4: the serving path --------------------------------------------------

def drain_backlog(eng, m, rng, record, serve) -> float:
    """Decisions/sec draining a backlog of one observation per agent."""
    q = serve.MicroBatchQueue(max_batch=eng.max_batch(), obs_dim=OBS_DIM)
    obs = rng.standard_normal((m, OBS_DIM)).astype(np.float32)
    q.push_all([serve.ObsRequest(i, 0.0, obs[i]) for i in range(m)])
    n = 0
    t0 = time.perf_counter()
    while (nxt := q.next_batch()) is not None:
        batch, reqs = nxt
        record.append((batch, eng.decide(batch)))
        n += len(reqs)
    dt = time.perf_counter() - t0
    if n != m:
        raise AssertionError(f"drained {n} of {m} requests")
    return m / dt


def open_loop(eng, m, rate_total, record, serve) -> np.ndarray:
    """Latency on a virtual clock: arrivals from the seeded Poisson schedule,
    service times measured; latency = completion - arrival (seconds)."""
    reqs = serve.simulate_clients(m, rate_total / m, HORIZON_S,
                                  obs_dim=OBS_DIM, seed=SEED + m)
    lat = np.empty(len(reqs))
    clock, i = 0.0, 0
    while i < len(reqs):
        clock = max(clock, reqs[i].t_arrival)
        j, cap = i, i + eng.max_batch()
        while j < len(reqs) and reqs[j].t_arrival <= clock and j < cap:
            j += 1
        batch = np.stack([r.obs for r in reqs[i:j]])
        t0 = time.perf_counter()
        act = eng.decide(batch)
        clock += time.perf_counter() - t0
        record.append((batch, act))
        lat[i:j] = clock - np.array([r.t_arrival for r in reqs[i:j]])
        i = j
    return lat


def device_allocations() -> int:
    return torch.cuda.memory_stats().get("allocation.all.allocated", 0)


def serving_path(pinf, _build, serve, policy, card) -> dict:
    gen = torch.Generator().manual_seed(SEED)
    params = policy.init_policy(OBS_DIM, HIDDEN, ACT_DIM, generator=gen,
                                device="cuda")
    norm = serve.ObsNorm(np.linspace(-0.5, 0.5, OBS_DIM).astype(np.float32),
                         np.full(OBS_DIM, 1.25, np.float32))
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    serve.save_for_serving(CKPT_DIR, 0, params, norm=norm)

    builds_before = _build.n_builds
    pinf.launches = 0                      # the main path starts here
    out = {"modes": {}}
    for mode in ("mean", "sample"):
        start = pinf.launches
        eng = serve.ServeEngine.from_checkpoint(CKPT_DIR, mode=mode, seed=SEED,
                                                device="cuda")
        warm = pinf.launches - start
        if eng.n_builds != 1 or warm != len(eng.buckets):
            raise AssertionError(f"construction: n_builds={eng.n_builds}, "
                                 f"warm-up launches={warm}")
        record = []
        allocs = device_allocations()
        hot_start = pinf.launches
        fleets = {}
        for m in FLEETS:
            rng = np.random.default_rng(SEED + m)
            dps = max(drain_backlog(eng, m, rng, record, serve)
                      for _ in range(THROUGHPUT_REPEATS))
            lat = open_loop(eng, m, LOAD_FRACTION * dps, record, serve)
            fleets[m] = {
                "decisions_per_sec": dps,
                "p50_ms": float(np.percentile(lat, 50) * 1e3),
                "p99_ms": float(np.percentile(lat, 99) * 1e3),
                "offered_rate": LOAD_FRACTION * dps,
                "n_requests": int(lat.shape[0]),
            }
        hot = pinf.launches - hot_start
        calls = sum(eng.bucket_calls.values())
        if hot != calls or calls != len(record):
            raise AssertionError(f"{mode}: {hot} kernel launches for {calls} "
                                 f"engine calls")
        if eng.n_builds != 1 or _build.n_builds != builds_before:
            raise AssertionError(f"{mode}: a build on the hot path")
        if device_allocations() != allocs:
            raise AssertionError(f"{mode}: device allocations on the hot path")

        ref_eng = serve.ServeEngine.from_checkpoint(CKPT_DIR, mode=mode, seed=SEED,
                                                    device="cpu")
        worst = 0.0
        for batch, act in record:
            if act.shape != (batch.shape[0], ACT_DIM) or \
                    not np.all(np.isfinite(act)):
                raise AssertionError(f"{mode}: bad decisions {act.shape}")
            worst = max(worst, float(np.max(np.abs(act - ref_eng.decide(batch)))))
        if worst > SERVE_ATOL:
            raise AssertionError(f"{mode}: card vs CPU engine max err {worst:.3e}")
        for m, r in fleets.items():
            log(f"serving mode={mode} m={m} decisions_per_sec="
                f"{r['decisions_per_sec']!r} p50_ms={r['p50_ms']!r} "
                f"p99_ms={r['p99_ms']!r} n_requests={r['n_requests']} "
                f"card=\"{card}\"")
        log(f"serving mode={mode}: {calls} engine calls = {hot} kernel "
            f"launches (+{warm} warm-up); bucket_calls={eng.bucket_calls}; "
            f"n_builds={eng.n_builds}; {len(record)} batches match the CPU "
            f"engine, max abs err {worst!r} (atol {SERVE_ATOL})")
        out["modes"][mode] = {
            "fleets": {str(m): r for m, r in fleets.items()},
            "engine_calls": calls, "hot_launches": hot, "warmup_launches": warm,
            "bucket_calls": {str(b): c for b, c in eng.bucket_calls.items()},
            "n_builds": eng.n_builds, "max_abs_err_vs_cpu": worst,
        }
    out["launches"] = pinf.launches          # read right after the main path
    return out


# --- phase 5: device times ------------------------------------------------------

def sleep_cycles_per_ms() -> float:
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1000)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    torch.cuda.synchronize()
    return 10_000_000 / a.elapsed_time(b)


def device_ms(fn, cycles_per_ms: float, flush=None,
              launches: int = TIMED_LAUNCHES) -> tuple:
    """Median device time of one call, from per-call CUDA events over
    ``launches`` calls (a multiple of CHUNK).

    The calls are enqueued in chunks of CHUNK behind a spin kernel that holds
    the stream until the host has enqueued the whole chunk (a chunk stays
    well inside the card's queue of pending work), so host launch gaps do not
    enter the times. Also returns the idle gap between two calls of a
    chunk (median over the chunks' calls). ``flush``, when given, runs before
    each call, outside its events (to evict the L2 cache).
    """
    def call():
        if flush is not None:
            flush()
        fn()

    for _ in range(10):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CHUNK):
        call()
    torch.cuda.synchronize()
    hold_ms = 2.0 * (time.perf_counter() - t0) * 1e3 + 1.0
    times, gaps = [], []
    for _ in range(launches // CHUNK):
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(CHUNK)]
        torch.cuda._sleep(int(cycles_per_ms * hold_ms))
        for s, e in ev:
            if flush is not None:
                flush()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        times += [s.elapsed_time(e) for s, e in ev]
        gaps += [ev[i][1].elapsed_time(ev[i + 1][0]) for i in range(CHUNK - 1)]
    return statistics.median(times), statistics.median(gaps)


def profile_serving(serve, card) -> dict:
    """A ``torch.profiler`` window over 200 engine calls at bucket 64: the
    kernel's device time per launch (CUPTI) and the device's busy share of
    the window's wall time (kernels + copies; profiler overhead inflates the
    host side, so the idle share is an upper bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = serve.ServeEngine.from_checkpoint(CKPT_DIR, mode="sample", seed=SEED,
                                            device="cuda")
    rng = np.random.default_rng(SEED)
    batches = [rng.standard_normal((64, OBS_DIM)).astype(np.float32)
               for _ in range(200)]
    for obs in batches[:20]:
        eng.decide(obs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for obs in batches:
            eng.decide(obs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side records only (kernels, copies): a CPU op's device total
    # repeats the time of what it launched
    dev = {e.key: (e.count, e.self_device_time_total)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    kern = [(n, t) for k, (n, t) in dev.items() if "policy_infer_kernel" in k]
    busy_us = sum(t for _, t in dev.values())
    out = {
        "calls": len(batches), "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us if dev else None,
        "kernel_launches": sum(n for n, _ in kern) if kern else None,
        "kernel_us_per_launch": (sum(t for _, t in kern) / sum(n for n, _ in kern)
                                 if kern else None),
        "device_ops": {k: {"count": n, "self_device_us": t}
                       for k, (n, t) in dev.items()},
    }
    log(f"profile serving bucket=64 mode=sample calls=200 wall_ms="
        f"{out['wall_ms']!r} device_busy_ms={out['device_busy_ms']!r} "
        f"device_idle_share={out['device_idle_share']!r} kernel_us_per_launch="
        f"{out['kernel_us_per_launch']!r} (launches {out['kernel_launches']}) "
        f"card=\"{card}\"")
    return out


def bound(batch, sample) -> tuple:
    flops = batch * 2 * (OBS_DIM * HIDDEN + HIDDEN * HIDDEN + HIDDEN * ACT_DIM)
    weights = (OBS_DIM * HIDDEN + HIDDEN * HIDDEN + HIDDEN * ACT_DIM
               + 2 * HIDDEN + 2 * ACT_DIM + 2 * OBS_DIM)
    nbytes = 4 * (weights + batch * OBS_DIM + batch * ACT_DIM
                  + (batch * ACT_DIM if sample else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            flops, nbytes)


def times(pinf, serving, card) -> dict:
    cyc = sleep_cycles_per_ms()
    # what the same event pair reads around one trivial kernel
    tiny = torch.zeros(8, device="cuda")
    floor_ms, _ = device_ms(tiny.zero_, cyc)
    log(f"time floor: one zero_() of 8 floats reads {floor_ms!r} ms "
        f"card=\"{card}\"")
    rows = {"floor_ms": floor_ms}
    flush = l2_flusher()
    for mode in ("mean", "sample"):
        sample = mode == "sample"
        calls = serving["modes"][mode]["bucket_calls"]
        for b in PI_BUCKETS:
            pi, nm, ns, obs, noise = make_inputs(
                OBS_DIM, HIDDEN, ACT_DIM, b, "jax_like", seed=b)
            out = torch.empty_like(noise)
            kern = lambda: pinf.policy_infer_cuda(obs, pi, nm, ns, noise,
                                                  sample=sample, out=out)
            plain = lambda: pinf.policy_infer_plain(obs, pi, nm, ns, noise,
                                                    sample=sample, out=out)
            # in turns: plain, kernel, kernel, plain
            (p1, g1), (k1, g2) = device_ms(plain, cyc), device_ms(kern, cyc)
            (k2, g3), (p2, g4) = device_ms(kern, cyc), device_ms(plain, cyc)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            gap = max(g1, g2, g3, g4)
            # the L2 flushed before every call: the weights come from
            # device memory, as after other work has passed through the L2
            f1, f2 = (device_ms(kern, cyc, flush)[0] for _ in range(2))
            b_ms, b_by, flops, nbytes = bound(b, sample)
            rec = rows[f"{mode}/{b}"] = {
                "bucket": b, "mode": mode, "ms": ms, "plain_ms": plain_ms,
                "cupti_ms": cupti_ms(kern, None, "policy_infer_kernel"),
                "flushed_ms": (f1 + f2) / 2,
                "flushed_cupti_ms": cupti_ms(kern, flush,
                                             "policy_infer_kernel"),
                "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
                "bytes": nbytes, "launches_on_path": calls[str(b)],
                "idle_gap_ms": gap,
            }
            log(f"time policy_infer mode={mode} bucket={b} kernel_ms={ms!r} "
                f"(cupti {rec['cupti_ms']!r}; L2 flushed: events "
                f"{rec['flushed_ms']!r}, cupti {rec['flushed_cupti_ms']!r}) "
                f"plain_ms={plain_ms!r} bound_ms={b_ms!r} ({b_by}) "
                f"launches_on_path={calls[str(b)]} idle_gap_ms={gap!r} "
                f"card=\"{card}\"")
    return rows


# --- phase 6: flat kernels vs plain ---------------------------------------------

def flat_kernels_vs_plain(dacc, fu, dispatch) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rnd = lambda shape, dt, scale=1.0: (
        torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)
    worst = {k: {} for k in FLAT_KERNELS}        # by output dtype
    counts = {k: 0 for k in FLAT_KERNELS}
    bitwise = {k: 0 for k in FLAT_KERNELS}

    def check(name, got, want, dtype, case, scale=None):
        got32, want32 = got.float(), want.float()
        err = (got32 - want32).abs()
        tol = FLAT_ULPS * torch.finfo(dtype).eps * want32.abs()
        if scale is not None:
            tol = ROW_MEAN_REL * scale + torch.finfo(dtype).eps * want32.abs()
        if got.dtype != want.dtype or got.shape != want.shape or \
                not bool(torch.isfinite(got32).all()) or bool((err > tol).any()):
            raise AssertionError(
                f"{name} kernel vs plain: {case}: {got.dtype}{tuple(got.shape)}"
                f" vs {want.dtype}{tuple(want.shape)}, max err "
                f"{err.max().item():.3e}")
        key = str(got.dtype).replace("torch.", "")
        worst[name][key] = max(worst[name].get(key, 0.0), err.max().item())
        counts[name] += 1
        bitwise[name] += int(torch.equal(got, want))

    def same_buffer(got, buf, case):
        if got.data_ptr() != buf.data_ptr():
            raise AssertionError(f"{case}: output not written in place")

    bc1, bc2 = dispatch.adam_bias_corrections(3, 0.9, 0.95)
    for shape, dtypes in FLAT_SHAPES:
        m = shape[0] if len(shape) == 2 else 1
        for dt in dtypes:
            p, g = rnd(shape, dt), rnd(shape, dt)
            mu = rnd(shape, torch.float32, 0.1)
            nu = rnd(shape, torch.float32, 0.1).abs()
            coefs = [0.37, torch.tensor(-0.61, device="cuda")]
            if len(shape) == 2:
                coefs.append(torch.rand(m, generator=gen, device="cuda"))
            for ci, c in enumerate(coefs):
                case = f"shape={shape} dtype={dt} coef#{ci}"
                buf = p.clone()
                got = dacc.decay_accum_cuda(buf, g, c, out=buf)
                same_buffer(got, buf, case)
                check("decay_accum", got, dacc.decay_accum_plain(p, g, c), dt,
                      case)
                for nesterov in (False, True):
                    pb, mb = p.clone(), mu.clone()
                    got = fu.momentum_update_cuda(pb, g, mb, c, 5e-3, 0.9,
                                                  nesterov=nesterov, p_out=pb,
                                                  mu_out=mb)
                    same_buffer(got[0], pb, case)
                    same_buffer(got[1], mb, case)
                    want = fu.momentum_update_plain(p, g, mu, c, 5e-3, 0.9,
                                                    nesterov=nesterov)
                    for a, b in zip(got, want):
                        check("momentum_update", a, b, a.dtype,
                              f"{case} nesterov={nesterov}")
                for wd in (0.0, 0.01):
                    pb, mb, vb = p.clone(), mu.clone(), nu.clone()
                    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=wd)
                    got = fu.adam_update_cuda(pb, g, mb, vb, c, 5e-3, bc1, bc2,
                                              p_out=pb, mu_out=mb, nu_out=vb,
                                              **kw)
                    for a, b in zip(got, (pb, mb, vb)):
                        same_buffer(a, b, case)
                    want = fu.adam_update_plain(p, g, mu, nu, c, 5e-3, bc1,
                                                bc2, **kw)
                    for a, b in zip(got, want):
                        check("adam_update", a, b, a.dtype, f"{case} wd={wd}")
            if len(shape) == 2:
                got = fu.row_mean_cuda(g)
                if not torch.equal(fu.row_mean_cuda(g), got):
                    raise AssertionError(f"row_mean shape={shape} dtype={dt}: "
                                         f"two calls differ")
                check("row_mean", got, fu.row_mean_plain(g), dt,
                      f"shape={shape} dtype={dt}",
                      scale=g.float().abs().mean(0))
    n_edges = decay_accum_edges(dacc, rnd)
    counts["decay_accum"] += n_edges
    bitwise["decay_accum"] += n_edges
    n_mean_edges = row_mean_edges(fu, rnd, check)
    torch.cuda.synchronize()
    log(f"phase flat_kernel_vs_plain: {sum(counts.values())} checks ok "
        f"({counts}); bitwise equal to the plain version in {bitwise}; max "
        f"|kernel - plain| {worst}; tolerance {FLAT_ULPS} ulp of the output "
        f"dtype (row_mean: {ROW_MEAN_REL} x mean|g| + 1 ulp); decay_accum "
        f"bitwise at {n_edges} edge cases (n {DACC_EDGE_N}, element offsets "
        f"of acc / g / out {DACC_EDGE_OFFSETS}, in place and not, three "
        f"coefficient forms); row_mean at {n_mean_edges} edge cases (m "
        f"{ROW_MEAN_EDGE_M}, n {ROW_MEAN_EDGE_N}, element offsets "
        f"{ROW_MEAN_EDGE_OFFSETS}, three dtypes), every row_mean case "
        f"bitwise the same on a second call")
    return {"checks": counts, "bitwise": bitwise, "max_abs_err": worst,
            "decay_accum_edges": n_edges, "row_mean_edges": n_mean_edges}


def at_offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of ``t`` that starts ``offset`` elements into a larger
    allocation: a contiguous view whose address is not 16-byte aligned when
    ``offset`` elements are not a multiple of 16 bytes."""
    big = torch.zeros(t.numel() + 8, dtype=t.dtype, device=t.device)
    return big[offset:offset + t.numel()].view(t.shape).copy_(t)


def decay_accum_edges(dacc, rnd) -> int:
    """decay_accum bitwise against its plain version where its 16-byte
    vectors straddle rows or meet a head and tail that are not aligned:
    (n,) and (3, n) buffers for n in DACC_EDGE_N, acc / g / out at the
    element offsets of DACC_EDGE_OFFSETS, fp32 / bf16 / fp16, a scalar, a
    device scalar and a per-row coefficient, written in place and into a
    separate buffer. Returns the number of checks."""
    checks = 0
    for n in DACC_EDGE_N:
        for shape in ((n,), (3, n)):
            for dt in ALL_DTYPES:
                acc0, g0 = rnd(shape, dt), rnd(shape, dt)
                coefs = [0.37, torch.tensor(-0.61, device="cuda")]
                if len(shape) == 2:
                    coefs.append(torch.linspace(-1.0, 1.0, 3, device="cuda"))
                for o_acc, o_g, o_out in DACC_EDGE_OFFSETS:
                    acc, g = at_offset(acc0, o_acc), at_offset(g0, o_g)
                    for ci, c in enumerate(coefs):
                        want = dacc.decay_accum_plain(acc, g, c)
                        buf = at_offset(acc, o_acc)
                        got = dacc.decay_accum_cuda(buf, g, c, out=buf)
                        out = at_offset(torch.full_like(acc, float("nan")),
                                        o_out)
                        sep = dacc.decay_accum_cuda(acc, g, c, out=out)
                        case = (f"decay_accum edge shape={shape} dtype={dt} "
                                f"offsets={(o_acc, o_g, o_out)} coef#{ci}")
                        if got.data_ptr() != buf.data_ptr() or \
                                sep.data_ptr() != out.data_ptr():
                            raise AssertionError(f"{case}: output not "
                                                 f"written where asked")
                        for what, t in (("in place", got), ("out", sep)):
                            if not torch.equal(t, want):
                                err = (t.float() - want.float()).abs().max()
                                raise AssertionError(
                                    f"{case} {what}: not bitwise equal to "
                                    f"the plain version, max err "
                                    f"{err.item():.3e}")
                        checks += 2
    return checks


def row_mean_edges(fu, rnd, check) -> int:
    """row_mean against its plain version where its aligned 16-byte vectors
    meet odd rows, short rows and tile edges, across its two kernels and its
    row-group counts, on views at every element offset of a 16-byte vector
    (ROW_MEAN_EDGE_*), fp32 / bf16 / fp16 (``check``: 1e-6 x mean|g| + 1
    ulp); each case is called twice and must repeat bitwise. Returns the
    number of cases."""
    cases = 0
    for n in ROW_MEAN_EDGE_N:
        for m in ROW_MEAN_EDGE_M:
            for dt in ALL_DTYPES:
                g0 = rnd((m, n), dt)
                want = fu.row_mean_plain(g0)
                scale = g0.float().abs().mean(0)
                for off in ROW_MEAN_EDGE_OFFSETS:
                    g = at_offset(g0, off)
                    out = torch.full((n + 8,), float("nan"), dtype=dt,
                                     device="cuda")[off:off + n]
                    got = fu.row_mean_cuda(g, out=out)
                    case = f"row_mean edge m={m} n={n} dtype={dt} offset={off}"
                    if got.data_ptr() != out.data_ptr() or \
                            not torch.equal(fu.row_mean_cuda(g), got):
                        raise AssertionError(f"{case}: not written where asked "
                                             f"or two calls differ")
                    check("row_mean", got, want, dt, case, scale=scale)
                    cases += 1
    return cases


# --- phase 6b: gossip and compression kernels vs plain ------------------------------

def gossip_kernels_vs_plain(km, core, comm) -> dict:
    """consensus_step, consensus_gather and topk_scatter against their plain
    versions on the card, at the shapes the consensus path hands them and
    at odd sizes (tolerances: GOSSIP_* above)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rnd = lambda shape, dt: torch.randn(shape, generator=gen,
                                        device="cuda").to(dt)
    worst = {k: {} for k in GOSSIP_KERNELS}
    counts = {k: 0 for k in GOSSIP_KERNELS}
    bitwise = {k: 0 for k in GOSSIP_KERNELS}

    def note(name, got, want, err):
        key = str(got.dtype).replace("torch.", "")
        worst[name][key] = max(worst[name].get(key, 0.0), err)
        counts[name] += 1
        bitwise[name] += int(torch.equal(got, want))

    def all_l(m):
        """The list idx[i] = 0..m-1: a gather over it with w = P is the
        dense product, term for term in ascending l."""
        return torch.arange(m, dtype=torch.int32, device="cuda").repeat(m, 1)

    # consensus_step: the mixing matrices of the consensus path (P^E with
    # the variation mask folded in) and odd sizes
    step_cases = [((7, 9347), ALL_DTYPES[:1], ("random_regularish", 7, 3, 4, 0)),
                  ((64, 9347), ALL_DTYPES, ("knn_ring", 64, 4)),
                  ((1024, 9347), ALL_DTYPES[:1], ("knn_ring", 1024, 8)),
                  ((5, 4097), ALL_DTYPES, ("ring", 5)),
                  ((1, 1), ALL_DTYPES, None)]
    for (m, n), dtypes, spec in step_cases:
        if spec is None:
            p = torch.rand(1, 1, generator=gen, device="cuda")
        else:
            topo = _topology(core, spec)
            strat = core.make_strategy("consensus", tau=10, topo=topo,
                                       eps=0.5 / topo.max_degree, rounds=2,
                                       taus=core.uniform_taus(1, 10, m),
                                       sparse=False)
            p = torch.tensor(strat.p_e_masked[3], device="cuda")
        for dt in dtypes:
            g = rnd((m, n), dt)
            got = km.cs.consensus_step_cuda(g, p)
            want = km.cs.consensus_step_plain(g, p)
            err = (got.float() - want.float()).abs()
            tol = m * 2.0 ** -23 * (p.abs() @ g.float().abs()) + \
                torch.finfo(dt).eps * want.float().abs()
            case = f"consensus_step ({m}, {n}) {dt}"
            if got.dtype != dt or bool((err > tol).any()) or \
                    not bool(torch.isfinite(got.float()).all()):
                raise AssertionError(f"{case}: max err {err.max().item():.3e}")
            full = km.cg.consensus_gather_cuda(g, all_l(m), p.contiguous())
            if not torch.equal(full, got):
                raise AssertionError(f"{case}: not bitwise equal to the "
                                     f"full-list gather")
            note("consensus_step", got, want, err.max().item())
    # the tile edges, dense random P: bitwise against the gather over 0..m-1
    for m in STEP_EDGE_M:
        p = torch.rand(m, m, generator=gen, device="cuda") / m
        idx = all_l(m)
        for n in STEP_EDGE_N:
            for dt in ALL_DTYPES:
                g = rnd((m, n), dt)
                got = km.cs.consensus_step_cuda(g, p)
                want = km.cs.consensus_step_plain(g, p)
                err = (got.float() - want.float()).abs()
                tol = m * 2.0 ** -23 * (p.abs() @ g.float().abs()) + \
                    torch.finfo(dt).eps * want.float().abs()
                case = f"consensus_step edge ({m}, {n}) {dt}"
                if got.dtype != dt or bool((err > tol).any()) or \
                        not bool(torch.isfinite(got.float()).all()):
                    raise AssertionError(f"{case}: max err "
                                         f"{err.max().item():.3e}")
                if not torch.equal(km.cg.consensus_gather_cuda(g, idx, p), got):
                    raise AssertionError(f"{case}: not bitwise equal to the "
                                         f"full-list gather")
                note("consensus_step", got, want, err.max().item())
    # a NaN / Inf in a row of G whose column of P is 0 comes out as NaN where
    # torch.matmul gives NaN: no tile of P is skipped for being zero
    for m in (7, 129):
        p = torch.rand(m, m, generator=gen, device="cuda")
        p[:, 2] = 0.0
        g = rnd((m, 300), torch.float32)
        g[2, 5], g[2, 100] = float("inf"), float("nan")
        got = km.cs.consensus_step_cuda(g, p)
        nan = torch.isnan(torch.matmul(p, g))
        if not torch.equal(torch.isnan(got), nan) or \
                not bool(nan[:, [5, 100]].all()):
            raise AssertionError(f"consensus_step ({m}, 300): NaN where "
                                 f"torch.matmul has none, or none where it "
                                 f"has")
        counts["consensus_step"] += 1
    # ... and the full neighbour list of a sparse topology with P's entries
    topo = core.knn_ring(64, 4)
    p64 = core.mixing_matrix(topo, 0.1)
    full = core.neighbor_list(topo, k_max=64)
    g = rnd((64, 9347), torch.float32)
    got = km.cs.consensus_step_cuda(g, torch.tensor(p64, dtype=torch.float32,
                                                    device="cuda"))
    gat = km.cg.consensus_gather_cuda(
        g, torch.tensor(full.idx, device="cuda"),
        torch.tensor(core.neighbor_weights_from_matrix(full, p64),
                     device="cuda"))
    if not torch.equal(got, gat):
        raise AssertionError("consensus_step vs neighbor_list(k_max=m) "
                             "gather: not bitwise equal")

    # consensus_gather: the neighbour lists of the sparse path, a padded one
    pad = core.neighbor_list(core.random_regularish(64, 3, 5, 0))
    pad = core.neighbor_list(core.random_regularish(64, 3, 5, 0),
                             k_max=pad.k_max + 3)
    gather_cases = [("knn_ring(64,4)", core.neighbor_list(core.knn_ring(64, 4)),
                     ALL_DTYPES),
                    ("knn_ring(1024,8)",
                     core.neighbor_list(core.knn_ring(1024, 8)), ALL_DTYPES),
                    ("knn_ring_neighbors(10000,8)",
                     core.knn_ring_neighbors(10000, 8), ALL_DTYPES[:1]),
                    ("padded rand3-5(64)", pad, ALL_DTYPES)]
    for label, nl, dtypes in gather_cases:
        idx = torch.tensor(nl.idx, device="cuda")
        w = torch.tensor(core.neighbor_weights(nl, 0.5 / nl.max_degree),
                         device="cuda")
        for dt in dtypes:
            g = rnd((nl.m, 9347), dt)
            got = km.cg.consensus_gather_cuda(g, idx, w)
            want = km.cg.consensus_gather_plain(g, idx, w)
            err = (got.float() - want.float()).abs().max().item()
            if not torch.equal(got, want):
                raise AssertionError(f"consensus_gather {label} {dt}: not "
                                     f"bitwise equal, max err {err:.3e}")
            note("consensus_gather", got, want, err)
        del g

    n_gather_edges = gather_edges(km, core)

    # topk_scatter: k = 584 (n // 16), with ties and an all-zero row
    for m in (7, 1024):
        for dt in (torch.float32, torch.bfloat16):
            for case in ("plain", "ties", "zero row"):
                x = rnd((m, 9347), torch.float32)
                if case == "ties":
                    x = torch.round(x * 4) / 4
                if case == "zero row":
                    x[m // 2] = 0.0
                x = x.to(dt)
                t = comm.topk_threshold(x.float(), 584)
                got_s, got_r = km.tks.topk_scatter_cuda(x, t)
                want_s, want_r = km.tks.topk_scatter_plain(x, t)
                x32 = x.float()
                sent = torch.where(x32.abs() >= t[:, None], x32, 0.0)
                tol = m * 2.0 ** -24 * sent.abs().sum(0) + \
                    torch.finfo(dt).eps * want_s.float().abs()
                err = (got_s.float() - want_s.float()).abs()
                lab = f"topk_scatter ({m}, 9347) {dt} {case}"
                if not torch.equal(got_r, want_r):
                    raise AssertionError(f"{lab}: residual not bitwise equal")
                if bool((err > tol).any()):
                    raise AssertionError(f"{lab}: sum max err "
                                         f"{err.max().item():.3e}")
                note("topk_scatter", got_s, want_s, err.max().item())
    torch.cuda.synchronize()
    log(f"phase gossip_kernel_vs_plain: {sum(counts.values())} checks ok "
        f"({counts}); bitwise equal to the plain version in {bitwise} "
        f"(consensus_gather and topk_scatter's residual must be, and are); "
        f"consensus_step bitwise equal to the full-list gather in every "
        f"check (tile edges m {STEP_EDGE_M} x n {STEP_EDGE_N} x 3 dtypes), "
        f"NaN where torch.matmul has NaN (2 checks); consensus_gather "
        f"bitwise at {n_gather_edges} edge cases (n {GATHER_EDGE_N} x "
        f"offsets {GATHER_EDGE_OFFSETS} x 3 dtypes x the lists of "
        f"gather_edge_lists); max |kernel - plain| "
        f"{worst}; tolerance consensus_step "
        f"m*2^-23*(|P|@|G|) + 1 ulp, topk_scatter sum m*2^-24*sum|sent| + "
        f"1 ulp")
    return {"checks": counts, "bitwise": bitwise, "max_abs_err": worst,
            "consensus_gather_edges": n_gather_edges}


def gather_edge_lists(core, cg, device="cuda") -> list:
    """(label, idx, w) of the lists consensus_gather is held at: the staged
    kernel's row groups (m = 1000 and 257, not multiples of its 16 rows;
    every ring wraps past agents 0 and m - 1), lists whose rows share almost
    no neighbour (random_regularish(256, 3, 5)), a padded list, m either
    side of the switch between the staged and the row kernel
    (cg.MIN_STAGED_ROWS), k_max either side of the other (cg.MAX_SLOTS:
    k-NN rings padded out to it, and full lists 0..k-1 with dense random
    weights), rows of MAX_SLOTS sources each (the staged kernel's one-stage
    ring), and a small ring (m = 12)."""
    def nl_case(label, nl, eps):
        return (label, torch.tensor(nl.idx, device=device),
                torch.tensor(core.neighbor_weights(nl, eps), device=device))

    gen = torch.Generator().manual_seed(SEED + 5)
    m_sw = cg.MIN_STAGED_ROWS
    pad = core.neighbor_list(core.random_regularish(300, 3, 5, 3))
    cases = [
        nl_case("knn_ring(1000,8)", core.neighbor_list(core.knn_ring(1000, 8)),
                0.05),
        nl_case("knn_ring(257,4)", core.neighbor_list(core.knn_ring(257, 4)),
                0.1),
        nl_case(f"knn_ring({m_sw - 1},4)",
                core.neighbor_list(core.knn_ring(m_sw - 1, 4)), 0.1),
        nl_case(f"knn_ring({m_sw},8)",
                core.neighbor_list(core.knn_ring(m_sw, 8)), 0.05),
        nl_case("knn_ring(12,8)", core.neighbor_list(core.knn_ring(12, 8)),
                0.05),
        nl_case("rand3-5(256)", core.neighbor_list(
            core.random_regularish(256, 3, 5, 1)), 0.08),
        nl_case(f"rand3-5(300) padded to {pad.k_max + 7}", core.neighbor_list(
            core.random_regularish(300, 3, 5, 3), k_max=pad.k_max + 7), 0.08),
    ]
    # every row with MAX_SLOTS sources of its own (a one-row group of 186
    # unique rows: the staged kernel's ring holds a single stage)
    k = cg.MAX_SLOTS
    wide = (torch.arange(m_sw)[:, None] + torch.arange(k)[None, :]) % m_sw
    cases.append((f"wide m={m_sw} k={k}", wide.to(torch.int32).to(device),
                  (torch.rand(m_sw, k, generator=gen) / k).to(device)))
    for k in (cg.MAX_SLOTS, cg.MAX_SLOTS + 1):
        cases.append(nl_case(f"knn_ring({m_sw},4) padded to {k}",
                             core.neighbor_list(core.knn_ring(m_sw, 4),
                                                k_max=k), 0.1))
        idx = torch.arange(k, dtype=torch.int32).repeat(k, 1)
        cases.append((f"full list m={k}", idx.to(device),
                      (torch.rand(k, k, generator=gen) / k).to(device)))
    return cases


def gather_edges(km, core) -> int:
    """consensus_gather bitwise against its plain version on every list of
    gather_edge_lists, n in GATHER_EDGE_N, g at GATHER_EDGE_OFFSETS and the
    output at another offset, fp32 / bf16 / fp16; both kernels are run (the
    plan picks the row kernel below cg.MIN_STAGED_ROWS rows and past
    cg.MAX_SLOTS). Returns the number of cases."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases, kinds = 0, set()
    for label, idx, w in gather_edge_lists(core, km.cg):
        m, k = idx.shape
        for n in GATHER_EDGE_N:
            for dt in ALL_DTYPES:
                kinds.add(km.cg.gather_plan(m, n, k, dt.itemsize, sms).kernel)
                g0 = torch.randn(m, n, generator=gen, device="cuda").to(dt)
                want = km.cg.consensus_gather_plain(g0, idx, w)
                for off in GATHER_EDGE_OFFSETS:
                    g = at_offset(g0, off)
                    out = at_offset(torch.full_like(g0, float("nan")),
                                    (off + 3) % 8)
                    got = km.cg.consensus_gather_cuda(g, idx, w, out=out)
                    if got.data_ptr() != out.data_ptr() or \
                            not torch.equal(got, want):
                        err = (got.float() - want.float()).abs().max().item()
                        raise AssertionError(
                            f"consensus_gather edge {label} n={n} {dt} "
                            f"offset={off}: not bitwise equal to the plain "
                            f"version (max err {err:.3e}) or not written "
                            f"where asked")
                    cases += 1
    torch.cuda.synchronize()
    if kinds != {"staged", "rows"}:
        raise AssertionError(f"gather edges ran only the {kinds} kernel")
    return cases


# --- phases 7 and 7b: training -----------------------------------------------------

def _topology(core, spec):
    """A topology from its plan spec ``(family, *args)``."""
    return getattr(core, spec[0])(*spec[1:])


def _train_cfg(rl, core, optim, comm, kind, opt, m, B=0, tau=None, topo=None,
               eps=None, rounds=1, sparse=None, fused=True, payload=None,
               lam=0.95, **kw):
    """One training configuration. ``payload`` names a payload transform
    ``(factory, *args)``; a consensus run takes ``topo`` (a plan spec) and
    ``eps`` (a number, or ``"0.9/D"`` for 0.9 / Delta)."""
    tr = None if payload is None else getattr(comm, payload[0])(*payload[1:])
    tau = tau or (15 if kind == "decay" else 10)
    if kind == "periodic":
        strat = core.make_strategy("periodic", tau=tau, m=m, comm=tr)
    elif kind == "decay":
        strat = core.make_strategy("decay", tau=tau,
                                   taus=core.uniform_taus(1, tau, m),
                                   decay=core.exponential_decay(lam), comm=tr)
    else:
        graph = _topology(core, topo)
        if eps == "0.9/D":
            eps = 0.9 / graph.max_degree
        strat = core.make_strategy("consensus", tau=tau, topo=graph,
                                   eps=eps, rounds=rounds, sparse=sparse,
                                   fused=fused, comm=tr)
    optimizer = {"sgd": None, "momentum": optim.flat_momentum(0.9),
                 "adam": optim.flat_adam()}[opt]
    return rl.FedRLConfig(env=rl.FIGURE_EIGHT, strategy=strat, eta=TRAIN_ETA,
                          n_epochs=kw.pop("n_epochs", TRAIN_EPOCHS),
                          epoch_len=kw.pop("epoch_len", TRAIN_T),
                          minibatch=TRAIN_P, optimizer=optimizer, num_envs=B,
                          **kw)


def _expected_launches(cfg) -> dict:
    """Launches the loop implies. Per local update: one local-step launch
    (decay_accum for SGD, else the optimizer's); a dense fused gossip adds
    one consensus_step (E without fusion), a sparse gossip a scale_rows
    (decay_accum) and E consensus_gather, a compressed gossip a scale_rows
    and one consensus_step (dense, P^E) or E consensus_gather (sparse). Per
    sync: one row_mean for the parameters (one topk_scatter for a top-k
    uplink) and one per moment matrix. One row_mean per epoch's server view
    and one for the final server row."""
    strat, opt = cfg.strategy, cfg.optimizer
    n_updates = cfg.n_epochs * cfg.updates_per_epoch
    syncs = n_updates // strat.tau
    out = {k: 0 for k in TRAIN_KERNELS}
    out["decay_accum" if opt is None else f"{opt.kind}_update"] += n_updates
    out["row_mean"] += syncs * (0 if opt is None else opt.n_moments)
    out["row_mean"] += cfg.n_epochs + 1
    out["topk_scatter" if strat.comm.kind == "topk" else "row_mean"] += syncs
    if hasattr(strat, "rounds"):                     # consensus
        e = strat.rounds
        if strat.sparse:
            out["decay_accum"] += n_updates
            out["consensus_gather"] += e * n_updates
        elif strat.comm.enabled:
            out["decay_accum"] += n_updates
            out["consensus_step"] += n_updates
        else:
            out["consensus_step"] += (1 if strat.fused else e) * n_updates
    return out


def _kernel_counts(km) -> dict:
    return dict(km.fu.launches, decay_accum=km.dacc.launches,
                consensus_step=km.cs.launches,
                consensus_gather=km.cg.launches,
                topk_scatter=km.tks.launches)


def _reset_counts(km) -> None:
    km.dacc.launches = km.cs.launches = km.cg.launches = 0
    km.tks.launches = 0
    for k in km.fu.launches:
        km.fu.launches[k] = 0


def _max_rel(a, b) -> float:
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _compare_runs(label, cfg, card_run, cpu_run) -> dict:
    (gp, gm), (cp, cm) = card_run, cpu_run
    bf16 = cfg.buffer_dtype is not None
    rtol = TRAIN_BF16_RTOL if bf16 else TRAIN_RTOL
    worst_rel = 0.0
    for k in cm:
        if not (np.all(np.isfinite(gm[k])) and gm[k].shape == (cfg.n_epochs,)):
            raise AssertionError(f"{label}: bad metric {k} {gm[k]}")
        worst_rel = max(worst_rel, _max_rel(gm[k], cm[k]))
        if not np.allclose(gm[k], cm[k], rtol=rtol, atol=0):
            raise AssertionError(f"{label}: card {k} {gm[k]} vs CPU {cm[k]} "
                                 f"(rtol {rtol})")
    worst_abs = 0.0
    for h in ("pi", "vf"):
        for k in cp[h]:
            a = gp[h][k].detach().cpu().numpy()
            b = cp[h][k].detach().numpy()
            tol = TRAIN_ATOL + (2.0 ** -7 * np.abs(b) if bf16 else 0.0)
            worst_abs = max(worst_abs, float(np.max(np.abs(a - b))))
            if np.any(np.abs(a - b) > tol):
                raise AssertionError(f"{label}: server {h}/{k} card vs CPU "
                                     f"max err {np.max(np.abs(a - b)):.3e}")
    return {"metrics_max_rel": worst_rel, "params_max_abs": worst_abs}


def run_plan(phase, plan, km, _build, rl, core, optim, comm, card) -> dict:
    """Drive one slice's training path: every configuration of ``plan``
    ``(label, compare, kwargs of _train_cfg)`` as a seeded, timed run that
    draws on the card (updates/sec), and, where ``compare``, again on draws
    made on the host, on the card and on the CPU, which must agree. The
    kernel counts are set to 0 just before the path and read just after;
    every run's launches must equal the count the loop implies, with no
    build on the hot path."""
    builds_before = _build.n_builds
    total = {k: 0 for k in TRAIN_KERNELS}
    by_m = {}
    runs = []

    def card_run(label, cfg, draws):
        before = _kernel_counts(km)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, metrics, ledger = rl.run_fedrl(cfg, draws, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = _kernel_counts(km)
        got = {k: after[k] - before[k] for k in TRAIN_KERNELS}
        want = _expected_launches(cfg)
        if got != want:
            raise AssertionError(f"{label}: launches {got}, the loop implies "
                                 f"{want}")
        for k in metrics:
            if not np.all(np.isfinite(metrics[k])):
                raise AssertionError(f"{label}: non-finite {k}: {metrics[k]}")
        for k in TRAIN_KERNELS:
            total[k] += got[k]
            by_m.setdefault(str(cfg.strategy.m),
                            {kk: 0 for kk in TRAIN_KERNELS})[k] += got[k]
        return params, metrics, ledger, wall, got

    _reset_counts(km)                      # the path starts here
    last_params = None
    for label, compare, kw in plan:
        kw = dict(kw)
        cfg = _train_cfg(rl, core, optim, comm, **kw)
        params, metrics, ledger, wall, got = card_run(label, cfg, SEED)
        n_updates = cfg.n_epochs * cfg.updates_per_epoch
        rec = {"label": label, "m": cfg.strategy.m, "B": cfg.B,
               "strategy": cfg.strategy.name, "comm": cfg.strategy.comm.label,
               "optimizer": kw["opt"], "buffer_dtype": cfg.buffer_dtype,
               "updates": n_updates, "seconds": wall,
               "updates_per_sec": n_updates / wall, "launches": got,
               "metrics": {k: v.tolist() for k, v in metrics.items()},
               "ledger": ledger.table_row()}
        if compare:
            draws = rl.replay_of(cfg, rl.TorchDraws(SEED, "cpu"))
            rp, rmet, _, _, rgot = card_run(f"{label} replayed", cfg, draws)
            cpu = rl.run_fedrl(cfg, draws, device="cpu")
            rec["vs_cpu"] = _compare_runs(label, cfg, (rp, rmet), cpu[:2])
            rec["replayed_launches"] = rgot
        runs.append(rec)
        last_params = params
        log(f"training {label}: {n_updates} updates in {wall!r} s = "
            f"{n_updates / wall!r} updates/s (seeded draws on the card, incl. "
            f"per-epoch eval); nas {metrics['nas'].tolist()} grad_sq "
            f"{metrics['server_grad_sq_norm'].tolist()}; launches "
            f"{ {k: v for k, v in got.items() if v} }"
            + (f"; replayed draws card vs CPU {rec['vs_cpu']}" if compare
               else "")
            + f" card=\"{card}\"")
    launches = _kernel_counts(km)          # read right after the path
    if launches != total:
        raise AssertionError(f"{phase} launches {launches} != {total}")
    if _build.n_builds != builds_before:
        raise AssertionError(f"a build on the {phase} hot path")
    per_m = {}
    for r in runs:
        per_m.setdefault(r["label"].split(" ")[0] + (
            f" B={r['B']}" if r["m"] == 64 and r["B"] > 1 else "")
            + (" bf16" if r["buffer_dtype"] else ""), []).append(
                r["updates_per_sec"])
    n_cmp = sum("vs_cpu" in r for r in runs)
    med = {k: statistics.median(v) for k, v in per_m.items()}
    log(f"{phase}: {len(runs) + n_cmp} card runs ({len(runs)} seeded and "
        f"timed, {n_cmp} on replayed draws held against the CPU), launches "
        f"{launches} as the loop implies, no build; updates/s by m (median "
        f"over the path's runs at that m): {med} card=\"{card}\"")
    return {"runs": runs, "launches": launches, "launches_by_m": by_m,
            "updates_per_sec_median": med, "last_params": last_params}


def training_plan() -> list:
    """Slice 2's path: periodic and decay with SGD, momentum and Adam, at
    m = 7 on the shared env and on fleets, and one bf16 run."""
    plan = []
    for kind in ("periodic", "decay"):
        for opt in ("sgd", "momentum", "adam"):
            base = dict(kind=kind, opt=opt)
            if kind == "periodic":      # tau = 10: 2 epochs hold a sync
                base["n_epochs"] = CUT_EPOCHS
            plan.append((f"m=7 shared env {kind} {opt}", True,
                         dict(base, m=7)))
            plan.append((f"m=64 B=1 {kind} {opt}", True,
                         dict(base, m=64, B=1)))
            plan.append((f"m=64 B=4 ppo2x2 {kind} {opt}", True,
                         dict(base, m=64, B=4, ppo_epochs=2, n_minibatches=2)))
            for m in TRAIN_FLEETS[1:]:
                plan.append((f"m={m} B=1 {kind} {opt}", False,
                             dict(base, m=m, B=1)))
    plan.append(("m=64 B=1 decay adam bf16", True,
                 dict(kind="decay", opt="adam", m=64, B=1,
                      buffer_dtype="bfloat16")))
    return plan


def consensus_plan() -> list:
    """Slice 3's path: consensus at m = 7 on the Fig. 6 topologies
    (``benchmarks/fmarl_bench.py:29-36``), E in {1, 2}, with SGD, momentum
    and Adam; sparse by auto-selection and dense forced on k-NN rings at
    m = 64 and 1024; compressed uplinks (top-k 584 = n // 16, int8 on decay
    tau = 15 as ``benchmarks/compression_bench.py:59-69``) and top-k
    gossip."""
    plan = []
    for topo in (("random_regularish", 7, 3, 4, 0),
                 ("random_regularish", 7, 5, 6, 0)):
        for rounds in (1, 2):
            for opt in ("sgd", "momentum", "adam"):
                plan.append((
                    f"m=7 consensus rand{topo[2]}-{topo[3]} E={rounds} {opt}",
                    True, dict(kind="consensus", opt=opt, m=7, topo=topo,
                               eps="0.9/D", rounds=rounds)))
    for m, k in ((64, 4), (1024, 8)):
        for opt in ("sgd", "momentum", "adam"):
            plan.append((f"m={m} B=1 consensus knn{k} sparse(auto) E=2 {opt}",
                         m == 64, dict(kind="consensus", opt=opt, m=m, B=1,
                                       topo=("knn_ring", m, k), eps=0.5 / 8,
                                       rounds=2)))
        plan.append((f"m={m} B=1 consensus knn{k} dense(forced) adam",
                     m == 64, dict(kind="consensus", opt="adam", m=m, B=1,
                                   topo=("knn_ring", m, k), eps=0.5 / 8,
                                   sparse=False)))
    for _, _, kw in plan:               # tau = 10: 2 epochs hold a sync
        kw["n_epochs"] = CUT_EPOCHS
    plan += [
        ("m=7 periodic topk584 momentum", True,
         dict(kind="periodic", opt="momentum", m=7, payload=("topk", 584),
              n_epochs=CUT_EPOCHS)),
        ("m=7 decay(tau=15) int8 adam", True,
         dict(kind="decay", opt="adam", m=7, lam=0.98, payload=("qint8",))),
        ("m=7 consensus topk584-gossip sgd", True,
         dict(kind="consensus", opt="sgd", m=7,
              topo=("random_regularish", 7, 3, 4, 0), eps="0.9/D",
              payload=("topk", 584), n_epochs=CUT_EPOCHS)),
        ("m=64 B=1 consensus knn4 sparse topk584-gossip E=2 adam", True,
         dict(kind="consensus", opt="adam", m=64, B=1,
              topo=("knn_ring", 64, 4), eps=0.5 / 8, rounds=2,
              payload=("topk", 584), n_epochs=CUT_EPOCHS)),
    ]
    return plan


def training_path(km, _build, rl, core, optim, comm, serve, card) -> dict:
    """Slice 2's path (``training_plan``), then the trained server
    parameters served through slice 1's engine."""
    # warm the card's libraries (cuBLAS, the generator) outside the counts
    rl.run_fedrl(_train_cfg(rl, core, optim, comm, "periodic", "sgd", 7,
                            n_epochs=1, epoch_len=50), SEED, device="cuda")
    torch.cuda.synchronize()
    out = run_plan("training", training_plan(), km, _build, rl, core, optim,
                   comm, card)

    ckpt = os.path.join(ROOT, "build", "chip_smoke", "trained_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    serve.save_for_serving(ckpt, TRAIN_EPOCHS, out.pop("last_params"))
    eng = serve.ServeEngine.from_checkpoint(ckpt, mode="mean", seed=SEED,
                                            device="cuda")
    ref = serve.ServeEngine.from_checkpoint(ckpt, mode="mean", seed=SEED,
                                            device="cpu")
    obs = np.random.default_rng(SEED).standard_normal((64, OBS_DIM)).astype(
        np.float32)
    act = eng.decide(obs)
    err = float(np.max(np.abs(act - ref.decide(obs))))
    if act.shape != (64, ACT_DIM) or not np.all(np.isfinite(act)) or \
            err > SERVE_ATOL:
        raise AssertionError(f"trained policy serving: {act.shape}, err {err}")
    log(f"training: trained policy served on the card (max err vs CPU "
        f"{err!r}) card=\"{card}\"")
    out["serve_max_abs_err"] = err
    return out


def consensus_path(km, _build, rl, core, optim, comm, card) -> dict:
    """Slice 3's path (``consensus_plan``): consensus gossip (dense fused,
    dense forced, sparse by auto-selection) and compressed payloads."""
    out = run_plan("consensus training", consensus_plan(), km, _build, rl,
                   core, optim, comm, card)
    out.pop("last_params")
    return out


# --- phase 8: flat kernel times and a profiled training window --------------------

FLUSH_OP = "aten::amax"


def l2_flusher():
    """A call that evicts the card's 50 MB L2 cache: ``amax`` over a 128 MB
    buffer (``FLUSH_OP``, an op none of the timed functions calls). It only
    reads, so no dirty line of its own is left to be written back during the
    timed call that follows."""
    buf = torch.zeros(32 * 2 ** 20, device="cuda")
    return lambda: torch.amax(buf)


def cupti_ms(fn, flush, kernel, n: int = CUPTI_CALLS,
             windows: int = CUPTI_WINDOWS) -> float:
    """Device time per call by CUPTI over ``n`` calls in one
    ``torch.profiler`` window. ``flush`` (or None) runs before each call to
    evict the L2. ``kernel`` is a part of the name of the one kernel that
    each call launches: the time is the mean of its records, so records the
    tracer dropped (it drops some in many windows: 45 of 50 at (1024, 9347))
    do not make it read low. ``kernel`` is None only for a plain or library
    yardstick, whose kernels vary: its time is the window's device records
    less the device time of the ``n`` flushes (the kernels launched under
    ``FLUSH_OP``), over ``n``.

    A lost window (no device records, not ``n`` flushes, fewer than half
    its calls' records of ``kernel``) is not a measurement: it is taken
    again, up to ``windows`` windows in all, and the loss is logged. A
    window taken again has twice the calls of the one before, up to 4 n:
    after a large profiled window earlier in the process (phases 5, 8, 11)
    the tracer drops a roughly fixed number of a window's records (28 of 50
    in every window of one run's L2-warm swa_attention timing), which a
    longer window outgrows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for window in range(1, windows + 1):
        calls = n * min(4, 2 ** (window - 1))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        if kernel is not None:
            recs = [e for e in ev if e.device_type == DeviceType.CUDA
                    and kernel in e.key]
            got = sum(e.count for e in recs)
            if 2 * got >= calls:
                if got != calls:
                    log(f"cupti: {got} of {calls} records of {kernel}, timed "
                        f"by their mean")
                return sum(e.self_device_time_total for e in recs) / got / 1e3
            lost = f"{got} records of {kernel}, expected {calls}"
        else:
            busy = sum(e.self_device_time_total for e in ev
                       if e.device_type == DeviceType.CUDA)
            ops = [e for e in ev
                   if e.key == FLUSH_OP and e.device_type == DeviceType.CPU]
            flush_us = sum(e.device_time_total for e in ops)
            if flush is None and busy > 0:
                return busy / calls / 1e3
            if flush is not None and sum(e.count for e in ops) == calls and \
                    0 < flush_us < busy:
                return (busy - flush_us) / calls / 1e3
            lost = (f"{busy} us of device time, {len(ops)} {FLUSH_OP} "
                    f"records of {flush_us} us")
        log(f"cupti window {window} of {windows} lost: {lost}")
    raise AssertionError(f"every CUPTI window was lost: {lost}")


class SmClock:
    """The card's SM clock (MHz) while a timing window runs: ``nvidia-smi``
    samples it every 20 ms from just before the window to its end (the
    first sample is taken before the window starts; a window shorter than
    20 ms may have no other). ``summary()`` gives min, median, max."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits", "-i", "0", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.first = self.proc.stdout.readline()
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        rest = self.proc.communicate(timeout=60)[0]
        nums = lambda text: [int(float(v)) for v in text.split()
                             if v.replace(".", "", 1).isdigit()]
        self.mhz = nums(rest) or nums(self.first)
        return False

    def summary(self) -> list:
        if not self.mhz:
            return [None, None, None]
        return [min(self.mhz), int(statistics.median(self.mhz)), max(self.mhz)]


def flat_bound(name, m, n) -> tuple:
    elems = m * n
    nbytes, flops = {
        "decay_accum": (12 * elems + 4 * m, 2 * elems),
        "row_mean": (4 * elems + 4 * n, elems + n),
        "momentum_update": (20 * elems + 4 * m, 5 * elems),
        "adam_update": (28 * elems + 4 * m, 17 * elems),
    }[name]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def flat_times(dacc, fu, dispatch, training, card) -> dict:
    """Kernel, plain and library device times with the L2 flushed before
    every call (the training loop reads each (m, n) buffer once per step,
    after other work has passed through the cache): all four kernels at
    TIMED_SHAPES, row_mean alone at ROW_MEAN_TIMED too."""
    cyc = sleep_cycles_per_ms()
    flush = l2_flusher()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = {}
    bc1, bc2 = dispatch.adam_bias_corrections(3, 0.9, 0.95)
    for m, n in TIMED_SHAPES + ROW_MEAN_TIMED:
        rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
        g, row = rnd(m, n), torch.empty(n, device="cuda")
        if (m, n) in ROW_MEAN_TIMED:
            rows[f"row_mean/{m}x{n}"] = row_mean_times(
                fu, g, row, cyc, flush, training, card)
            continue
        p, mu = rnd(m, n), 0.1 * rnd(m, n)
        nu = (0.1 * rnd(m, n)).abs()
        w = torch.rand(m, generator=gen, device="cuda")
        d = -TRAIN_ETA * w
        po, mo, vo = torch.empty_like(p), torch.empty_like(mu), torch.empty_like(nu)
        akw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0)
        fns = {
            "decay_accum": (
                lambda: dacc.decay_accum_cuda(p, g, d, out=po),
                lambda: dacc.decay_accum_plain(p, g, d, out=po),
                lambda: torch.addcmul(p, d[:, None], g, out=po)),
            "row_mean": (
                lambda: fu.row_mean_cuda(g, out=row),
                lambda: fu.row_mean_plain(g, out=row),
                lambda: torch.mean(g, dim=0, out=row)),
            "momentum_update": (
                lambda: fu.momentum_update_cuda(p, g, mu, w, TRAIN_ETA, 0.9,
                                                p_out=po, mu_out=mo),
                lambda: fu.momentum_update_plain(p, g, mu, w, TRAIN_ETA, 0.9,
                                                 p_out=po, mu_out=mo),
                None),
            "adam_update": (
                lambda: fu.adam_update_cuda(p, g, mu, nu, w, TRAIN_ETA, bc1,
                                            bc2, p_out=po, mu_out=mo,
                                            nu_out=vo, **akw),
                lambda: fu.adam_update_plain(p, g, mu, nu, w, TRAIN_ETA, bc1,
                                             bc2, p_out=po, mu_out=mo,
                                             nu_out=vo, **akw),
                None),
        }
        on_path = training["launches_by_m"].get(str(m), {})
        for name, (kern, plain, lib) in fns.items():
            b_ms, b_by, nbytes, flops = flat_bound(name, m, n)
            rec = {"shape": [m, n], "dtype": "float32", "bound_ms": b_ms,
                   "bound_by": b_by, "bytes": nbytes, "flops": flops,
                   "launches_on_path": on_path.get(name, 0)}
            rec.update(kernel_times(name, kern, plain, lib, cyc, flush))
            rows[f"{name}/{m}x{n}"] = rec
            log(f"time {name} shape=({m}, {n}) fp32 L2 flushed: "
                f"{times_text(rec)} bound_ms={b_ms!r} ({b_by}) "
                f"launches_on_path(m={m})={rec['launches_on_path']} "
                f"card=\"{card}\"")
    return rows


def row_mean_times(fu, g, row, cyc, flush, training, card) -> dict:
    """row_mean's times on g (m, n) fp32, as ``flat_times`` gives them."""
    m, n = g.shape
    b_ms, b_by, nbytes, flops = flat_bound("row_mean", m, n)
    rec = {"shape": [m, n], "dtype": "float32", "bound_ms": b_ms,
           "bound_by": b_by, "bytes": nbytes, "flops": flops,
           "launches_on_path": training["launches_by_m"].get(str(m), {})
           .get("row_mean", 0)}
    rec.update(kernel_times("row_mean", lambda: fu.row_mean_cuda(g, out=row),
                            lambda: fu.row_mean_plain(g, out=row),
                            lambda: torch.mean(g, dim=0, out=row), cyc,
                            flush))
    log(f"time row_mean shape=({m}, {n}) fp32 L2 flushed: {times_text(rec)} "
        f"bound_ms={b_ms!r} ({b_by}) launches_on_path(m={m})="
        f"{rec['launches_on_path']} card=\"{card}\"")
    return rec


def kernel_times(name, kern, plain, lib, cyc, flush) -> dict:
    """The kernel's, the plain version's and the library call's device
    times, L2 flushed before every call: by CUDA events (``device_ms``:
    plain, kernel, kernel, plain; library twice) and by CUPTI
    (``cupti_ms``), and the kernel's by CUPTI with a warm L2; the SM clock
    sampled over the whole window."""
    timed = lambda f: device_ms(f, cyc, flush)[0]
    with SmClock() as clock:
        p1, k1, k2, p2 = timed(plain), timed(kern), timed(kern), timed(plain)
        lib_ms = (timed(lib) + timed(lib)) / 2 if lib is not None else None
        rec = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
               "library_ms": lib_ms,
               "cupti_ms": cupti_ms(kern, flush, f"{name}_kernel"),
               "plain_cupti_ms": cupti_ms(plain, flush, None),
               "library_cupti_ms": (cupti_ms(lib, flush, None) if lib
                                    else None),
               "warm_l2_cupti_ms": cupti_ms(kern, None, f"{name}_kernel")}
    rec["sm_clock_mhz"] = clock.summary()
    return rec


def times_text(rec) -> str:
    return (f"kernel_ms={rec['ms']!r} (cupti {rec['cupti_ms']!r}; L2-warm "
            f"cupti {rec['warm_l2_cupti_ms']!r}) plain_ms={rec['plain_ms']!r}"
            f" (cupti {rec['plain_cupti_ms']!r}) library_ms="
            f"{rec['library_ms']!r} (cupti {rec['library_cupti_ms']!r}) "
            f"sm_clock_mhz(min, median, max)={rec['sm_clock_mhz']}")


def gossip_bound(name, m, n, k=None) -> tuple:
    """Least time for the work of one call (fp32): bytes over the HBM rate
    (each input read once, each output written once) against FLOP over the
    fp32 rate."""
    elems = m * n
    nbytes, flops = {
        "consensus_step": (4 * m * m + 8 * elems, 2 * m * m * n),
        "consensus_gather": (8 * elems + 8 * m * (k or 0), 2 * (k or 0) * elems),
        "topk_scatter": (8 * elems + 4 * n + 4 * m, 3 * elems),
    }[name]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def gossip_csr(nl, w: torch.Tensor) -> torch.Tensor:
    """The sparse ``(m, m)`` gossip matrix of neighbour list ``nl`` and its
    weights ``w`` in CSR form, built once from each row's valid prefix (the
    padding slots, weight 0 on the agent's own column, are left out):
    ``torch.sparse.mm`` of it with ``g`` is the gather's library yardstick."""
    valid = torch.tensor(nl.valid, device=w.device)
    idx = torch.tensor(nl.idx, device=w.device, dtype=torch.int64)
    crow = torch.zeros(nl.idx.shape[0] + 1, dtype=torch.int64, device=w.device)
    crow[1:] = valid.sum(1).cumsum(0)
    m = nl.idx.shape[0]
    return torch.sparse_csr_tensor(crow, idx[valid], w[valid], size=(m, m),
                                   check_invariants=True)


def gossip_times(km, core, comm, consensus, card) -> dict:
    """Kernel, plain and library device times of the three gossip and
    compression kernels at the consensus path's shapes (the L2 flushed
    before every call, and by CUPTI also warm)."""
    cyc = sleep_cycles_per_ms()
    flush = l2_flusher()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = {}
    cases = []
    for m, spec in ((1024, ("knn_ring", 1024, 8)), (64, ("knn_ring", 64, 4)),
                    (7, ("random_regularish", 7, 3, 4, 0))):
        topo = _topology(core, spec)
        strat = core.make_strategy("consensus", tau=10, topo=topo,
                                   eps=0.5 / topo.max_degree, sparse=False)
        p = torch.tensor(strat.p_e_masked[0], device="cuda")
        g = torch.randn(m, 9347, generator=gen, device="cuda")
        out = torch.empty_like(g)
        cases.append(("consensus_step", m, None,
                      lambda g=g, p=p, out=out: km.cs.consensus_step_cuda(
                          g, p, out=out),
                      lambda g=g, p=p, out=out: km.cs.consensus_step_plain(
                          g, p, out=out),
                      lambda g=g, p=p, out=out: torch.matmul(p, g, out=out)))
    for m, nl in gather_timed_lists(core):
        idx = torch.tensor(nl.idx, device="cuda")
        w = torch.tensor(core.neighbor_weights(nl, 0.5 / nl.max_degree),
                         device="cuda")
        g = torch.randn(m, 9347, generator=gen, device="cuda")
        out = torch.empty_like(g)
        w_csr = gossip_csr(nl, w)
        cases.append(("consensus_gather", m, nl.k_max,
                      lambda g=g, i=idx, w=w, o=out:
                          km.cg.consensus_gather_cuda(g, i, w, out=o),
                      lambda g=g, i=idx, w=w, o=out:
                          km.cg.consensus_gather_plain(g, i, w, out=o),
                      lambda g=g, a=w_csr: torch.sparse.mm(a, g)))
    for m in (1024, 7):
        x = torch.randn(m, 9347, generator=gen, device="cuda")
        t = comm.topk_threshold(x, 584)
        cases.append(("topk_scatter", m, None,
                      lambda x=x, t=t: km.tks.topk_scatter_cuda(x, t),
                      lambda x=x, t=t: km.tks.topk_scatter_plain(x, t),
                      None))
    for name, m, k, kern, plain, lib in cases:
        lib_err = None
        if lib is not None:
            want = kern().clone()   # kernel and library may share `out`
            got = lib()
            lib_err = float((got.float() - want.float()).abs().max())
            ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))
            log(f"library check {name} shape=({m}, 9347): max_abs_err="
                f"{lib_err!r} (rtol 1e-5, atol 1e-5) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name}: the library yardstick computes "
                                     f"another function (max_abs_err "
                                     f"{lib_err!r})")
        b_ms, b_by, nbytes, flops = gossip_bound(name, m, 9347, k)
        on_path = consensus["launches_by_m"].get(str(m), {}).get(name, 0)
        rec = {"shape": [m, 9347], "dtype": "float32", "k_max": k,
               "library_max_abs_err": lib_err, "bound_ms": b_ms,
               "bound_by": b_by, "bytes": nbytes, "flops": flops,
               "launches_on_path": on_path}
        if name == "consensus_gather":
            rec["plan"] = km.cg.gather_plan(
                m, 9347, k, 4, torch.cuda.get_device_properties(0)
                .multi_processor_count)._asdict()
        rec.update(kernel_times(name, kern, plain, lib, cyc, flush))
        rows[f"{name}/{m}x9347"] = rec
        log(f"time {name} shape=({m}, 9347) fp32 L2 flushed: "
            f"{times_text(rec)} bound_ms={b_ms!r} ({b_by}) "
            f"launches_on_path(m={m})={on_path}"
            f"{' plan=' + str(rec['plan']) if 'plan' in rec else ''} "
            f"card=\"{card}\"")
    return rows


def gather_timed_lists(core) -> tuple:
    """The consensus path's neighbour lists, (m, list): its two sparse
    fleets and the 10,000-agent ring."""
    return ((1024, core.neighbor_list(core.knn_ring(1024, 8))),
            (64, core.neighbor_list(core.knn_ring(64, 4))),
            (10000, core.knn_ring_neighbors(10000, 8)))


def gather_crossover() -> dict:
    """consensus_gather's two kernels against each other on k-NN rings at
    n = 9,347, fp32, m from 64 to 1,024 (L2 flushed, CUPTI, each kernel
    twice in turns): where the staged kernel starts to win sets
    ``MIN_STAGED_ROWS`` in ``repro_torch/kernels/consensus_gather.py``.
    Both kernels are called through the library's C entry point with
    explicit plans (these launches are not counted). Prints one line per
    m."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import core
    from repro_torch.kernels import _build
    from repro_torch.kernels import consensus_gather as cg
    from repro_torch.kernels.decay_accum import raise_on, stream_of
    lib = _build.load()
    flush, card = l2_flusher(), card_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    out = {}
    for m, k in ((64, 4), (128, 8), (256, 8), (512, 8), (1024, 8)):
        nl = core.neighbor_list(core.knn_ring(m, k))
        idx = torch.tensor(nl.idx, device="cuda")
        w = torch.tensor(core.neighbor_weights(nl, 0.5 / k), device="cuda")
        g = torch.randn(m, 9347, generator=gen, device="cuda")
        res = torch.empty_like(g)
        sp = cg.staged_plan(m, 9347, nl.k_max, 4, sms)
        plans = {"rows": (0, 0, 0),
                 "staged": (sp.rows, sp.blocks, sp.ring_bytes)}

        def call(p):
            raise_on("gather_crossover", lib, lib.repro_consensus_gather(
                g.data_ptr(), idx.data_ptr(), w.data_ptr(), res.data_ptr(),
                m, 9347, nl.k_max, 0, *p, 0, stream_of(g.device)))

        rec = {name: [] for name in plans}
        for name in ("rows", "staged", "staged", "rows"):
            rec[name].append(cupti_ms(lambda p=plans[name]: call(p), flush,
                                      "consensus_gather_kernel"))
        out[m] = rec
        log(f"time consensus_gather crossover m={m} k_max={nl.k_max} "
            f"(9347 columns, fp32, L2 flushed, cupti ms): row kernel "
            f"{rec['rows']}, staged kernel {rec['staged']} "
            f"(plan picks {cg.gather_plan(m, 9347, nl.k_max, 4, sms).kernel})"
            f" card=\"{card}\"")
    return out


def consensus_step_alone(m: int = 1024, n: int = 9347) -> dict:
    """Build the kernels of this checkout and time ``consensus_step`` alone
    at (m, n), fp32, as ``gossip_times`` does (its P, L2 flushed, CUDA
    events and CUPTI, the SM clock): run from a copy of the repository
    whose ``csrc/consensus_step.cu`` was edited, it prices the edit against
    the committed kernel on the same card. Prints one line."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import core
    from repro_torch.kernels import _build
    from repro_torch.kernels import consensus_step as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    topo = core.knn_ring(m, 8)
    strat = core.make_strategy("consensus", tau=10, topo=topo,
                               eps=0.5 / topo.max_degree, sparse=False)
    p = torch.tensor(strat.p_e_masked[0], device="cuda")
    g = torch.randn(m, n, generator=torch.Generator(device="cuda")
                    .manual_seed(SEED + 3), device="cuda")
    out = torch.empty_like(g)
    rec = kernel_times("consensus_step",
                       lambda: cs.consensus_step_cuda(g, p, out=out),
                       lambda: cs.consensus_step_plain(g, p, out=out),
                       lambda: torch.matmul(p, g, out=out),
                       sleep_cycles_per_ms(), l2_flusher())
    log(f"time consensus_step alone ({ROOT}) shape=({m}, {n}) fp32 L2 "
        f"flushed: {times_text(rec)} card=\"{card_line()}\"")
    return rec


def row_mean_wkv6_alone() -> dict:
    """Build the kernels of this checkout and time row_mean at (m, 9347)
    fp32 for the training path's fleets and wkv6 at phase 11's shapes: L2
    flushed by CUDA events and CUPTI (row_mean beside ``mean(0)``), and
    L2-warm by CUPTI, the SM clock sampled over each shape. Run from a copy
    of the repository at another commit with this file copied into it, it
    times that commit's kernels on the same card, in the same call as this
    checkout's. Prints one line per shape."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flat_update as fu
    from repro_torch.kernels import wkv6 as wk
    _build.load()
    cyc, flush, card = sleep_cycles_per_ms(), l2_flusher(), card_line()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    timed = lambda f: device_ms(f, cyc, flush)[0]
    out = {}
    for m, n in ((7, 9347), (64, 9347), (1024, 9347), (10000, 9347)):
        g = torch.randn(m, n, generator=gen, device="cuda")
        row = torch.empty(n, device="cuda")
        kern = lambda: fu.row_mean_cuda(g, out=row)
        lib = lambda: torch.mean(g, dim=0, out=row)
        with SmClock() as clock:
            rec = {"ms": (timed(kern) + timed(kern)) / 2,
                   "library_ms": (timed(lib) + timed(lib)) / 2,
                   "cupti_ms": cupti_ms(kern, flush, "row_mean_kernel"),
                   "library_cupti_ms": cupti_ms(lib, flush, None),
                   "warm_l2_cupti_ms": cupti_ms(kern, None, "row_mean_kernel")}
        rec["sm_clock_mhz"] = clock.summary()
        out[f"row_mean/{m}x{n}"] = rec
        log(f"time row_mean alone ({ROOT}) shape=({m}, {n}) fp32 L2 flushed: "
            f"kernel_ms={rec['ms']!r} (cupti {rec['cupti_ms']!r}; L2-warm "
            f"cupti {rec['warm_l2_cupti_ms']!r}) library_ms="
            f"{rec['library_ms']!r} (cupti {rec['library_cupti_ms']!r}) "
            f"sm_clock_mhz(min, median, max)={rec['sm_clock_mhz']} "
            f"card=\"{card}\"")
    for b, t in LM_PREFILL + (LM_ADMIT_TIMED, (LM_SLOTS, 1), (1, 1)):
        args = wkv6_inputs(b, t, 32, SEED + 7)
        st = args[5].clone()
        kern = lambda a=args, st=st: wk.wkv6_cuda(*a[:5], st, state_out=st)
        with SmClock() as clock:
            rec = {"ms": (timed(kern) + timed(kern)) / 2,
                   "cupti_ms": cupti_ms(kern, flush, "wkv6_kernel"),
                   "warm_l2_cupti_ms": cupti_ms(kern, None, "wkv6_kernel")}
        rec["sm_clock_mhz"] = clock.summary()
        out[f"wkv6/{b}x{t}"] = rec
        log(f"time wkv6 alone ({ROOT}) shape=({b}, {t}, 32, 64) fp32 L2 "
            f"flushed: kernel_ms={rec['ms']!r} (cupti {rec['cupti_ms']!r}; "
            f"L2-warm cupti {rec['warm_l2_cupti_ms']!r}) sm_clock_mhz(min, "
            f"median, max)={rec['sm_clock_mhz']} card=\"{card}\"")
    return out


def policy_infer_gather_alone() -> dict:
    """Build the kernels of this checkout and time policy_infer at the
    serving buckets in both modes and consensus_gather at the consensus
    path's lists (``gather_timed_lists``), as phases 5 and 8 do: L2 flushed
    by CUDA events and CUPTI, L2-warm by CUDA events (policy_infer) and
    CUPTI, the SM clock sampled over each shape. Run from a copy of the
    repository at another commit with this file copied into it, it times
    that commit's kernels on the same card, in the same call as this
    checkout's. Prints one line per shape."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import core
    from repro_torch.kernels import _build
    from repro_torch.kernels import consensus_gather as cg
    from repro_torch.kernels import policy_infer as pinf
    _build.load()
    cyc, flush, card = sleep_cycles_per_ms(), l2_flusher(), card_line()
    timed = lambda f, fl=flush: device_ms(f, cyc, fl)[0]
    out = {}
    for mode in ("mean", "sample"):
        for b in PI_BUCKETS:
            pi, nm, ns, obs, noise = make_inputs(
                OBS_DIM, HIDDEN, ACT_DIM, b, "jax_like", seed=b)
            res = torch.empty_like(noise)
            kern = lambda: pinf.policy_infer_cuda(
                obs, pi, nm, ns, noise, sample=mode == "sample", out=res)
            name = "policy_infer_kernel"
            with SmClock() as clock:
                rec = {"ms": (timed(kern) + timed(kern)) / 2,
                       "cupti_ms": cupti_ms(kern, flush, name),
                       "warm_ms": (timed(kern, None) + timed(kern, None)) / 2,
                       "warm_l2_cupti_ms": cupti_ms(kern, None, name)}
            rec["sm_clock_mhz"] = clock.summary()
            out[f"policy_infer/{mode}/{b}"] = rec
            log(f"time policy_infer alone ({ROOT}) mode={mode} bucket={b} L2 "
                f"flushed: kernel_ms={rec['ms']!r} (cupti {rec['cupti_ms']!r})"
                f"; L2-warm: {rec['warm_ms']!r} (cupti "
                f"{rec['warm_l2_cupti_ms']!r}) sm_clock_mhz(min, median, max)"
                f"={rec['sm_clock_mhz']} card=\"{card}\"")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for m, nl in gather_timed_lists(core):
        idx = torch.tensor(nl.idx, device="cuda")
        w = torch.tensor(core.neighbor_weights(nl, 0.5 / nl.max_degree),
                         device="cuda")
        g = torch.randn(m, 9347, generator=gen, device="cuda")
        res = torch.empty_like(g)
        kern = lambda: cg.consensus_gather_cuda(g, idx, w, out=res)
        name = "consensus_gather_kernel"
        with SmClock() as clock:
            rec = {"ms": (timed(kern) + timed(kern)) / 2,
                   "cupti_ms": cupti_ms(kern, flush, name),
                   "warm_l2_cupti_ms": cupti_ms(kern, None, name)}
        rec["sm_clock_mhz"] = clock.summary()
        out[f"consensus_gather/{m}x9347"] = rec
        log(f"time consensus_gather alone ({ROOT}) shape=({m}, 9347) k_max="
            f"{nl.k_max} fp32 L2 flushed: kernel_ms={rec['ms']!r} (cupti "
            f"{rec['cupti_ms']!r}; L2-warm cupti {rec['warm_l2_cupti_ms']!r})"
            f" sm_clock_mhz(min, median, max)={rec['sm_clock_mhz']} "
            f"card=\"{card}\"")
    return out


def profile_training(rl, core, optim, card) -> dict:
    """One ``torch.profiler`` window over a short training run at m = 1024
    (4 local updates, 2 syncs, one eval; Adam): wall time, device busy time
    and idle share, and the host and device time of each phase range of the
    driver (``fedrl.*``; the eval's own rollout and gradient nest in it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    strat = core.make_strategy("periodic", tau=2, m=PROFILE_M)
    cfg = rl.FedRLConfig(env=rl.FIGURE_EIGHT, strategy=strat, eta=TRAIN_ETA,
                         n_epochs=1, epoch_len=4 * TRAIN_P, minibatch=TRAIN_P,
                         optimizer=optim.flat_adam(), num_envs=1)
    rl.run_fedrl(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rl.run_fedrl(cfg, SEED, device="cuda")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = prof.key_averages()
    dev = {e.key: (e.count, e.self_device_time_total) for e in ev
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
           and not e.key.startswith("fedrl.")}
    busy_us = sum(t for _, t in dev.values())
    phases = {e.key: {"count": e.count, "host_ms": e.cpu_time_total / 1e3,
                      "device_ms": e.device_time_total / 1e3}
              for e in ev if e.key.startswith("fedrl.")
              and e.device_type == DeviceType.CPU}
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:12]
    out = {"m": PROFILE_M, "updates": 4, "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1.0 - busy_us / wall_us,
           "phases": phases,
           "top_device_ops": {k: {"count": c, "device_ms": t / 1e3}
                              for k, (c, t) in top}}
    log(f"profile training m={PROFILE_M} B=1 adam, 4 updates + 2 syncs + 1 "
        f"eval: wall_ms={out['wall_ms']!r} device_busy_ms="
        f"{out['device_busy_ms']!r} device_idle_share="
        f"{out['device_idle_share']!r}; phases (host ms / device ms): "
        + ", ".join(f"{k} x{v['count']} {v['host_ms']:.3f}/{v['device_ms']:.3f}"
                    for k, v in sorted(phases.items()))
        + f" card=\"{card}\"")
    return out


# --- phase 15: the sweep path (slice 10) -------------------------------------------

# The batched forms of the flat and gossip kernels: every (S, m, n) call is one
# launch, held bitwise against S unbatched launches on the runs' slices (and
# against the plain version: bitwise where phase 6 / 6b pin it, else their
# tolerances), at the sweep shapes of the figure grids (S = 12 runs of the
# paper's m = 7) and at the training path's fleets.
SWEEP_KERNEL_SHAPES = ((12, 7, 9347), (16, 64, 9347), (4, 1024, 9347))
SWEEP_TOPK = 584


def _bitwise(name, got, want, case):
    if got.dtype != want.dtype or got.shape != want.shape or \
            not torch.equal(got, want):
        err = (got.float() - want.float()).abs().max().item() \
            if got.shape == want.shape else float("nan")
        raise AssertionError(f"{name}: {case}: batched {got.dtype}"
                             f"{tuple(got.shape)} is not bitwise the loop's "
                             f"{want.dtype}{tuple(want.shape)} (max err "
                             f"{err:.3e})")


def _one_launch(km, name, fn):
    """Call ``fn`` and require exactly one launch of kernel ``name``."""
    before = _kernel_counts(km)[name]
    out = fn()
    got = _kernel_counts(km)[name] - before
    if got != 1:
        raise AssertionError(f"{name}: a batched call made {got} launches")
    return out


def _run_coefs(gen, S, m):
    """The coefficient forms of an (S, m, n) call, each with the run's own
    coefficient for the loop: a scalar, a shared (m,), a per-run (S,) and a
    per-row (S, m)."""
    shared = torch.rand(m, generator=gen, device="cuda")
    runs = torch.rand(S, generator=gen, device="cuda")
    rows = torch.rand(S, m, generator=gen, device="cuda")
    return [("scalar", 0.37, lambda s: 0.37),
            ("shared", shared, lambda s: shared),
            ("per_run", runs, lambda s: runs[s].reshape(())),
            ("per_row", rows, lambda s: rows[s])]


def sweep_kernels_vs_loop(km, core, comm, dispatch) -> dict:
    """Each batched kernel against S unbatched launches and its plain
    version, over the coefficient forms and dtypes the dispatch takes; the
    S == m refusals."""
    fu, dacc, tks = km.fu, km.dacc, km.tks
    gen = torch.Generator(device="cuda").manual_seed(SEED + 150)
    counts = {k: 0 for k in TRAIN_KERNELS}
    worst = {k: 0.0 for k in TRAIN_KERNELS}
    bc1, bc2 = dispatch.adam_bias_corrections(2, 0.9, 0.95)

    def vs_plain(name, got, want, case, tol=None):
        err = (got.float() - want.float()).abs()
        bad = (not torch.equal(got, want)) if tol is None else \
            bool((err > tol).any())
        if bad or not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"{name} batched vs plain: {case}: max err "
                                 f"{err.max().item():.3e}")
        worst[name] = max(worst[name], err.max().item())

    for S, m, n in SWEEP_KERNEL_SHAPES:
        for dt in ALL_DTYPES:
            case = f"(S, m, n)=({S}, {m}, {n}) {dt}"
            rnd = lambda *shape: torch.randn(shape, generator=gen,
                                             device="cuda").to(dt)
            p, g = rnd(S, m, n), rnd(S, m, n)
            # row_mean: one launch, the run in the grid
            got = _one_launch(km, "row_mean", lambda: dispatch.row_mean(g))
            loop = torch.stack([fu.row_mean_cuda(g[s]) for s in range(S)])
            _bitwise("row_mean", got, loop, case)
            plain = fu.row_mean_plain(g)
            vs_plain("row_mean", got, plain, case,
                     ROW_MEAN_REL * g.float().abs().mean(1)
                     + torch.finfo(dt).eps * plain.float().abs())
            counts["row_mean"] += 1
            # decay_accum and scale_rows: the runs folded into S * m rows
            for form, d, d_s in _run_coefs(gen, S, m):
                got = _one_launch(km, "decay_accum",
                                  lambda: dispatch.decay_accum(p, g, d))
                loop = torch.stack([dispatch.decay_accum(p[s], g[s], d_s(s))
                                    for s in range(S)])
                _bitwise("decay_accum", got, loop, f"{case} d {form}")
                d_rows = dispatch._per_row("decay_accum", "d", d, S, m,
                                           per_run_1d=True)
                vs_plain("decay_accum", got,
                         dacc.decay_accum_plain(p, g, d_rows), f"{case} {form}")
                counts["decay_accum"] += 1
            for form, w, w_s in _run_coefs(gen, S, m)[1:4:2]:
                got = _one_launch(km, "decay_accum",
                                  lambda: dispatch.scale_rows(g, w))
                loop = torch.stack([dispatch.scale_rows(g[s], w_s(s))
                                    for s in range(S)])
                _bitwise("scale_rows", got, loop, f"{case} w {form}")
            # momentum and Adam: a weight per row, a learning rate per run
            mu = (0.1 * torch.randn(S, m, n, generator=gen, device="cuda"))
            nu = mu.abs()
            lrs = 5e-3 * (1.0 + torch.rand(S, generator=gen, device="cuda"))
            for form, w, w_s in _run_coefs(gen, S, m):
                for lr, lr_s, lr_form in ((5e-3, lambda s: 5e-3, "shared"),
                                          (lrs, lambda s: float(lrs[s]),
                                           "per_run")):
                    st = {"mu": mu.clone()}
                    got_p, got_s = _one_launch(
                        km, "momentum_update", lambda: dispatch.flat_opt_update(
                            p, g, w, st, kind="momentum", lr=lr,
                            nesterov=True))
                    for s in range(S):
                        lp, ls = dispatch.flat_opt_update(
                            p[s], g[s], w_s(s), {"mu": mu[s].clone()},
                            kind="momentum", lr=lr_s(s), nesterov=True)
                        _bitwise("momentum_update", got_p[s], lp,
                                 f"{case} w {form} lr {lr_form} run {s}")
                        _bitwise("momentum_update", got_s["mu"][s], ls["mu"],
                                 f"{case} w {form} lr {lr_form} run {s} mu")
                    w_rows = dispatch._per_row("w", "w", w, S, m,
                                               per_run_1d=True)
                    pp, pm = fu.momentum_update_plain(p, g, mu, w_rows, lr,
                                                      0.9, nesterov=True)
                    vs_plain("momentum_update", got_p, pp, f"{case} {form}")
                    vs_plain("momentum_update", got_s["mu"], pm,
                             f"{case} {form} mu")
                    counts["momentum_update"] += 1
                    st = {"mu": mu.clone(), "nu": nu.clone(), "t": 1}
                    got_p, got_s = _one_launch(
                        km, "adam_update", lambda: dispatch.flat_opt_update(
                            p, g, w, st, kind="adam", lr=lr,
                            weight_decay=0.01))
                    for s in range(S):
                        lp, ls = dispatch.flat_opt_update(
                            p[s], g[s], w_s(s), {"mu": mu[s].clone(),
                                                 "nu": nu[s].clone(), "t": 1},
                            kind="adam", lr=lr_s(s), weight_decay=0.01)
                        _bitwise("adam_update", got_p[s], lp,
                                 f"{case} w {form} lr {lr_form} run {s}")
                        _bitwise("adam_update", got_s["nu"][s], ls["nu"],
                                 f"{case} w {form} lr {lr_form} run {s} nu")
                    pp, _, _ = fu.adam_update_plain(
                        p, g, mu, nu, w_rows, lr, bc1, bc2, weight_decay=0.01)
                    vs_plain("adam_update", got_p, pp, f"{case} {form}")
                    counts["adam_update"] += 1
            # dense gossip: a shared and a per-run mixing matrix
            topo = core.random_regularish(m, 3, 4, seed=0) if m <= 64 else \
                core.knn_ring(m, 8)
            P = torch.tensor(core.mixing_matrix(topo, 0.9 / topo.max_degree),
                             dtype=torch.float32, device="cuda")
            Ps = P[None] * (0.5 + torch.rand(S, 1, 1, generator=gen,
                                             device="cuda"))
            for form, mix, mix_s in (("shared", P, lambda s: P),
                                     ("per_run", Ps, lambda s: Ps[s])):
                got = _one_launch(km, "consensus_step",
                                  lambda: dispatch.consensus_mix(g, mix))
                loop = torch.stack([dispatch.consensus_mix(g[s], mix_s(s))
                                    for s in range(S)])
                _bitwise("consensus_step", got, loop, f"{case} P {form}")
                plain = km.cs.consensus_step_plain(g, mix)
                vs_plain("consensus_step", got, plain, f"{case} {form}",
                         4 * m * torch.finfo(dt).eps
                         * torch.einsum("sij,sjn->sin",
                                        mix.abs().expand(S, m, m),
                                        g.float().abs())
                         + torch.finfo(dt).eps * plain.float().abs())
                counts["consensus_step"] += 1
            # sparse gossip: the runs folded, ids into their own run
            nl = core.neighbor_list(topo)
            w0 = torch.tensor(core.neighbor_weights(nl, 0.9 / topo.max_degree),
                              dtype=torch.float32, device="cuda")
            ws = w0[None] * (0.5 + torch.rand(S, 1, 1, generator=gen,
                                              device="cuda"))
            for form, wt, wt_s in (("shared", w0, lambda s: w0),
                                   ("per_run", ws, lambda s: ws[s])):
                got = _one_launch(km, "consensus_gather",
                                  lambda: dispatch.consensus_gather(
                                      g, nl.idx, wt))
                loop = torch.stack([dispatch.consensus_gather(
                    g[s], nl.idx, wt_s(s)) for s in range(S)])
                _bitwise("consensus_gather", got, loop, f"{case} w {form}")
                idx = torch.tensor(nl.idx, device="cuda")
                plain = torch.stack([km.cg.consensus_gather_plain(
                    g[s], idx, wt_s(s)) for s in range(S)])
                vs_plain("consensus_gather", got, plain, f"{case} {form}")
                counts["consensus_gather"] += 1
            # top-k: per-run sums, the residual
            x = g.float() if dt == torch.float32 else g
            th = comm.topk_threshold(x.float(), SWEEP_TOPK)
            got = _one_launch(km, "topk_scatter",
                              lambda: dispatch.topk_scatter(x, th))
            for s in range(S):
                ls, lr_ = tks.topk_scatter_cuda(x[s], th[s].contiguous())
                _bitwise("topk_scatter", got[0][s], ls, f"{case} run {s} sum")
                _bitwise("topk_scatter", got[1][s], lr_,
                         f"{case} run {s} residual")
            ps, pr = tks.topk_scatter_plain(x, th)
            vs_plain("topk_scatter", got[1], pr, f"{case} residual")
            sent = (x.float() - got[1].float()).abs().sum(1)
            vs_plain("topk_scatter", got[0], ps, f"{case} sum",
                     m * 2.0 ** -24 * sent + torch.finfo(dt).eps
                     * ps.float().abs())
            counts["topk_scatter"] += 1
    # S == m: a 1-D coefficient has two readings; the dispatch refuses it
    sq = torch.zeros(7, 7, 16, device="cuda")
    refused = 0
    for fn in (lambda: dispatch.decay_accum(sq, sq, torch.ones(7,
                                                               device="cuda")),
               lambda: dispatch.scale_rows(sq, torch.ones(7, device="cuda")),
               lambda: dispatch.flat_opt_update(
                   sq, sq, torch.ones(7, device="cuda"), {}, kind="sgd",
                   lr=0.1)):
        try:
            fn()
        except ValueError as e:
            if "ambiguous" not in str(e):
                raise
            refused += 1
    if refused != 3:
        raise AssertionError(f"S == m: {refused} of 3 calls refused")
    torch.cuda.synchronize()
    log(f"phase sweep kernels: {sum(counts.values())} batched calls, one "
        f"launch each, bitwise equal to S unbatched launches ({counts}) at "
        f"(S, m, n) {SWEEP_KERNEL_SHAPES} in {[str(d) for d in ALL_DTYPES]}, "
        f"coefficients scalar / shared / per run / per row, lr shared / per "
        f"run; max |batched - plain| {worst} (bitwise where phase 6 / 6b pin "
        f"it); S == m refused {refused} of 3")
    return {"checks": counts, "max_abs_err": worst, "s_eq_m_refused": refused}


def sweep_bound(name, S, m, n, k=None) -> tuple:
    """The bound of one batched call: S runs' bytes and FLOP (fp32)."""
    if name in ("consensus_step", "consensus_gather", "topk_scatter"):
        b = gossip_bound(name, m, n, k)
    else:
        b = flat_bound(name, m, n)
    nbytes, flops = S * b[2], S * b[3]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def sweep_kernel_times(km, core, comm, card) -> dict:
    """Each batched kernel's device time at SWEEP_KERNEL_SHAPES in fp32 (L2
    flushed before every call; CUDA events and CUPTI) against the loop of S
    unbatched launches of the same kernel on the runs' slices, beside the
    bound of the S runs' work."""
    fu, dacc, tks = km.fu, km.dacc, km.tks
    cyc = sleep_cycles_per_ms()
    flush = l2_flusher()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 151)
    rows = {}
    for S, m, n in SWEEP_KERNEL_SHAPES:
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        p, g, mu = rnd(S, m, n), rnd(S, m, n), 0.1 * rnd(S, m, n)
        nu = mu.abs()
        w = torch.rand(S, m, generator=gen, device="cuda")
        d = -TRAIN_ETA * w
        lrs = torch.full((S,), TRAIN_ETA, device="cuda")
        po, mo, vo = (torch.empty_like(t) for t in (p, mu, nu))
        row = torch.empty(S, n, device="cuda")
        topo = core.random_regularish(m, 3, 4, seed=0) if m <= 64 else \
            core.knn_ring(m, 8)
        P = torch.tensor(core.mixing_matrix(topo, 0.9 / topo.max_degree),
                         dtype=torch.float32, device="cuda")
        Ps = P[None].expand(S, m, m).contiguous()
        nl = core.neighbor_list(topo)
        idx = torch.tensor(nl.idx, dtype=torch.int64, device="cuda")
        idx_f = (idx[None] + m * torch.arange(S, device="cuda")[:, None, None]
                 ).reshape(S * m, -1).to(torch.int32).contiguous()
        idx32 = idx.to(torch.int32).contiguous()
        wg = torch.tensor(core.neighbor_weights(nl, 0.9 / topo.max_degree),
                          dtype=torch.float32, device="cuda")
        wg_f = wg[None].expand(S, m, -1).reshape(S * m, -1).contiguous()
        th = comm.topk_threshold(g, SWEEP_TOPK)
        akw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0)
        gf, pof = g.view(S * m, n), po.view(S * m, n)
        fns = {
            "decay_accum": (
                lambda: dacc.decay_accum_cuda(p, g, d, out=po),
                lambda: [dacc.decay_accum_cuda(p[s], g[s], d[s], out=po[s])
                         for s in range(S)]),
            "row_mean": (
                lambda: fu.row_mean_cuda(g, out=row),
                lambda: [fu.row_mean_cuda(g[s], out=row[s])
                         for s in range(S)]),
            "momentum_update": (
                lambda: fu.momentum_update_cuda(p, g, mu, w, lrs, 0.9,
                                                p_out=po, mu_out=mo),
                lambda: [fu.momentum_update_cuda(
                    p[s], g[s], mu[s], w[s], TRAIN_ETA, 0.9, p_out=po[s],
                    mu_out=mo[s]) for s in range(S)]),
            "adam_update": (
                lambda: fu.adam_update_cuda(p, g, mu, nu, w, lrs, 0.9, 0.95,
                                            p_out=po, mu_out=mo, nu_out=vo,
                                            **akw),
                lambda: [fu.adam_update_cuda(
                    p[s], g[s], mu[s], nu[s], w[s], TRAIN_ETA, 0.9, 0.95,
                    p_out=po[s], mu_out=mo[s], nu_out=vo[s], **akw)
                    for s in range(S)]),
            "consensus_step": (
                lambda: km.cs.consensus_step_cuda(g, Ps, out=po),
                lambda: [km.cs.consensus_step_cuda(g[s], P, out=po[s])
                         for s in range(S)]),
            "consensus_gather": (
                lambda: km.cg.consensus_gather_cuda(gf, idx_f, wg_f, out=pof),
                lambda: [km.cg.consensus_gather_cuda(g[s], idx32, wg,
                                                     out=po[s])
                         for s in range(S)]),
            "topk_scatter": (
                lambda: tks.topk_scatter_cuda(g, th),
                lambda: [tks.topk_scatter_cuda(g[s], th[s]) for s in
                         range(S)]),
        }
        for name, (batched, loop) in fns.items():
            k = nl.k_max if name == "consensus_gather" else None
            b_ms, b_by, nbytes, flops = sweep_bound(name, S, m, n, k)
            kern = f"{name}_kernel"
            with SmClock() as clock:
                rec = {"shape": [S, m, n], "dtype": "float32",
                       "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                       "flops": flops,
                       "ms": device_ms(batched, cyc, flush, 50)[0],
                       "loop_ms": device_ms(loop, cyc, flush, 50)[0],
                       "cupti_ms": cupti_ms(batched, flush, kern),
                       "loop_cupti_ms": cupti_ms(loop, flush, None)}
            rec["sm_clock_mhz"] = clock.summary()
            rows[f"{name}/{S}x{m}x{n}"] = rec
            log(f"time {name} batched (S, m, n)=({S}, {m}, {n}) fp32 L2 "
                f"flushed: one launch {rec['ms']!r} ms (cupti "
                f"{rec['cupti_ms']!r}), loop of {S} launches "
                f"{rec['loop_ms']!r} ms (cupti {rec['loop_cupti_ms']!r}); "
                f"bound_ms={b_ms!r} ({b_by}) sm_clock_mhz="
                f"{rec['sm_clock_mhz']} card=\"{card}\"")
        del p, g, mu, nu, po, mo, vo
        torch.cuda.empty_cache()
    return rows


# The figure sweeps through repro_torch.sweep.run_sweep on the card, each at
# m = 7 and the Table II run geometry (T 150, P 25, eta 5e-3) for
# SWEEP_EPOCHS epochs, seeds 0-3: Fig. 5's lambda grid, Fig. 6's eps grid on
# the sparse E=1 topology (dense path, and the sparse path forced), Fig. 4's
# taus grid at tau = 15, a short eta x momentum / Adam grid (a static axis of
# the two optimizers) and a top-k uplink static point (a compression_axis).
SWEEP_EPOCHS = 2
SWEEP_SEEDS = (0, 1, 2, 3)
SWEEP_CPU_RUNS = 4           # runs of each sweep held against the CPU


def sweep_specs(rl, core, optim, comm, sweep) -> list:
    """``(label, spec)`` of phase 15's sweeps."""
    import dataclasses as dc

    m = 7
    def cfg(strat, **kw):
        return rl.FedRLConfig(env=rl.FIGURE_EIGHT, strategy=strat,
                              eta=TRAIN_ETA, n_epochs=SWEEP_EPOCHS,
                              epoch_len=TRAIN_T, minibatch=TRAIN_P, **kw)

    taus15 = core.uniform_taus(1, 15, m, seed=0)
    sp = core.random_regularish(m, 3, 4, seed=0)
    eps = tuple(f / sp.max_degree for f in (0.3, 0.6, 0.9))
    scheds = ((15.0,) * m,) + tuple(
        tuple(map(float, core.uniform_taus(lo, 15, m, seed=0)))
        for lo in (10, 5, 1))
    opt_axis = sweep.StaticAxis("optimizer", tuple(
        (name, lambda c, o=o: dc.replace(c, optimizer=o))
        for name, o in (("momentum", optim.flat_momentum(0.9)),
                        ("adam", optim.flat_adam()))))
    consensus = lambda sparse: core.make_strategy(
        "consensus", tau=10, topo=sp, eps=eps[0], rounds=1, m=m,
        sparse=sparse)
    return [
        ("fig5 lambda", sweep.SweepSpec(
            name="chip_fig5", seeds=SWEEP_SEEDS,
            base=cfg(core.make_strategy(
                "decay", tau=15, taus=taus15,
                decay=core.exponential_decay(0.98))),
            vmapped=(sweep.SweepAxis("lam", (0.98, 0.95, 0.92)),))),
        ("fig6 eps dense", sweep.SweepSpec(
            name="chip_fig6_dense", seeds=SWEEP_SEEDS,
            base=cfg(consensus(False)),
            vmapped=(sweep.SweepAxis("eps", eps),))),
        ("fig6 eps sparse", sweep.SweepSpec(
            name="chip_fig6_sparse", seeds=SWEEP_SEEDS,
            base=cfg(consensus(True)),
            vmapped=(sweep.SweepAxis("eps", eps),))),
        ("fig4 taus", sweep.SweepSpec(
            name="chip_fig4", seeds=SWEEP_SEEDS,
            base=cfg(core.make_strategy("periodic", tau=15, m=m)),
            vmapped=(sweep.SweepAxis("taus", scheds),))),
        ("eta x optimizer", sweep.SweepSpec(
            name="chip_eta_opt", seeds=SWEEP_SEEDS[:2],
            base=cfg(core.make_strategy("periodic", tau=10, m=m)),
            vmapped=(sweep.SweepAxis("eta", (2e-3, 5e-3)),),
            static=(opt_axis,))),
        ("top-k uplink", sweep.SweepSpec(
            name="chip_topk", seeds=SWEEP_SEEDS,
            base=cfg(core.make_strategy("periodic", tau=10, m=m)),
            static=(sweep.compression_axis([comm.topk(584)]),))),
    ]


def _sweep_vs_cpu(rl, sweep, spec, label, card_metrics) -> float:
    """The first SWEEP_CPU_RUNS runs of the static point ``label`` again on
    the CPU, on the card runs' own draws (recorded from their TorchDraws on
    the card): the largest relative difference of their metrics."""
    from repro_torch.sweep.runner import _grid_arrays, _run_configs

    transform = dict(sweep.static_points(spec))[label]
    axis_vals, seeds = _grid_arrays(spec)
    rows = range(min(SWEEP_CPU_RUNS, spec.n_runs))
    cfgs = _run_configs(spec, transform(spec.base), axis_vals, rows)
    draws = [rl.replay_of(c, rl.TorchDraws(int(seeds[i]), "cuda",
                                           c.eval_seed))
             for c, i in zip(cfgs, rows)]
    _, cpu, _ = rl.fedrl.run_fedrl_batch(cfgs, draws, device="cpu")
    worst = 0.0
    for k, v in cpu.items():
        card = card_metrics[k].reshape((spec.n_runs,) + v.shape[1:])[
            :len(rows)]
        worst = max(worst, _max_rel(card, v))
        if not np.allclose(card, v, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
            raise AssertionError(f"sweep {spec.name}/{label}: card {k} {card}"
                                 f" vs CPU {v} (rtol {TRAIN_RTOL})")
    return worst


def sweep_path(km, rl, core, optim, comm, sweep, card) -> dict:
    """Phase 15's sweeps: each batched through ``run_sweep`` on the card
    (kernel counts set to 0 just before, read just after), held against the
    loop of one-run calls (``run_sweep_loop``) and, on its first runs,
    against the CPU on the same draws; runs/s of both forms."""
    out, launches = {}, {k: 0 for k in TRAIN_KERNELS}
    for name, spec in sweep_specs(rl, core, optim, comm, sweep):
        _reset_counts(km)
        res = sweep.run_sweep(spec, device="cuda", warmup=False)
        torch.cuda.synchronize()
        got = _kernel_counts(km)
        for k, v in got.items():
            launches[k] += v
        _reset_counts(km)
        loop = sweep.run_sweep_loop(spec, device="cuda", warmup=False)
        torch.cuda.synchronize()
        loop_launches = _kernel_counts(km)
        if any(loop_launches[k] != spec.n_runs * got[k] for k in got):
            raise AssertionError(f"sweep {name}: batched launches {got}, "
                                 f"loop {loop_launches} (expected "
                                 f"{spec.n_runs} x batched)")
        dev, rel, bitwise = 0.0, 0.0, True
        for label in res.labels:
            for k, v in res.metrics[label].items():
                w = loop.metrics[label][k]
                if not np.all(np.isfinite(v)) or v.shape != w.shape:
                    raise AssertionError(f"sweep {name}/{label}: bad {k}")
                bitwise &= bool(np.array_equal(v, w))
                dev = max(dev, float(np.max(np.abs(v - w))))
                rel = max(rel, _max_rel(v, w))
                if not np.allclose(v, w, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
                    raise AssertionError(
                        f"sweep {name}/{label}: batched {k} {v} vs loop {w}")
        cpu_rel = max(_sweep_vs_cpu(rl, sweep, spec, label,
                                    {k: v for k, v in
                                     res.metrics[label].items()})
                      for label in res.labels)
        wall, loop_wall = sum(res.wall_s.values()), sum(loop.wall_s.values())
        runs = spec.n_runs * len(res.labels)
        rec = {"runs": runs, "S": spec.n_runs, "labels": res.labels,
               "wall_s": wall, "loop_wall_s": loop_wall,
               "runs_per_s": runs / wall, "loop_runs_per_s": runs / loop_wall,
               "launches": got, "bitwise_vs_loop": bitwise,
               "max_abs_dev_vs_loop": dev, "max_rel_dev_vs_loop": rel,
               "max_rel_vs_cpu": cpu_rel}
        out[name] = rec
        log(f"sweep {name}: {runs} runs (S = {spec.n_runs} per point, "
            f"{len(res.labels)} point(s)) batched in {wall!r} s = "
            f"{rec['runs_per_s']!r} runs/s, loop {loop_wall!r} s = "
            f"{rec['loop_runs_per_s']!r} runs/s; vs loop bitwise={bitwise} "
            f"(max abs {dev!r}, rel {rel!r}); first {SWEEP_CPU_RUNS} runs vs "
            f"CPU on the same draws max rel {cpu_rel!r}; launches "
            f"{ {k: v for k, v in got.items() if v} } card=\"{card}\"")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"sweep path: kernels never launched: {missing}")
    return {"sweeps": out, "launches": launches}


def sweep_divergence(S: int = 12, m: int = 7, K: int = 25) -> dict:
    """Where a batched run parts from its loop on the card: the policy's
    forward, its value, the PPO loss and its gradient on S * m agent rows
    against the same calls on each run's m rows (same inputs), and the
    batched products behind them (``torch.bmm`` / ``matmul`` with batch
    S * m against batch m), each as the largest absolute difference
    (``python3 -c 'import chip_smoke as c; c.sweep_divergence()'``)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import dispatch
    from repro_torch.rl import policy as pol
    from repro_torch.rl import ppo

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 160)
    A = S * m
    rnd = lambda *shape, scale=1.0: scale * torch.randn(
        shape, generator=gen, device="cuda")
    tree = {"pi": {"w1": rnd(A, OBS_DIM, HIDDEN, scale=0.4),
                   "b1": rnd(A, HIDDEN, scale=0.1),
                   "w2": rnd(A, HIDDEN, HIDDEN, scale=0.15),
                   "b2": rnd(A, HIDDEN, scale=0.1),
                   "w3": rnd(A, HIDDEN, ACT_DIM, scale=0.01),
                   "b3": rnd(A, ACT_DIM, scale=0.1),
                   "log_std": rnd(A, ACT_DIM, scale=0.1) - 0.5},
            "vf": {"w1": rnd(A, OBS_DIM, HIDDEN, scale=0.4),
                   "b1": rnd(A, HIDDEN, scale=0.1),
                   "w2": rnd(A, HIDDEN, HIDDEN, scale=0.15),
                   "b2": rnd(A, HIDDEN, scale=0.1),
                   "w3": rnd(A, HIDDEN, 1, scale=0.15),
                   "b3": rnd(A, 1, scale=0.1)}}
    flat, spec = dispatch.stacked_ravel_spec(tree)
    data = {"obs": rnd(A, K, OBS_DIM), "act": rnd(A, K, ACT_DIM),
            "logp_old": rnd(A, K), "adv": rnd(A, K), "ret": rnd(A, K)}
    runs = [slice(s * m, (s + 1) * m) for s in range(S)]

    def per_run(fn):
        return torch.cat([fn(r) for r in runs])

    def dev(a, b):
        return float((a - b).abs().max())

    out = {}
    with torch.no_grad():
        p = spec.unravel(flat)
        out["policy_mean"] = dev(
            pol.policy_apply(p, data["obs"])[0],
            per_run(lambda r: pol.policy_apply(spec.unravel(flat[r]),
                                               data["obs"][r])[0]))
        out["policy_value"] = dev(
            pol.policy_value(p, data["obs"]),
            per_run(lambda r: pol.policy_value(spec.unravel(flat[r]),
                                               data["obs"][r])))
        x, w = data["obs"], tree["pi"]["w1"]
        out["bmm_layer1"] = dev(x @ w, per_run(lambda r: x[r] @ w[r]))
        h = torch.tanh(x @ w)
        w2 = tree["pi"]["w2"]
        out["bmm_layer2"] = dev(h @ w2, per_run(lambda r: h[r] @ w2[r]))
        # the rollout's shape: one observation an agent, the weights as
        # views of the flat carry
        x1 = data["obs"][:, :1]
        out["policy_mean_k1"] = dev(
            pol.policy_apply(p, x1)[0],
            per_run(lambda r: pol.policy_apply(spec.unravel(flat[r]),
                                               x1[r])[0]))
        pw = p["pi"]["w1"]
        out["bmm_k1_views"] = dev(x1 @ pw, per_run(lambda r: x1[r] @ pw[r]))
        hk = torch.tanh(x1 @ pw)
        pw2 = p["pi"]["w2"]
        out["bmm_k1_layer2_views"] = dev(
            hk @ pw2, per_run(lambda r: hk[r] @ pw2[r]))
        # the gradient's shapes: x^T @ dy for the weights, the row means
        gy = rnd(A, K, HIDDEN)
        xt = x.transpose(1, 2)
        out["bmm_grad_w"] = dev(xt @ gy, per_run(lambda r: xt[r] @ gy[r]))
        adv = data["adv"]
        out["row_reduce"] = dev(adv.mean(-1), per_run(lambda r: adv[r]
                                                      .mean(-1)))
    g, loss = ppo.stacked_grad(ppo.ppo_loss, flat, spec, data)
    parts = [ppo.stacked_grad(ppo.ppo_loss, flat[r], spec,
                              {k: v[r] for k, v in data.items()})
             for r in runs]
    out["ppo_loss"] = dev(loss, torch.cat([l for _, l in parts]))
    out["ppo_grad"] = dev(g, torch.cat([gi for gi, _ in parts]))
    # one local update of the shared env (m = n_rl) on the same draws: the
    # rollout (env steps, policy) and then the gradient, batched vs per run
    from repro_torch.rl import FIGURE_EIGHT, FedRLConfig, TorchDraws
    from repro_torch.rl import fedrl as F
    from repro_torch.rl.env import get_obs

    if m == FIGURE_EIGHT.n_rl:
        from repro_torch.core import make_strategy

        cfg = FedRLConfig(env=FIGURE_EIGHT, strategy=make_strategy(
            "periodic", tau=10, m=m), eta=TRAIN_ETA, n_epochs=1,
            epoch_len=TRAIN_P, minibatch=TRAIN_P)
        ep = cfg.env.default_params("cuda")
        draws = [F.replay_of(cfg, TorchDraws(s, "cuda")) for s in range(S)]

        def update(idx):
            src = F._RunDraws([draws[i].to("cuda") for i in idx], False)
            f = flat[torch.cat([torch.arange(i * m, (i + 1) * m)
                                for i in idx]).cuda()].contiguous()
            state = F._reset(cfg, ep, src)
            with torch.no_grad():
                noise = src.action_noise(F.noise_shape(cfg))
                state, traj = F._rollout(cfg, ep, spec.unravel(f), state,
                                         noise)
            gr, ls = F._agent_grads(cfg, f, spec, ep, traj, state)
            return traj, state, gr

        traj_b, state_b, g_b = update(range(S))
        loop = [update([i]) for i in range(S)]
        for k in traj_b:
            out[f"rollout_{k}"] = dev(traj_b[k],
                                      torch.cat([t[k] for t, _, _ in loop]))
        out["rollout_env_x"] = dev(state_b.x, torch.cat([st.x for _, st, _
                                                         in loop]))
        out["update_grad"] = dev(g_b, torch.cat([gr for _, _, gr in loop]))
    log(f"sweep divergence, batch {A} vs {m} agent rows: {out} card=\""
        f"{card_line()}\"")
    return out


def _sweep_modules():
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import comm, core
    from repro_torch.kernels import consensus_gather as cg
    from repro_torch.kernels import consensus_step as cs
    from repro_torch.kernels import decay_accum as dacc
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import flat_update as fu
    from repro_torch.kernels import topk_scatter as tks
    km = types.SimpleNamespace(dacc=dacc, fu=fu, cs=cs, cg=cg, tks=tks)
    return km, core, comm, dispatch


def sweep_kernels_alone() -> dict:
    """Phase 15's kernel checks and times without the rest of the script
    (``python3 -c 'import chip_smoke as c; c.sweep_kernels_alone()'``)."""
    if not torch.cuda.is_available():
        raise SystemExit("sweep_kernels_alone: no CUDA card")
    km, core, comm, dispatch = _sweep_modules()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(f"card {card}")
    parity = sweep_kernels_vs_loop(km, core, comm, dispatch)
    rows = sweep_kernel_times(km, core, comm, card)
    return {"parity": parity, "times": rows}


# --- phases 9-11: the language-model serving path (slice 4) ------------------------

LM_ARCH = "rwkv6-1.6b"
LM_PARAMS = 1_584_144_384             # the JAX init tree's count at full width
LM_SLOTS = 8
LM_PREFILL = ((8, 512), (1, 4096))    # (B, T) of the prefill step
LM_DECODE_TOKENS = 32
LM_REQUESTS = 16
LM_PROMPT = (16, 512)                 # prompt lengths, inclusive
LM_NEW = (32, 64)                     # new tokens, inclusive
LM_MAX_SEQ = 1024
LM_ADMIT_TIMED = (1, 256)             # an admission of a mid-length prompt
LM_TIMED = 3                          # timed calls per prefill shape
# wkv6 kernel vs plain: both against the plain loop in float64 on the same
# inputs; the kernel's error within max(WKV_ATOL, 2x the fp32 plain loop's).
WKV_ATOL = 1e-5
# bf16 logits are a bf16 product rounded once, so a batch of 8 and a batch
# of 1 through cuBLAS, which round differently upstream, may put each logit
# one bf16 ulp apart: two logits, LM_BF16_ULPS = 2 ulp of the largest. The
# bf16 ServingLoop against single-request greedy decoding (fed the loop's
# own tokens): every token the single-request argmax, or, at a near-tie, its
# logit within that of the max; near-ties are counted. The same loop in fp32
# must equal single-request greedy decoding outright.
LM_BF16_ULPS = 2
# fp32 at full width (TF32 off): the model with the kernel against the same
# with the plain recurrence on the card (sums in another order), and the
# card against the CPU (cuBLAS and the CPU's BLAS summing in other orders
# over 24 layers); logits within LM_F32_ATOL.
LM_F32_ATOL = 1e-3
LM_ADMIT_PROMPT = 16      # the admission control's prompt length
LM_F32_PROMPT, LM_F32_DECODE = (2, 16), 4


def wkv6_bound(b, t, h, d=64) -> tuple:
    """Bytes: r, k, v, w read and y written once, u, the state in and out.
    FLOP: what the function needs per (b, t, h) step, 5 per (i, j) term (an
    FMA for r . S, a multiply and an FMA for the decay update) and 5 per
    index for the bonus, which factors out as v_j * sum_i r_i u_i k_i (the
    kernel spends 7 per term; the bound does not count its extra)."""
    nbytes = 4 * (5 * b * t * h * d + h * d + 2 * b * h * d * d)
    flops = 5 * b * t * h * d * (d + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def wkv6_inputs(b, t, h, seed, decay="model", state=0.1):
    """r, k, v ~ N(0, 1) (the model's r, k, v at its init scales); the
    model's decay exp(-exp(N(0, 0.5))), or a slow one exp(-exp(N(-4, 0.5)))
    (w ~ 0.98); u ~ 0.5 N(0, 1); the initial state ~ ``state`` N(0, 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    r, k, v = rnd(b, t, h, 64), rnd(b, t, h, 64), rnd(b, t, h, 64)
    shift = -4.0 if decay == "slow" else 0.0
    w = torch.exp(-torch.exp(0.5 * rnd(b, t, h, 64) + shift))
    u = 0.5 * rnd(h, 64)
    s0 = state * rnd(b, h, 64, 64)
    return r, k, v, w, u, s0


def wkv6_vs_plain(wk) -> dict:
    """Phase 9: the kernel against its plain version on the card at the
    slice's shapes (prefill 8 x 512 and 1 x 4096, decode at the slot count
    and at B = 1), odd T and T just past a stage (9, 33, 65), one and three
    heads, zero and nonzero initial states, a slow decay, a sequence split
    in two and chained through the state in place, and the bitwise edges of
    ``wkv6_edges``."""
    cases = [((8, 512, 32), "model", 0.0), ((8, 512, 32), "model", 0.1),
             ((1, 4096, 32), "model", 0.1), ((1, 4096, 32), "slow", 0.1),
             ((LM_SLOTS, 1, 32), "model", 0.1), ((1, 1, 32), "model", 0.1),
             ((1, 7, 32), "model", 0.1), ((1, 1000, 32), "model", 0.1),
             ((1, 33, 3), "model", 0.1), ((1, 65, 1), "model", 0.1),
             ((2, 9, 3), "slow", 0.1), ((4, 17, 32), "model", 0.1),
             ((LM_SLOTS, 40, 32), "model", 0.1)]
    worst = {"y": 0.0, "state": 0.0, "plain_fp32_vs_fp64": 0.0}
    rows = []

    def check(label, got, plain32, want64):
        err = float((got.double() - want64).abs().max())
        e_plain = float((plain32.double() - want64).abs().max())
        tol = max(WKV_ATOL, 2.0 * e_plain)
        if not err <= tol:
            raise AssertionError(f"wkv6 {label}: kernel err {err!r} > {tol!r} "
                                 f"(plain fp32 err {e_plain!r})")
        return err, e_plain

    for n, ((b, t, h), decay, state) in enumerate(cases):
        args = wkv6_inputs(b, t, h, SEED + 90 + n, decay, state)
        want_y, want_s = wk.wkv6_plain(*[a.double() for a in args])
        y32, s32 = wk.wkv6_plain(*args)
        y, s = wk.wkv6_cuda(*args)
        torch.cuda.synchronize()
        ey, py = check(f"y {b}x{t}x{h} {decay} s0={state}", y, y32, want_y)
        es, ps = check(f"state {b}x{t}x{h} {decay} s0={state}", s, s32, want_s)
        worst["y"], worst["state"] = max(worst["y"], ey), max(worst["state"], es)
        worst["plain_fp32_vs_fp64"] = max(worst["plain_fp32_vs_fp64"], py, ps)
        rows.append({"shape": [b, t, h, 64], "decay": decay, "state": state,
                     "y_err": ey, "state_err": es, "plain_y_err": py,
                     "plain_state_err": ps})
    # split at an odd point, chained in place through the state
    r, k, v, w, u, s0 = wkv6_inputs(1, 1000, 32, SEED + 99)
    y_full, s_full = wk.wkv6_cuda(r, k, v, w, u, s0)
    st = s0.clone()
    parts = []
    for sl in (slice(0, 417), slice(417, 1000)):
        cut = [a[:, sl].contiguous() for a in (r, k, v, w)]
        parts.append(wk.wkv6_cuda(*cut, u, st, state_out=st)[0])
    torch.cuda.synchronize()
    if not (torch.equal(torch.cat(parts, 1), y_full)
            and torch.equal(st, s_full)):
        raise AssertionError("wkv6: the chained halves differ from one run")
    edges = wkv6_edges(wk)
    log(f"phase wkv6 vs plain: {len(cases)} shapes + chained halves ok; max "
        f"abs err vs float64: y {worst['y']!r}, state {worst['state']!r} "
        f"(plain fp32 {worst['plain_fp32_vs_fp64']!r}); rule max({WKV_ATOL}, "
        f"2x fp32 plain's error); chained halves bitwise equal to one run; "
        f"bitwise edges {edges}")
    return {"max_abs_err": max(worst["y"], worst["state"]), "worst": worst,
            "cases": rows, "edges": edges}


def wkv6_edges(wk) -> dict:
    """wkv6 bitwise against itself where the kernel changes its block, its
    path or its copies but not its arithmetic: each batch row alone against
    the batch (the decode kernel at B = 8 against the one-stage tile at
    B = 1; the prefill tiles of B = 8, 4 and 1), the state updated in place
    against a separate output (decode at B = 1 and 8), inputs and states at
    an element offset (4-byte copies) against aligned ones, and a sequence
    cut at and around stage boundaries and chained through the state."""
    def unaligned(t):
        big = torch.zeros(t.numel() + 8, dtype=t.dtype, device=t.device)
        return big[1:1 + t.numel()].view(t.shape).copy_(t)

    def same(label, got, want):
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"wkv6 edge {label}: not bitwise equal")

    counts = {"batch_rows": 0, "in_place": 0, "unaligned": 0, "cuts": 0}
    for n, (b, t) in enumerate(((LM_SLOTS, 1), (LM_SLOTS, 40), (4, 70),
                                (3, 9))):
        args = wkv6_inputs(b, t, 32, SEED + 200 + n)
        full = wk.wkv6_cuda(*args)
        for i in range(b):
            one = [a[i:i + 1].contiguous() if a.ndim == 4 else a
                   for a in args]
            same(f"batch row {i} of ({b}, {t})", wk.wkv6_cuda(*one),
                 [x[i:i + 1] for x in full])
            counts["batch_rows"] += 1
    for n, b in enumerate((1, LM_SLOTS)):
        args = wkv6_inputs(b, 1, 32, SEED + 210 + n)
        want = wk.wkv6_cuda(*args)
        st = args[5].clone()
        got = wk.wkv6_cuda(*args[:5], st, state_out=st)
        if got[1].data_ptr() != st.data_ptr():
            raise AssertionError("wkv6 decode: state not written in place")
        same(f"decode in place B={b}", got, want)
        counts["in_place"] += 1
    for n, (b, t, h) in enumerate(((2, 19, 3), (LM_SLOTS, 1, 32),
                                   (1, 1, 32), (1, 70, 32))):
        args = wkv6_inputs(b, t, h, SEED + 220 + n)
        want = wk.wkv6_cuda(*args)
        moved = [unaligned(a) for a in args]
        st = unaligned(torch.zeros_like(args[5]))
        same(f"unaligned ({b}, {t}, {h})",
             wk.wkv6_cuda(*moved, state_out=st), want)
        counts["unaligned"] += 1
    r, k, v, w, u, s0 = wkv6_inputs(1, 65, 3, SEED + 230)
    y_full, s_full = wk.wkv6_cuda(r, k, v, w, u, s0)
    for cut in (1, 8, 9, 16, 32, 33, 64):
        st = s0.clone()
        ys = [wk.wkv6_cuda(*[a[:, sl].contiguous() for a in (r, k, v, w)],
                           u, st, state_out=st)[0]
              for sl in (slice(0, cut), slice(cut, 65))]
        same(f"cut at {cut} of 65", (torch.cat(ys, 1), st), (y_full, s_full))
        counts["cuts"] += 1
    torch.cuda.synchronize()
    return counts


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 numbers at ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def _margins(logits: torch.Tensor):
    """(greedy index, top1 - top2) over the last axis, in fp32. The index is
    ``argmax``'s (the first of tied maxima, as the serving loop takes it),
    not ``topk``'s, which may name another of them."""
    lf = logits.float()
    top2 = torch.topk(lf, 2, dim=-1).values
    return lf.argmax(-1), top2[..., 0] - top2[..., 1]


def _prompt_tokens(rng, cfg, b, t):
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, t)),
                           device="cuda")


def lm_greedy_check(TM, cfg, params, req, tokens, near_tie,
                    cache_len=None) -> dict:
    """Single-request greedy decoding of ``req`` on the card (prefill, then
    decode_step), fed the loop's own tokens, so that every position is
    checked; the prefill sizes the KV caches for ``cache_len`` positions, as
    the loop's ``max_seq`` sizes its own. Where a loop token is not the
    single-request argmax, its logit must lie within ``near_tie(max
    logit)`` of the max: such near-ties are returned (with how far below the
    max it lies), any other divergence raises."""
    lg, st = TM.prefill(cfg, params, torch.as_tensor(
        req.prompt[None], device="cuda"), cache_len=cache_len)
    lg = lg[:, -1:]
    pos = len(req.prompt)
    min_margin, ties = float("inf"), []
    for i, tok in enumerate(tokens):
        top, margin = _margins(lg[0, 0])
        min_margin = min(min_margin, float(margin))
        if int(top) != tok:
            best = float(lg[0, 0].max())
            below = best - float(lg[0, 0, tok])
            tie = {"rid": req.rid, "index": i, "loop": tok,
                   "single": int(top), "below_max": below,
                   "tolerance": near_tie(best)}
            if not below <= near_tie(best):
                raise AssertionError(f"ServingLoop request {req.rid}: token {i}"
                                     f" is not single-request greedy: {tie}")
            ties.append(tie)
        if i + 1 < len(tokens):
            lg, st = TM.decode_step(cfg, params, torch.tensor(
                [[tok]], device="cuda"), st, torch.tensor([pos], device="cuda"))
            pos += 1
    return {"positions": len(tokens), "min_margin": min_margin, "ties": ties}


def recurrence_in_model(TM, wk, cfg, params, toks, decoded, pos) -> dict:
    """The model with the kernel and with the plain loop on the same tokens:
    the prefill of ``toks`` at every position, then one decode step per
    token of ``decoded``. Returns the largest logit difference between the
    two, and per position both greedy tokens and the plain path's top-2
    margin."""
    impls = {"kernel": None, "plain": wk.wkv6_plain}
    hidden, states = {}, {}
    for name, impl in impls.items():
        hidden[name], states[name], _ = TM.forward(
            cfg, params, toks, mode="prefill", unembed_out=False,
            wkv_impl=impl)
    err, top_k, top_p, margins = 0.0, [], [], []

    def take(lg):
        nonlocal err
        err = max(err, float((lg["kernel"] - lg["plain"]).abs().max()))
        tk, _ = _margins(lg["kernel"])
        tp, mp = _margins(lg["plain"])
        top_k.append(tk.reshape(-1))
        top_p.append(tp.reshape(-1))
        margins.append(mp.reshape(-1))

    for r0 in range(0, toks.shape[1], 128):         # 128 positions at a time
        take({n: TM.lm_head(cfg, params, h[:, r0:r0 + 128])
              for n, h in hidden.items()})
    del hidden
    for i, tok in enumerate(decoded[:-1]):
        lg = {}
        for name, impl in impls.items():
            lg[name], states[name] = TM.decode_step(
                cfg, params, tok, states[name], pos + i, wkv_impl=impl)
        take(lg)
    return {"kernel_vs_plain": err, "kernel_top": torch.cat(top_k),
            "plain_top": torch.cat(top_p), "margins": torch.cat(margins)}


def admission_rows(TM, launch, cfg, params, reqs, max_seq):
    """An admission writes only its own slot, at full width: the first
    ``LM_SLOTS - 1`` requests fill all slots but the last, every state leaf
    is copied, and a request of ``LM_ADMIT_PROMPT`` tokens is admitted into
    the last slot. The other slots' rows must be bitwise unchanged and the
    new slot's bitwise equal to a B = 1 prefill of its prompt but the last
    token (its caches sized for ``max_seq``, as the loop's). Returns the
    loop, the copy and the request."""
    tree_leaves = TM.transformer.tree_leaves
    loop = launch.ServingLoop(cfg, params, n_slots=LM_SLOTS, max_seq=max_seq)
    for i, r in enumerate(reqs[:LM_SLOTS - 1]):
        loop._admit(r, i)
    new = launch.Request(-1, reqs[LM_SLOTS - 1].prompt[:LM_ADMIT_PROMPT], 1)
    snap = TM.transformer.tree_map(torch.clone, loop.state)
    last = LM_SLOTS - 1
    loop._admit(new, last)
    after = tree_leaves(loop.state)
    if not all(torch.equal(a[:, :last], b[:, :last])
               for a, b in zip(after, tree_leaves(snap))):
        raise AssertionError("admission changed another slot's state rows")
    _, want = TM.prefill(cfg, params, torch.as_tensor(
        new.prompt[None, :-1], device="cuda"), cache_len=max_seq)
    if not all(torch.equal(a[:, last:], b)
               for a, b in zip(after, tree_leaves(want))):
        raise AssertionError("the admitted slot's state rows differ from a "
                             "B = 1 prefill of its prompt")
    return loop, snap, new


def admission_control(TM, launch, cfg, params, reqs) -> dict:
    """:func:`admission_rows` for the RWKV6 loop, then the control: the JAX
    loop's admission from the same copy (each prompt token but the last
    through ``decode_step`` over every slot, the others fed their pending
    tokens) must move the other slots' rows; how far, and how far it moves
    their next logits, is reported."""
    tree_leaves = TM.transformer.tree_leaves
    loop, snap, new = admission_rows(TM, launch, cfg, params, reqs,
                                     LM_MAX_SEQ)
    last = LM_SLOTS - 1
    after = tree_leaves(loop.state)
    # the control: the JAX loop's admission of the same request
    jax_state = snap
    for t in tree_leaves(jax_state):
        t[:, last].zero_()
    tok = torch.from_numpy(loop._tok).cuda()
    pos = torch.zeros(LM_SLOTS, dtype=torch.long, device="cuda")
    for t in new.prompt[:-1]:
        tok[last, 0] = int(t)
        TM.decode_step(cfg, params, tok, jax_state, pos)
    moved = max(float((a[:, :last].float() - b[:, :last].float()).abs().max())
                for a, b in zip(tree_leaves(jax_state), after))
    if not moved > 0:
        raise AssertionError("control: the JAX loop's admission left the "
                             "other slots' state rows unchanged")
    tok[last, 0] = int(new.prompt[-1])
    lg_port, _ = TM.decode_step(cfg, params, tok, loop.state, pos)
    lg_jax, _ = TM.decode_step(cfg, params, tok, jax_state, pos)
    lp, lj = lg_port[:last, -1], lg_jax[:last, -1]
    out = {"slots_unchanged": last, "control_state_max_abs_change": moved,
           "control_logit_max_abs_change": float((lp - lj).abs().max()),
           "control_greedy_changed": int((lp.argmax(-1) != lj.argmax(-1))
                                         .sum())}
    log(f"check lm admission: {last} other slots' state rows bitwise "
        f"unchanged and the new slot's equal to a B = 1 prefill; control, the "
        f"JAX loop's admission of the same {LM_ADMIT_PROMPT}-token prompt: "
        f"their state rows move by up to {moved!r}, their next logits by "
        f"{out['control_logit_max_abs_change']!r} "
        f"({out['control_greedy_changed']} of {last} greedy tokens change)")
    return out


def loop_vs_single_request(TM, cfg, params, reqs, got, near_tie,
                           cache_len=None) -> dict:
    checks = [lm_greedy_check(TM, cfg, params, r, got[r.rid], near_tie,
                              cache_len) for r in reqs]
    ties = [t for c in checks for t in c["ties"]]
    return {"requests": len(checks),
            "positions": sum(c["positions"] for c in checks),
            "min_top2_margin": min(c["min_margin"] for c in checks),
            "equal_requests": sum(not c["ties"] for c in checks),
            "near_ties": ties}


def loop_vs_teacher_forced(TM, cfg, params, reqs, got) -> dict:
    """Each completion against single-request greedy decoding, outright: one
    B = 1 prefill of the request's prompt followed by the loop's tokens gives
    the request's own logits at every generated position (the model over a
    sequence equals its steps one by one), and every loop token must
    be the argmax there; so, position by position, the completion is the
    request's greedy decoding."""
    positions, min_margin = 0, float("inf")
    for r in reqs:
        toks = got[r.rid]
        seq = np.concatenate([np.asarray(r.prompt), toks[:-1]])[None]
        x, _, _ = TM.forward(cfg, params, torch.as_tensor(seq, device="cuda"),
                             mode="train", unembed_out=False)
        top, margin = _margins(TM.lm_head(cfg, params,
                                          x[0, len(r.prompt) - 1:]))
        bad = [i for i, (a, b) in enumerate(zip(top.tolist(), toks)) if a != b]
        if bad:
            raise AssertionError(f"ServingLoop {cfg.param_dtype}: request "
                                 f"{r.rid} leaves single-request greedy "
                                 f"decoding at tokens {bad}")
        positions += len(toks)
        min_margin = min(min_margin, float(margin.min()))
    return {"requests": len(reqs), "positions": positions,
            "min_top2_margin": min_margin}


def lm_serving_path(wk, _build, TC, TM, launch, card) -> dict:
    """Phase 10: rwkv6-1.6b at full width and depth, seeded bf16 weights on
    the card, through the user's entry points: ``make_prefill_step`` at
    B x T = 8 x 512 and 1 x 4096, ``make_serve_step`` for 32 tokens at B = 8,
    and a ``ServingLoop`` of 8 slots over 16 requests. The wkv6 counter is
    set to 0 before this main path and read after it; each prefill call and
    each decode step must launch the kernel once per layer, with no build.
    Then the checks: every completion against single-request greedy
    decoding on the card, an admission against the other slots' states (and
    the JAX loop's admission as the control), and in fp32 the card against
    the CPU, the kernel against the plain recurrence inside the model and
    the loop's completions outright."""
    cfg = TC.get_arch(LM_ARCH)
    L = cfg.n_layers
    rng = np.random.default_rng(SEED + 40)
    t0 = time.perf_counter()
    params = TM.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = TM.count_params(params)
    if n_params != LM_PARAMS:
        raise AssertionError(f"{LM_ARCH}: {n_params} parameters, expected "
                             f"{LM_PARAMS}")
    prefill_step = launch.make_prefill_step(cfg)
    serve_step = launch.make_serve_step(cfg)
    builds = _build.n_builds
    out = {"arch": LM_ARCH, "params": n_params, "init_s": init_s,
           "dtype": cfg.param_dtype, "prefill": {}}

    # --- the main path, counted ---
    wk.launches = 0
    for b, t in LM_PREFILL:
        toks = _prompt_tokens(rng, cfg, b, t)
        secs = []
        for _ in range(1 + LM_TIMED):
            before = wk.launches
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, states = prefill_step(params, {"tokens": toks})
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            if wk.launches - before != L:
                raise AssertionError(f"prefill {b}x{t}: {wk.launches - before} "
                                     f"wkv6 launches, expected {L}")
        if tuple(logits.shape) != (b, 1, TM.padded_vocab(cfg)) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"prefill {b}x{t}: bad logits "
                                 f"{tuple(logits.shape)}")
        med = statistics.median(secs[1:])
        out["prefill"][f"{b}x{t}"] = {"first_s": secs[0], "median_s": med,
                                      "tokens_per_s": b * t / med}
        if b == LM_SLOTS:
            dec_logits, dec_states, dec_toks = logits, states, toks
    tok = dec_logits.argmax(-1)
    decoded = [tok]
    pos = torch.full((LM_SLOTS,), LM_PREFILL[0][1], device="cuda")
    # one untimed step first: the first call of a shape loads its kernels
    before = wk.launches
    serve_step(params, tok, TM.init_decode_state(cfg, LM_SLOTS,
                                                 device="cuda"), pos)
    if wk.launches - before != L:
        raise AssertionError(f"decode warm-up: {wk.launches - before} wkv6 "
                             f"launches, expected {L}")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(LM_DECODE_TOKENS):
        before = wk.launches
        logits, dec_states = serve_step(params, tok, dec_states, pos + i)
        if wk.launches - before != L:
            raise AssertionError(f"decode step {i}: {wk.launches - before} "
                                 f"wkv6 launches, expected {L}")
        tok = logits.argmax(-1)
        decoded.append(tok)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t1
    out["decode"] = {"batch": LM_SLOTS, "steps": LM_DECODE_TOKENS,
                     "seconds": dec_s,
                     "tokens_per_s": LM_SLOTS * LM_DECODE_TOKENS / dec_s}
    reqs = [launch.Request(i, rng.integers(0, cfg.vocab_size, int(rng.integers(
        LM_PROMPT[0], LM_PROMPT[1] + 1))), int(rng.integers(LM_NEW[0],
                                                            LM_NEW[1] + 1)))
            for i in range(LM_REQUESTS)]
    warm = launch.ServingLoop(cfg, params, n_slots=LM_SLOTS,
                              max_seq=LM_MAX_SEQ)
    before = wk.launches
    warm.run([launch.Request(-1, r.prompt[:24], 2) for r in reqs[:2]])
    if wk.launches - before != L * (warm.n_prefills + warm.n_steps):
        raise AssertionError("ServingLoop warm-up: launches off the count")
    loop = launch.ServingLoop(cfg, params, n_slots=LM_SLOTS,
                              max_seq=LM_MAX_SEQ)
    before = wk.launches
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    done = loop.run(reqs)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t1
    loop_launches = wk.launches - before
    launches = wk.launches
    # --- end of the main path ---
    if _build.n_builds != builds:
        raise AssertionError("an nvcc build ran on the LM serving path")
    if loop_launches != L * (loop.n_prefills + loop.n_steps):
        raise AssertionError(f"ServingLoop: {loop_launches} wkv6 launches for "
                             f"{loop.n_prefills} prefills and {loop.n_steps} "
                             f"steps of {L} layers")
    got = {c.rid: c.tokens for c in done}
    if sorted(got) != list(range(LM_REQUESTS)) or any(
            len(got[r.rid]) != r.max_new_tokens for r in reqs):
        raise AssertionError("ServingLoop: missing or short completions")
    n_tok = sum(len(c.tokens) for c in done)
    out["loop"] = {"slots": LM_SLOTS, "requests": LM_REQUESTS,
                   "prompt_tokens": int(sum(len(r.prompt) for r in reqs)),
                   "new_tokens": n_tok, "seconds": loop_s,
                   "tokens_per_s": n_tok / loop_s,
                   "prefills": loop.n_prefills, "steps": loop.n_steps,
                   "launches": loop_launches}
    out["launches"] = launches
    out["launches_per_prefill_call"] = out["launches_per_decode_step"] = L
    # every decode step runs all LM_SLOTS slots; an admission prefills its
    # own slot alone (B = 1, its prompt's length)
    out["launches_by_shape"] = {
        f"prefill {b}x{t}": L * (1 + LM_TIMED) for b, t in LM_PREFILL}
    out["launches_by_shape"].update({
        f"admission 1x{LM_PROMPT[0]}-{LM_PROMPT[1]}":
            L * (warm.n_prefills + loop.n_prefills),
        f"decode {LM_SLOTS}x1":
            L * (1 + LM_DECODE_TOKENS + warm.n_steps + loop.n_steps)})
    if sum(out["launches_by_shape"].values()) != launches:
        raise AssertionError(f"wkv6 launches by shape "
                             f"{out['launches_by_shape']} do not add up to "
                             f"{launches}")
    log(f"phase lm serving: {LM_ARCH} {n_params} params bf16 init "
        f"{init_s!r} s; prefill tokens/s " + ", ".join(
            f"{k}: {v['tokens_per_s']!r}" for k, v in out["prefill"].items())
        + f"; decode B={LM_SLOTS} tokens/s {out['decode']['tokens_per_s']!r}; "
        f"ServingLoop {LM_SLOTS} slots x {LM_REQUESTS} requests "
        f"({out['loop']['prompt_tokens']} prompt + {n_tok} new tokens, "
        f"{loop.n_prefills} prefills, {loop.n_steps} steps) "
        f"{out['loop']['tokens_per_s']!r} new tokens/s; wkv6 launches "
        f"{launches} ({L} per prefill call and per decode step; by shape "
        f"{out['launches_by_shape']}; no build) card=\"{card}\"")

    out["check_seconds"], t_chk = {}, [time.perf_counter()]

    def checked(name):
        now = time.perf_counter()
        out["check_seconds"][name] = now - t_chk[0]
        t_chk[0] = now

    # --- check: every completion is single-request greedy decoding ---
    near_tie = lambda best: LM_BF16_ULPS * bf16_ulp(best)
    chk = loop_vs_single_request(TM, cfg, params, reqs, got, near_tie)
    out["loop_vs_single_request"] = chk
    log(f"check lm ServingLoop bf16: every token of the {LM_REQUESTS} "
        f"completions ({chk['positions']}) is single-request greedy on the "
        f"card or a near-tie; {chk['equal_requests']} completions equal "
        f"outright; {len(chk['near_ties'])} near-ties (loop token's logit "
        f"within {LM_BF16_ULPS} bf16 ulp of the max), below the max by "
        f"{sorted({t['below_max'] for t in chk['near_ties']})}")

    # --- check: an admission leaves the other slots untouched ---
    checked("loop_vs_single_request_bf16")
    out["admission"] = admission_control(TM, launch, cfg, params, reqs)
    checked("admission")
    del params, dec_states, states
    torch.cuda.empty_cache()

    # --- check: card vs CPU at full width in fp32 ---
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    p_gpu = TM.init_params(cfg32, seed=SEED, device="cuda")
    p_cpu = TM.transformer.tree_map(lambda t: t.cpu(), p_gpu)
    toks = _prompt_tokens(rng, cfg, *LM_F32_PROMPT)
    t1 = time.perf_counter()
    lg_g, st_g = TM.prefill(cfg32, p_gpu, toks)
    lg_c, st_c = TM.prefill(cfg32, p_cpu, toks.cpu())
    errs = [float((lg_g.cpu() - lg_c).abs().max())]
    tok = lg_c[:, -1:].argmax(-1)
    for i in range(LM_F32_DECODE):
        p_i = torch.full((LM_F32_PROMPT[0],), LM_F32_PROMPT[1] + i)
        lg_g, st_g = TM.decode_step(cfg32, p_gpu, tok.cuda(), st_g, p_i.cuda())
        lg_c, st_c = TM.decode_step(cfg32, p_cpu, tok, st_c, p_i)
        errs.append(float((lg_g.cpu() - lg_c).abs().max()))
        tok = lg_c[:, -1:].argmax(-1)
    state_err = float((st_g["tm"]["wkv"].cpu() - st_c["tm"]["wkv"]).abs().max())
    if max(errs) > LM_F32_ATOL or not all(np.isfinite(errs)):
        raise AssertionError(f"lm fp32 card vs CPU: logits errs {errs}")
    out["card_vs_cpu_fp32"] = {"logits_max_abs_err": errs,
                               "wkv_state_max_abs_err": state_err,
                               "atol": LM_F32_ATOL,
                               "seconds": time.perf_counter() - t1}
    checked("card_vs_cpu_fp32 (with the fp32 init)")
    log(f"check lm fp32 card vs CPU ({LM_F32_PROMPT[0]} x {LM_F32_PROMPT[1]} "
        f"prompt tokens + {LM_F32_DECODE} decode steps): logits max abs err "
        f"per call {errs} (atol {LM_F32_ATOL}); wkv state {state_err!r}")
    del p_cpu, st_g, st_c
    # --- check: the kernel against the plain recurrence in the model ---
    rec = recurrence_in_model(TM, wk, cfg32, p_gpu, dec_toks, decoded, pos)
    if not rec["kernel_vs_plain"] <= LM_F32_ATOL:
        raise AssertionError(f"lm kernel vs plain recurrence (fp32 model): "
                             f"logits max err {rec['kernel_vs_plain']!r}")
    sure = rec["margins"] > 2 * LM_F32_ATOL
    same = rec["kernel_top"] == rec["plain_top"]
    if not bool(same[sure].all()):
        raise AssertionError("lm kernel vs plain recurrence (fp32 model): "
                             "greedy tokens differ where the top-2 margin "
                             "exceeds twice the tolerance")
    out["kernel_vs_plain_model_fp32"] = {
        "logits_max_abs_err": rec["kernel_vs_plain"], "atol": LM_F32_ATOL,
        "tokens_compared": same.numel(), "tokens_equal": int(same.sum()),
        "positions_beyond_tolerance": int(sure.sum())}
    log(f"check lm kernel vs plain recurrence (fp32 model, prefill "
        f"{LM_SLOTS}x{LM_PREFILL[0][1]} every position + {LM_DECODE_TOKENS} "
        f"decode steps): logits max abs err {rec['kernel_vs_plain']!r} (atol "
        f"{LM_F32_ATOL}); greedy tokens equal at {int(same.sum())} of "
        f"{same.numel()} positions, at every one of the {int(sure.sum())} "
        f"whose margin exceeds {2 * LM_F32_ATOL}")
    checked("kernel_vs_plain_fp32")
    # the same requests through the loop in fp32: equal outright
    loop32 = launch.ServingLoop(cfg32, p_gpu, n_slots=LM_SLOTS,
                                max_seq=LM_MAX_SEQ)
    got32 = {c.rid: c.tokens for c in loop32.run(reqs)}
    chk = loop_vs_teacher_forced(TM, cfg32, p_gpu, reqs, got32)
    out["loop_vs_single_request_fp32"] = chk
    same = sum(got32[r.rid] == got[r.rid] for r in reqs)
    log(f"check lm ServingLoop fp32: all {LM_REQUESTS} completions "
        f"({chk['positions']} tokens) equal single-request greedy decoding on "
        f"the card (logits of one B = 1 prefill per request over its prompt "
        f"and the loop's tokens); smallest top-2 margin "
        f"{chk['min_top2_margin']!r}; {same} of {LM_REQUESTS} equal the bf16 "
        f"loop's")
    checked("loop_fp32")
    log(f"phase lm serving: seconds by check {out['check_seconds']}")
    del p_gpu, loop32
    torch.cuda.empty_cache()
    return out


def events_ms(fn, n: int) -> float:
    """Time per call by CUDA events around ``n`` calls after one warm call:
    for the plain recurrence, a host loop of small launches, the events
    measure the host's enqueue as much as the device."""
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def lm_times(wk, lm, card) -> dict:
    """Phase 11: wkv6 at the prefill, admission and decode shapes, L2
    flushed and warm (CUDA events and CUPTI), beside its bound and the plain
    loop's time."""
    cyc = sleep_cycles_per_ms()
    flush = l2_flusher()
    rows = {}
    for b, t in LM_PREFILL + (LM_ADMIT_TIMED, (LM_SLOTS, 1), (1, 1)):
        args = wkv6_inputs(b, t, 32, SEED + 7)
        st = args[5].clone()
        kern = lambda a=args, st=st: wk.wkv6_cuda(*a[:5], st, state_out=st)
        plain = lambda a=args: wk.wkv6_plain(*a)
        n_plain = 1 if t > 1 else 50
        p1 = events_ms(plain, n_plain)
        k1, k2 = device_ms(kern, cyc, flush)[0], device_ms(kern, cyc, flush)[0]
        p2 = events_ms(plain, n_plain)
        b_ms, b_by, nbytes, flops = wkv6_bound(b, t, 32)
        rec = {"shape": [b, t, 32, 64], "ms": (k1 + k2) / 2,
               "plain_ms": (p1 + p2) / 2, "library_ms": None,
               "cupti_ms": cupti_ms(kern, flush, "wkv6_kernel"),
               "warm_l2_cupti_ms": cupti_ms(kern, None, "wkv6_kernel"),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops}
        rows[f"wkv6/{b}x{t}"] = rec
        log(f"time wkv6 shape=({b}, {t}, 32, 64) fp32 L2 flushed: kernel_ms="
            f"{rec['ms']!r} (cupti {rec['cupti_ms']!r}; L2-warm cupti "
            f"{rec['warm_l2_cupti_ms']!r}) plain_ms={rec['plain_ms']!r} "
            f"(events over {n_plain} calls) library_ms=None bound_ms="
            f"{b_ms!r} ({b_by}) card=\"{card}\"")
    loop = lm["loop"]
    rows["launches_per_request"] = {
        "single_request": {str(n): lm["launches_per_prefill_call"] * (1 + n)
                           for n in LM_NEW},
        "loop_mean": loop["launches"] / loop["requests"]}
    return rows


def profile_decode(TC, TM, launch, card) -> dict:
    """One ``torch.profiler`` window over 16 decode steps at B = 8 (full
    width, bf16): wall time, device busy time and idle share, and the device
    time of the wkv6 kernel against the matrix products."""
    cfg = TC.get_arch(LM_ARCH)
    params = TM.init_params(cfg, seed=SEED, device="cuda")
    steps = 16
    dev, wall_us = decode_window(launch, cfg, params, LM_SLOTS, 64, steps,
                                 SEED + 41)
    busy = sum(t for _, t in dev.values())
    wkv = sum(t for k, (_, t) in dev.items() if "wkv6" in k)
    mm = _matmul_us(dev)
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:12]
    out = {"steps": steps, "batch": LM_SLOTS, "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy / 1e3,
           "device_idle_share": 1.0 - busy / wall_us,
           "wkv6_ms": wkv / 1e3, "matmul_ms": mm / 1e3,
           "wkv6_share_of_busy": wkv / busy if busy else None,
           "matmul_share_of_busy": mm / busy if busy else None,
           "top_device_ops": {k: {"count": c, "device_ms": t / 1e3}
                              for k, (c, t) in top}}
    log(f"profile lm decode B={LM_SLOTS} x {steps} steps: wall_ms="
        f"{out['wall_ms']!r} device_busy_ms={out['device_busy_ms']!r} "
        f"device_idle_share={out['device_idle_share']!r} wkv6_ms="
        f"{out['wkv6_ms']!r} matmul_ms={out['matmul_ms']!r} (shares of busy "
        f"{out['wkv6_share_of_busy']!r} / {out['matmul_share_of_busy']!r}) "
        f"card=\"{card}\"")
    del params
    torch.cuda.empty_cache()
    return out


def _device_ops(prof) -> dict:
    """Device time by kernel name of a profiled window: name -> (count,
    device us)."""
    from torch.autograd import DeviceType
    return {e.key: (e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def _matmul_us(dev) -> float:
    return sum(t for k, (_, t) in dev.items()
               if any(s in k.lower() for s in ("gemm", "gemv", "xmma",
                                               "cutlass", "cublas", "nvjet")))


def decode_window(launch, cfg, params, b, t, steps, seed) -> tuple:
    """``steps`` greedy decode steps at batch ``b`` after a ``t``-token
    prefill and 4 unprofiled steps, in one ``torch.profiler`` window:
    (device time by kernel name, wall us)."""
    from torch.profiler import ProfilerActivity, profile
    serve_step = launch.make_serve_step(cfg)
    toks = _prompt_tokens(np.random.default_rng(seed), cfg, b, t)
    logits, st = launch.make_prefill_step(cfg)(params, {"tokens": toks})
    tok = logits.argmax(-1)
    pos = torch.full((b,), t, device="cuda")
    for i in range(4):
        logits, st = serve_step(params, tok, st, pos + i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            logits, st = serve_step(params, tok, st, pos + 4 + i)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return _device_ops(prof), wall_us

# --- phases 12-14: sliding-window attention serving (slice 5) -----------------------

SWA_ARCH = "h2o-danube-3-4b"
SWA_PARAMS = 3_961_839_360            # the JAX init tree's count at full width
SWA_WINDOW = 4096
SWA_PREFILL = ((8, 512), (1, 8192))   # (B, T) of the prefill step
SWA_LONG = (1, 16384)                 # timed beside (1, 8192): O(S * W) work
SWA_LONG_PROMPT = 4600                # request 0's prompt: its ring wraps
SWA_MAX_SEQ = 4736
SWA_F32_PREFILL, SWA_F32_DECODE = 4100, 8   # prefill, then decode past W
# swa_attention kernel vs plain: both against the plain version in float64
# on the same inputs; the kernel's error within max(SWA_ATOL, 2x the fp32
# plain version's), bf16 outputs one bf16 ulp (BF16_REL) more. In bf16 also
# the mean: the kernel's mean |err| within SWA_MEAN_RATIO x the plain
# version's (fp32 p, o rounded once), a rule that one bf16 p breaks.
SWA_ATOL = 1e-5
SWA_MEAN_RATIO = 1.1
SWA_KERNEL = "swa_attention_hopper_kernel"   # the bf16 kernel in CUPTI
# The SFU's exponentials: 132 SMs x 16 ex2 a clock at ~1.85 GHz (H100 SXM).
SFU_EXP_PER_S = 3.9e12
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def swa_inputs(b, sq, sk, h, kv, d, dtype, seed):
    """q, k, v ~ N(0, 1): scores of unit scale after the D^-1/2, as the
    model's RMS-normed projections give."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)
    return rnd(b, sq, h, d), rnd(b, sk, kv, d), rnd(b, sk, kv, d)


def swa_pairs(b, sq, sk, h, window, causal) -> int:
    """Unmasked (i, j) pairs: the work the function needs for these shapes."""
    i = np.arange(sq)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    hi = np.minimum(sk - 1, i) if causal else np.full_like(i, sk - 1)
    return int(b * h * np.maximum(0, hi - lo + 1).sum())


def swa_bound(b, sq, sk, h, kv, d, window, causal) -> dict:
    """The least time of the function on bf16 inputs under the kernel's
    contract: the larger of its bytes (q, k, v read and o written once) over
    the HBM rate and its FLOP over the bf16 tensor cores' peak. Per unmasked
    pair, 2 * D for q . k and, with ``p`` kept to fp32 accuracy as bf16
    p_hi + p_lo, 2 * 2 * D for p . v. Beside it, the same bound if ``p``
    were one bf16 (2 * D for p . v) and the pairs' exponentials on the SFU,
    and the largest of the three limits."""
    pairs = swa_pairs(b, sq, sk, h, window, causal)
    nbytes = 2 * d * (2 * b * sq * h + 2 * b * sk * kv)
    flops = 6 * d * pairs
    limits = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
              "operations": flops / BF16_FLOP_PER_S * 1e3,
              "sfu_exp": pairs / SFU_EXP_PER_S * 1e3}
    peak = (f"{BF16_FLOP_PER_S / 1e12:g} TFLOP/s (bf16 tensor cores), "
            f"{HBM_BYTES_PER_S / 1e12:g} TB/s, exp {SFU_EXP_PER_S / 1e12:g} "
            f"T/s (SFU)")
    return {"bound_ms": max(limits["bytes"], limits["operations"]),
            "bound_by": ("bytes" if limits["bytes"] >= limits["operations"]
                         else "operations"),
            "bytes": nbytes, "flops": flops, "pairs": pairs,
            "bound_peak": peak, "limits_ms": limits,
            "largest_limit": max(limits, key=limits.get),
            "bound_single_bf16_p_ms": max(
                limits["bytes"], 4 * d * pairs / BF16_FLOP_PER_S * 1e3)}


def swa_one_bf16_p(sw, q, k, v, window, causal):
    """The control of the mean-error rule: the function with its softmax
    weights rounded once to bf16 for ``p @ v`` (scores, sums and products in
    fp32), what the bf16 kernel would compute without ``p_lo``. Loops over
    (b, KV group) as the plain version does."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    out = torch.empty_like(q)
    for b in range(B):
        for g in range(KV):
            s = torch.einsum("shd,td->hst", q[b, :, g * rep:(g + 1) * rep]
                             .float(), k[b, :, g].float()) * D ** -0.5
            s = s.masked_fill(~ok, sw.NEG_INF)
            p = torch.exp(s - s.amax(-1, keepdim=True))
            o = torch.einsum("hst,td->shd", p.bfloat16().float(),
                             v[b, :, g].float())
            out[b, :, g * rep:(g + 1) * rep] = (
                o / p.sum(-1).T[..., None]).to(q.dtype)
    return out


def swa_mean_rule(sw, q, k, v, got, want, plain, window, causal, what,
                  control=True) -> dict:
    """bf16: the kernel's mean |err| against float64 within SWA_MEAN_RATIO x
    the plain version's and, if ``control``, the control (one bf16 p)
    beyond it wherever W > 1 (with W = 1, p = 1 is exact in bf16); raises
    otherwise. The control's mean error is returned either way."""
    mean = lambda x: float((x.double() - want).abs().mean())
    m_plain, m_kern = mean(plain), mean(got)
    m_ctrl = mean(swa_one_bf16_p(sw, q, k, v, window, causal))
    lim = SWA_MEAN_RATIO * m_plain
    if not m_kern <= lim:
        raise AssertionError(f"{what}: kernel mean err {m_kern!r} beyond "
                             f"{SWA_MEAN_RATIO} x plain's {m_plain!r}")
    if control and window != 1 and not m_ctrl > lim:
        raise AssertionError(f"{what}: the control (one bf16 p) mean err "
                             f"{m_ctrl!r} within {SWA_MEAN_RATIO} x plain's "
                             f"{m_plain!r}: the rule cannot see it")
    return {"mean_err": m_kern, "plain_mean_err": m_plain,
            "one_bf16_p_mean_err": m_ctrl, "mean_limit": lim}


def swa_check(sw, q, k, v, got, window, causal, what,
              control=True) -> dict:
    """The kernel's output ``got`` on q, k, v against the plain version, both
    held to the plain version in float64: the largest error within
    max(SWA_ATOL, 2x the plain version's), bf16 outputs one bf16 ulp more,
    and in bf16 the mean-error rule (``swa_mean_rule``); raises otherwise."""
    kw = dict(window=window, causal=causal)
    want = sw.swa_attention_plain(q.double(), k.double(), v.double(), **kw)
    plain = sw.swa_attention_plain(q, k, v, **kw)
    e_plain = float((plain.double() - want).abs().max())
    dev = (got.double() - want).abs()
    tol = max(SWA_ATOL, 2.0 * e_plain)
    lim = tol + (BF16_REL * want.abs() if q.dtype == torch.bfloat16 else 0.0)
    if not bool((dev <= lim).all()) or got.dtype != q.dtype:
        raise AssertionError(f"{what}: kernel err {float(dev.max())!r} beyond "
                             f"{tol!r} (plain err {e_plain!r})")
    row = {"err": float(dev.max()), "plain_err": e_plain}
    if q.dtype == torch.bfloat16:
        row.update(swa_mean_rule(sw, q, k, v, got, want, plain, window,
                                 causal, what, control))
    return row


def _mean_ratios(rows) -> dict:
    """The largest kernel / plain mean-error ratio of the bf16 rows and the
    smallest control / plain ratio of those with W > 1."""
    ratio = lambda r, key: r[key] / max(r["plain_mean_err"], 1e-30)
    b16 = [r for r in rows if "mean_err" in r]
    return {"mean_ratio_max": max(ratio(r, "mean_err") for r in b16),
            "control_ratio_min": min(ratio(r, "one_bf16_p_mean_err")
                                     for r in b16 if r["window"] != 1)}


def swa_vs_plain(sw) -> dict:
    """Phase 12: the kernel against its plain version on the card at the
    slice's shapes (prefill 8 x 512 and 1 x 8192 at W = 4096, bf16 and
    fp32), no window with causal on and off, a window smaller than a tile
    and W = 1, ragged lengths (7, 1000, 4097), D = 128 with 24 / 8 heads
    (phi4-mini's), and Sq != Sk either way; in bf16 also the tensor-core
    kernel's tile edges: Sq and Sk of 129 and 255 (Sq != Sk both ways),
    W = 1 and W = 100 (below one 128-key tile), causal off, B = 3 with
    H / KV = 4 and 1, D = 128."""
    f32, b16 = (torch.float32,), (torch.bfloat16,)
    both = f32 + b16
    cases = [  # b, sq, sk, h, kv, d, window, causal, dtypes
        (8, 512, 512, 32, 8, 120, SWA_WINDOW, True, both),
        (1, 8192, 8192, 32, 8, 120, SWA_WINDOW, True, both),
        (2, 1000, 1000, 32, 8, 120, None, True, f32),
        (2, 1000, 1000, 32, 8, 120, None, False, both),
        (1, 1000, 1000, 32, 8, 120, 40, True, f32),
        (1, 1000, 1000, 32, 8, 120, 1, True, f32),
        (1, 7, 7, 32, 8, 120, SWA_WINDOW, True, both),
        (1, 4097, 4097, 32, 8, 120, SWA_WINDOW, True, b16),
        (2, 512, 512, 24, 8, 128, None, True, both),
        (1, 300, 700, 32, 8, 120, 256, True, f32),
        (1, 700, 300, 24, 8, 128, None, True, f32),
        # bf16 at the tensor-core kernel's tile edges (128 rows and keys)
        (1, 129, 255, 32, 8, 120, None, True, b16),
        (1, 255, 129, 32, 8, 120, None, True, b16),
        (2, 255, 255, 24, 8, 128, 100, True, b16),
        (1, 1000, 1000, 32, 8, 120, 1, True, b16),
        (1, 1000, 1000, 32, 8, 120, 100, True, b16),
        (1, 129, 300, 32, 8, 120, None, False, b16),
        (3, 200, 200, 32, 8, 120, 100, True, b16),
        (3, 300, 300, 8, 8, 128, None, True, b16),
    ]
    worst = {"float32": 0.0, "bfloat16": 0.0, "plain_fp32_vs_fp64": 0.0}
    rows = []
    for n, (b, sq, sk, h, kv, d, window, causal, dtypes) in enumerate(cases):
        for dtype in dtypes:
            q, k, v = swa_inputs(b, sq, sk, h, kv, d, dtype, SEED + 120 + n)
            got = sw.swa_attention_cuda(q, k, v, window=window, causal=causal)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[-1]
            row = {"shape": [b, sq, sk, h, kv, d], "window": window,
                   "causal": causal, "dtype": name}
            row.update(swa_check(sw, q, k, v, got, window, causal,
                                 f"swa_attention {(b, sq, sk, h, kv, d)} "
                                 f"window={window} causal={causal} {dtype}"))
            worst[name] = max(worst[name], row["err"])
            if dtype == torch.float32:
                worst["plain_fp32_vs_fp64"] = max(worst["plain_fp32_vs_fp64"],
                                                  row["plain_err"])
            rows.append(row)
            del q, k, v, got
    torch.cuda.empty_cache()
    worst.update(_mean_ratios(rows))
    log(f"phase swa_attention vs plain: {len(rows)} cases ok; max abs err vs "
        f"float64: fp32 {worst['float32']!r}, bf16 {worst['bfloat16']!r} "
        f"(plain fp32 {worst['plain_fp32_vs_fp64']!r}); rule max({SWA_ATOL}, "
        f"2x fp32 plain's error), + one bf16 ulp for bf16 outputs; bf16 mean "
        f"err / plain's at most {worst['mean_ratio_max']!r} (rule "
        f"<= {SWA_MEAN_RATIO}); the control (one bf16 p) at least "
        f"{worst['control_ratio_min']!r} (W > 1)")
    return {"max_abs_err": worst["float32"], "worst": worst, "cases": rows}


def swa_model_kernel_vs_plain(sw, TM, cfg, params, rng) -> dict:
    """bf16 inside the model: one prefill at each of the slice's shapes
    (8 x 512, 1 x 8192) through the kernel, and at every layer the kernel's
    output on that layer's own q, k, v held against the plain version by
    phase 12's rules (``swa_check``: largest error, mean error). The
    control's ratio is reported, not required: how far one bf16 p moves the
    mean depends on the layer's inputs (V rows alike hide it); phase 12
    shows the rule breaks it."""
    out = {}
    for b, t in SWA_PREFILL:
        rows = []

        def checked_kernel(q, k, v, *, window, causal):
            got = sw.swa_attention_cuda(q, k, v, window=window, causal=causal)
            row = {"layer": len(rows), "window": window}
            row.update(swa_check(sw, q, k, v, got, window, causal,
                                 f"{SWA_ARCH} {b}x{t} layer {len(rows)}",
                                 control=False))
            rows.append(row)
            return got

        TM.prefill(cfg, params, _prompt_tokens(rng, cfg, b, t),
                   swa_impl=checked_kernel)
        if len(rows) != cfg.n_layers:
            raise AssertionError(f"{b}x{t}: {len(rows)} attention calls, "
                                 f"expected {cfg.n_layers}")
        ctrl = [r["one_bf16_p_mean_err"] / r["plain_mean_err"] for r in rows]
        res = dict(layers=len(rows), max_err=max(r["err"] for r in rows),
                   **_mean_ratios(rows), control_ratio_median=float(
                       np.median(ctrl)), control_ratio_max=max(ctrl))
        out[f"{b}x{t}"] = res
        log(f"check swa kernel vs plain attention (bf16 model, prefill {b} x "
            f"{t}, each of {len(rows)} layers on its own q, k, v): max abs err "
            f"{res['max_err']!r} (phase 12's rule); mean err / plain's at most "
            f"{res['mean_ratio_max']!r} (rule <= {SWA_MEAN_RATIO}); the "
            f"control (one bf16 p, not required): min "
            f"{res['control_ratio_min']!r}, median "
            f"{res['control_ratio_median']!r}, max {res['control_ratio_max']!r}")
    torch.cuda.empty_cache()
    return out


def _swa_requests(rng, launch, cfg):
    """16 requests: prompts of 16-512 tokens and 32-64 new tokens, but
    request 0's prompt of SWA_LONG_PROMPT tokens, which wraps its ring."""
    reqs = []
    for i in range(LM_REQUESTS):
        n = SWA_LONG_PROMPT if i == 0 else int(rng.integers(LM_PROMPT[0],
                                                             LM_PROMPT[1] + 1))
        reqs.append(launch.Request(i, rng.integers(0, cfg.vocab_size, n),
                                   int(rng.integers(LM_NEW[0], LM_NEW[1] + 1))))
    return reqs


def swa_serving_path(sw, _build, TC, TM, launch, card) -> dict:
    """Phase 13: h2o-danube-3-4b at full width and depth, seeded bf16
    weights on the card, through the user's entry points:
    ``make_prefill_step`` at 8 x 512 and 1 x 8192 (past the window),
    ``make_serve_step`` for 32 tokens at B = 8, and a ``ServingLoop`` of 8
    slots over 16 requests. The swa_attention counter is set to 0 before
    this main path and read after it: 24 launches per prefill call and per
    admission, none per decode step, no build. Then the checks: every
    completion against single-request greedy decoding on the card, an
    admission against the other slots' cache rows, the bf16 kernel against
    the plain attention on each layer's inputs, and in fp32 the card
    against the CPU, prefill-then-decode across the ring's wrap against one
    forward, the kernel against the plain attention inside the model, and
    the loop's completions outright."""
    cfg = TC.get_arch(SWA_ARCH)
    L = cfg.n_layers
    rng = np.random.default_rng(SEED + 50)
    t0 = time.perf_counter()
    params = TM.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = TM.count_params(params)
    if n_params != SWA_PARAMS:
        raise AssertionError(f"{SWA_ARCH}: {n_params} parameters, expected "
                             f"{SWA_PARAMS}")
    prefill_step = launch.make_prefill_step(cfg)
    serve_step = launch.make_serve_step(cfg)
    builds = _build.n_builds
    out = {"arch": SWA_ARCH, "params": n_params, "init_s": init_s,
           "dtype": cfg.param_dtype, "prefill": {}}

    # --- the main path, counted ---
    sw.launches = 0
    for b, t in SWA_PREFILL:
        toks = _prompt_tokens(rng, cfg, b, t)
        secs = []
        for _ in range(1 + LM_TIMED):
            before = sw.launches
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, states = prefill_step(params, {"tokens": toks})
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            if sw.launches - before != L:
                raise AssertionError(f"prefill {b}x{t}: {sw.launches - before}"
                                     f" swa_attention launches, expected {L}")
        if tuple(logits.shape) != (b, 1, TM.padded_vocab(cfg)) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"prefill {b}x{t}: bad logits "
                                 f"{tuple(logits.shape)}")
        med = statistics.median(secs[1:])
        out["prefill"][f"{b}x{t}"] = {"first_s": secs[0], "median_s": med,
                                      "tokens_per_s": b * t / med}
        if b == LM_SLOTS:
            dec_logits, dec_states = logits, states
        del states
    tok = dec_logits.argmax(-1)
    pos = torch.full((LM_SLOTS,), SWA_PREFILL[0][1], device="cuda")
    serve_step(params, tok, TM.init_decode_state(
        cfg, LM_SLOTS, max_seq=SWA_PREFILL[0][1], device="cuda"), pos)
    before = sw.launches
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(LM_DECODE_TOKENS):
        logits, dec_states = serve_step(params, tok, dec_states, pos + i)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t1
    if sw.launches != before or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"decode: {sw.launches - before} swa_attention "
                             f"launches in {LM_DECODE_TOKENS} steps, expected 0")
    out["decode"] = {"batch": LM_SLOTS, "steps": LM_DECODE_TOKENS,
                     "seconds": dec_s,
                     "tokens_per_s": LM_SLOTS * LM_DECODE_TOKENS / dec_s}
    del dec_states
    reqs = _swa_requests(rng, launch, cfg)
    warm = launch.ServingLoop(cfg, params, n_slots=LM_SLOTS, max_seq=64)
    warm.run([launch.Request(-1, r.prompt[:24], 2) for r in reqs[1:3]])
    del warm
    loop = launch.ServingLoop(cfg, params, n_slots=LM_SLOTS,
                              max_seq=SWA_MAX_SEQ)
    before = sw.launches
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    done = loop.run(reqs)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t1
    loop_launches = sw.launches - before
    launches = sw.launches
    # --- end of the main path ---
    if _build.n_builds != builds:
        raise AssertionError("an nvcc build ran on the SWA serving path")
    if loop_launches != L * loop.n_prefills:
        raise AssertionError(f"ServingLoop: {loop_launches} swa_attention "
                             f"launches for {loop.n_prefills} prefills of {L} "
                             f"layers (and none per decode step)")
    got = {c.rid: c.tokens for c in done}
    if sorted(got) != list(range(LM_REQUESTS)) or any(
            len(got[r.rid]) != r.max_new_tokens for r in reqs):
        raise AssertionError("ServingLoop: missing or short completions")
    n_tok = sum(len(c.tokens) for c in done)
    out["loop"] = {"slots": LM_SLOTS, "requests": LM_REQUESTS,
                   "max_seq": SWA_MAX_SEQ,
                   "prompt_tokens": int(sum(len(r.prompt) for r in reqs)),
                   "new_tokens": n_tok, "seconds": loop_s,
                   "tokens_per_s": n_tok / loop_s,
                   "prefills": loop.n_prefills, "steps": loop.n_steps,
                   "launches": loop_launches}
    out["launches"] = launches
    out["launches_per_prefill_call"], out["launches_per_decode_step"] = L, 0
    del loop
    log(f"phase swa serving: {SWA_ARCH} {n_params} params bf16 init "
        f"{init_s!r} s; prefill tokens/s " + ", ".join(
            f"{k}: {v['tokens_per_s']!r}" for k, v in out["prefill"].items())
        + f"; decode B={LM_SLOTS} tokens/s {out['decode']['tokens_per_s']!r}; "
        f"ServingLoop {LM_SLOTS} slots x {LM_REQUESTS} requests, max_seq "
        f"{SWA_MAX_SEQ} ({out['loop']['prompt_tokens']} prompt + {n_tok} new "
        f"tokens, {out['loop']['prefills']} prefills, {out['loop']['steps']} "
        f"steps) {out['loop']['tokens_per_s']!r} new tokens/s; swa_attention "
        f"launches {launches} ({L} per prefill call, 0 per decode step; no "
        f"build) card=\"{card}\"")

    out["check_seconds"], t_chk = {}, [time.perf_counter()]

    def checked(name):
        now = time.perf_counter()
        out["check_seconds"][name] = now - t_chk[0]
        t_chk[0] = now

    # --- check: every completion is single-request greedy decoding ---
    near_tie = lambda best: LM_BF16_ULPS * bf16_ulp(best)
    chk = loop_vs_single_request(TM, cfg, params, reqs, got, near_tie,
                                 cache_len=SWA_MAX_SEQ)
    out["loop_vs_single_request"] = chk
    log(f"check swa ServingLoop bf16: every token of the {LM_REQUESTS} "
        f"completions ({chk['positions']}) is single-request greedy on the "
        f"card or a near-tie; {chk['equal_requests']} completions equal "
        f"outright; {len(chk['near_ties'])} near-ties (loop token's logit "
        f"within {LM_BF16_ULPS} bf16 ulp of the max), below the max by "
        f"{sorted({t['below_max'] for t in chk['near_ties']})}")
    checked("loop_vs_single_request_bf16")
    # --- check: an admission leaves the other slots untouched ---
    adm, _, _ = admission_rows(TM, launch, cfg, params, reqs, SWA_MAX_SEQ)
    wrapped = int((adm.state["cache"]["pos"][:, 0] >= 0).sum())
    out["admission"] = {"slots_unchanged": LM_SLOTS - 1,
                        "slot0_ring_slots_filled": wrapped}
    log(f"check swa admission: {LM_SLOTS - 1} other slots' cache rows (k, v, "
        f"pos) bitwise unchanged and the new slot's equal to a B = 1 prefill "
        f"(slot 0 holds request 0's {SWA_LONG_PROMPT - 1}-token prefill in "
        f"{wrapped // cfg.n_layers} of {SWA_WINDOW} ring slots per layer)")
    checked("admission")
    # --- check: the bf16 kernel against the plain attention in the model ---
    out["kernel_vs_plain_model_bf16"] = swa_model_kernel_vs_plain(
        sw, TM, cfg, params, np.random.default_rng(SEED + 51))
    del adm, params
    torch.cuda.empty_cache()
    checked("kernel_vs_plain_bf16")

    # --- fp32 at full width ---
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    p_gpu = TM.init_params(cfg32, seed=SEED, device="cuda")
    p_cpu = TM.transformer.tree_map(lambda t: t.cpu(), p_gpu)
    toks = _prompt_tokens(rng, cfg, *LM_F32_PROMPT)
    t1 = time.perf_counter()
    lg_g, st_g = TM.prefill(cfg32, p_gpu, toks, cache_len=64)
    lg_c, st_c = TM.prefill(cfg32, p_cpu, toks.cpu(), cache_len=64)
    errs = [float((lg_g.cpu() - lg_c).abs().max())]
    tok = lg_c[:, -1:].argmax(-1)
    for i in range(LM_F32_DECODE):
        p_i = torch.full((LM_F32_PROMPT[0],), LM_F32_PROMPT[1] + i)
        lg_g, st_g = TM.decode_step(cfg32, p_gpu, tok.cuda(), st_g, p_i.cuda())
        lg_c, st_c = TM.decode_step(cfg32, p_cpu, tok, st_c, p_i)
        errs.append(float((lg_g.cpu() - lg_c).abs().max()))
        tok = lg_c[:, -1:].argmax(-1)
    cache_err = float((st_g["cache"]["k"].cpu() - st_c["cache"]["k"]).abs()
                      .max())
    if max(errs) > LM_F32_ATOL or not all(np.isfinite(errs)):
        raise AssertionError(f"swa fp32 card vs CPU: logits errs {errs}")
    out["card_vs_cpu_fp32"] = {"logits_max_abs_err": errs,
                               "cache_k_max_abs_err": cache_err,
                               "atol": LM_F32_ATOL,
                               "seconds": time.perf_counter() - t1}
    log(f"check swa fp32 card vs CPU ({LM_F32_PROMPT[0]} x "
        f"{LM_F32_PROMPT[1]} prompt tokens + {LM_F32_DECODE} decode steps): "
        f"logits max abs err per call {errs} (atol {LM_F32_ATOL}); cache k "
        f"{cache_err!r}")
    del p_cpu, st_g, st_c
    checked("card_vs_cpu_fp32 (with the fp32 init)")
    # --- check: prefill then decode across the ring's wrap vs one forward ---
    n = SWA_F32_PREFILL + SWA_F32_DECODE
    seq = _prompt_tokens(rng, cfg, 1, n)
    x_k, _, _ = TM.forward(cfg32, p_gpu, seq, mode="train", unembed_out=False)
    full = TM.lm_head(cfg32, p_gpu, x_k[:, SWA_F32_PREFILL - 1:])
    lg_pre, st = TM.prefill(cfg32, p_gpu, seq[:, :SWA_F32_PREFILL],
                            cache_len=n)
    dec_err = float((lg_pre[:, -1] - full[:, 0]).abs().max())
    for i in range(SWA_F32_DECODE):           # full[:, i + 1]: position p_i
        p_i = SWA_F32_PREFILL + i
        lg, st = TM.decode_step(cfg32, p_gpu, seq[:, p_i:p_i + 1], st,
                                torch.tensor([p_i], device="cuda"))
        dec_err = max(dec_err, float((lg[:, 0] - full[:, i + 1]).abs().max()))
    if not dec_err <= LM_F32_ATOL:
        raise AssertionError(f"swa fp32 prefill + decode vs forward: {dec_err}")
    out["decode_vs_forward_fp32"] = {
        "prefill": SWA_F32_PREFILL, "decode": SWA_F32_DECODE,
        "window": SWA_WINDOW, "logits_max_abs_err": dec_err,
        "atol": LM_F32_ATOL}
    log(f"check swa fp32 prefill {SWA_F32_PREFILL} + {SWA_F32_DECODE} decode "
        f"steps (the ring of {SWA_WINDOW} wrapped) vs one forward over {n} "
        f"tokens: logits max abs err {dec_err!r} (atol {LM_F32_ATOL})")
    del st, lg_pre
    checked("decode_vs_forward_fp32")
    # --- check: the kernel against the plain attention in the model ---
    x_p, _, _ = TM.forward(cfg32, p_gpu, seq, mode="train", unembed_out=False,
                           swa_impl=sw.swa_attention_plain)
    err, sure_eq, n_sure, n_pos = 0.0, 0, 0, 0
    for r0 in range(0, n, 512):
        lk = TM.lm_head(cfg32, p_gpu, x_k[:, r0:r0 + 512])
        lp = TM.lm_head(cfg32, p_gpu, x_p[:, r0:r0 + 512])
        err = max(err, float((lk - lp).abs().max()))
        tk, _ = _margins(lk)
        tp, mp = _margins(lp)
        sure = mp > 2 * LM_F32_ATOL
        sure_eq += int((tk == tp)[sure].sum())
        n_sure += int(sure.sum())
        n_pos += tk.numel()
    if not err <= LM_F32_ATOL or sure_eq != n_sure:
        raise AssertionError(f"swa kernel vs plain attention (fp32 model): "
                             f"logits err {err!r}, greedy tokens equal at "
                             f"{sure_eq} of {n_sure} clear positions")
    out["kernel_vs_plain_model_fp32"] = {
        "tokens": n, "logits_max_abs_err": err, "atol": LM_F32_ATOL,
        "positions": n_pos, "clear_positions_equal": sure_eq}
    log(f"check swa kernel vs plain attention (fp32 model, {n} tokens, every "
        f"position): logits max abs err {err!r} (atol {LM_F32_ATOL}); greedy "
        f"tokens equal at all {n_sure} positions whose margin exceeds "
        f"{2 * LM_F32_ATOL}")
    del x_k, x_p, full
    checked("kernel_vs_plain_fp32")
    # --- the same requests through the loop in fp32: equal outright ---
    loop32 = launch.ServingLoop(cfg32, p_gpu, n_slots=LM_SLOTS,
                                max_seq=SWA_MAX_SEQ)
    got32 = {c.rid: c.tokens for c in loop32.run(reqs)}
    del loop32
    chk = loop_vs_teacher_forced(TM, cfg32, p_gpu, reqs, got32)
    out["loop_vs_single_request_fp32"] = chk
    same = sum(got32[r.rid] == got[r.rid] for r in reqs)
    log(f"check swa ServingLoop fp32: all {LM_REQUESTS} completions "
        f"({chk['positions']} tokens) equal single-request greedy decoding on "
        f"the card (logits of one B = 1 forward per request over its prompt "
        f"and the loop's tokens); smallest top-2 margin "
        f"{chk['min_top2_margin']!r}; {same} of {LM_REQUESTS} equal the bf16 "
        f"loop's")
    checked("loop_fp32")
    log(f"phase swa serving: seconds by check {out['check_seconds']}")
    del p_gpu
    torch.cuda.empty_cache()
    return out


def _sdpa_args(q, k, v, window) -> tuple:
    """(B, H, S, D) views of q and of K/V repeated to the query heads (the
    TPU kernel's inputs; the repeat is made here, outside any timed call),
    and ``is_causal`` where the window does not bite, else a boolean band
    mask, over which SDPA computes all S^2 pairs."""
    from repro_torch.models.attention import _repeat_kv
    qt = q.transpose(1, 2)
    kt, vt = (_repeat_kv(t, q.shape[2]).transpose(1, 2) for t in (k, v))
    s = q.shape[1]
    if window is None or s <= window:
        return qt, kt, vt, {"is_causal": True}
    i = torch.arange(s, device=q.device)
    return qt, kt, vt, {"attn_mask": (i[None, :] <= i[:, None])
                        & (i[None, :] > i[:, None] - window)}


def sdpa_fn(q, k, v, window, backend=None):
    """The library yardstick: one ``scaled_dot_product_attention`` call on
    the inputs of ``_sdpa_args``; ``backend`` (an ``SDPBackend`` name)
    restricts it to that backend."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt, kw = _sdpa_args(q, k, v, window)
    if backend is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)

    def call():
        with sdpa_kernel([getattr(SDPBackend, backend)]):
            return F.scaled_dot_product_attention(qt, kt, vt, **kw)
    return call


def sdpa_backend_of(q, k, v, window) -> str:
    """The backend the default SDPA call picks, as PyTorch's own dispatcher
    (``torch._fused_sdp_choice``) chooses it."""
    from torch.nn.attention import SDPBackend
    qt, kt, vt, kw = _sdpa_args(q, k, v, window)
    return SDPBackend(torch._fused_sdp_choice(
        qt, kt, vt, kw.get("attn_mask"), 0.0, kw.get("is_causal", False))).name


def sdpa_backends(q, k, v, got, cyc, flush, n_ev) -> dict:
    """Each SDPA backend of ``SDPA_BACKENDS`` on these inputs: refused (and
    why), or its device time by CUDA events, L2 flushed, and its largest
    difference from the kernel's output ``got``."""
    import warnings
    out = {}
    for backend in SDPA_BACKENDS:
        fn = sdpa_fn(q, k, v, SWA_WINDOW, backend)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                o = fn()
                torch.cuda.synchronize()
            except RuntimeError as e:
                out[backend] = {"accepted": False,
                                "why": str(e).strip().splitlines()[0][:160]}
                continue
            out[backend] = {
                "accepted": True,
                "max_abs_diff": float((o.transpose(1, 2).float()
                                       - got.float()).abs().max()),
                "ms": device_ms(fn, cyc, flush, n_ev)[0]}
        del o
    return out


def swa_times(sw, swa, card) -> dict:
    """Phase 14: swa_attention in bf16 at the prefill shapes (8 x 512 and
    1 x 8192) and at 1 x 16384, W = 4096: L2 flushed and warm, by CUDA
    events and CUPTI, beside its bound (and the SFU's limit), the plain
    version's time (one call, CUDA events) and SDPA's: the default call by
    CUDA events (the kernels line's ``library_ms``) and by CUPTI, which
    backend it picks, and each backend that accepts the call by CUDA events.
    The long shapes take 25 event-timed and 10 CUPTI calls (each call is
    milliseconds), the short one the defaults; the kernel's CUPTI time
    counts its own records (``SWA_KERNEL``), and each CUPTI measurement may
    take up to ``CUPTI_WINDOWS`` windows (the tracer lost up to four windows
    in a row at these shapes)."""
    cyc = sleep_cycles_per_ms()
    flush = l2_flusher()
    rows = {}
    for b, t in SWA_PREFILL + (SWA_LONG,):
        n_ev, n_cu = ((TIMED_LAUNCHES, CUPTI_CALLS) if b * t <= 4096
                      else (CHUNK, 10))
        q, k, v = swa_inputs(b, t, t, 32, 8, 120, torch.bfloat16, SEED + 14)
        kern = lambda: sw.swa_attention_cuda(q, k, v, window=SWA_WINDOW)
        lib = sdpa_fn(q, k, v, SWA_WINDOW)
        got = kern()
        err = float((lib().transpose(1, 2).float() - got.float()).abs()
                    .max())
        bnd = swa_bound(b, t, t, 32, 8, 120, SWA_WINDOW, True)
        backend = sdpa_backend_of(q, k, v, SWA_WINDOW)
        rec = {"shape": [b, t, 32, 8, 120], "window": SWA_WINDOW,
               "dtype": "bfloat16",
               "cupti_ms": cupti_ms(kern, flush, SWA_KERNEL, n_cu),
               "warm_l2_cupti_ms": cupti_ms(kern, None, SWA_KERNEL, n_cu),
               "library_ms": device_ms(lib, cyc, flush, n_ev)[0],
               "library_cupti_ms": cupti_ms(lib, flush, None, n_cu),
               "library_backend": backend,
               "library_pairs": "all S^2 (band mask)" if t > SWA_WINDOW
               else "causal half",
               "library_backends": sdpa_backends(q, k, v, got, cyc, flush,
                                                 n_ev),
               "ms": device_ms(kern, cyc, flush, n_ev)[0],
               "warm_l2_ms": device_ms(kern, cyc, None, n_ev)[0],
               "library_vs_kernel_max_abs_diff": err, **bnd}
        rec["share_of_bound"] = bnd["bound_ms"] / rec["ms"]
        if t <= SWA_PREFILL[1][1]:
            plain = lambda: sw.swa_attention_plain(q, k, v, window=SWA_WINDOW)
            rec["plain_ms"] = events_ms(plain, 1)
        else:
            rec["plain_ms"] = None
        rows[f"swa_attention/{b}x{t}"] = rec
        lim = bnd["limits_ms"]
        log(f"time swa_attention shape=({b}, {t}, 32/8, 120) bf16 W="
            f"{SWA_WINDOW} L2 flushed: kernel_ms={rec['ms']!r} (cupti "
            f"{rec['cupti_ms']!r}; L2-warm {rec['warm_l2_ms']!r}, cupti "
            f"{rec['warm_l2_cupti_ms']!r}) plain_ms={rec['plain_ms']!r} "
            f"bound_ms={bnd['bound_ms']!r} ({bnd['bound_by']}; "
            f"{bnd['bound_peak']}; share reached {rec['share_of_bound']!r}) "
            f"card=\"{card}\"")
        log(f"time swa_attention ({b}, {t}) limits ms: bytes "
            f"{lim['bytes']!r}, tensor-core FLOP {lim['operations']!r} "
            f"({bnd['flops']} FLOP, p_hi + p_lo), SFU exp {lim['sfu_exp']!r} "
            f"({bnd['pairs']} pairs): the largest is {bnd['largest_limit']}; "
            f"bound if p were one bf16 {bnd['bound_single_bf16_p_ms']!r}")
        log(f"time swa_attention ({b}, {t}) SDPA default: {backend} "
            f"({rec['library_pairs']} pairs) events {rec['library_ms']!r} ms, "
            f"cupti {rec['library_cupti_ms']!r} ms, max |SDPA - kernel| "
            f"{err!r}; by backend: " + "; ".join(
                f"{k_}: {v_['ms']!r} ms (diff {v_['max_abs_diff']!r})"
                if v_["accepted"] else f"{k_}: refused ({v_['why']})"
                for k_, v_ in rec["library_backends"].items()))
        del q, k, v, got
        torch.cuda.empty_cache()
    long_ratio = (rows[f"swa_attention/{SWA_LONG[0]}x{SWA_LONG[1]}"]["ms"]
                  / rows["swa_attention/1x8192"]["ms"])
    rows["ratio_16384_over_8192"] = long_ratio
    log(f"time swa_attention: (1, 16384) / (1, 8192) = {long_ratio!r} "
        f"(O(S * W) work: {swa_pairs(1, 16384, 16384, 1, SWA_WINDOW, True) / swa_pairs(1, 8192, 8192, 1, SWA_WINDOW, True)!r}; "
        f"O(S^2) would be 4)")
    rows["launches_per_request"] = {
        "single_request": swa["launches_per_prefill_call"],
        "loop_mean": swa["loop"]["launches"] / swa["loop"]["requests"]}
    return rows


def profile_swa(TC, TM, launch, card) -> dict:
    """Two ``torch.profiler`` windows of h2o-danube-3-4b at full width,
    bf16: one 1 x 8192 prefill call (device idle share, the swa_attention
    kernel's and the matrix products' share of the busy time) and 16
    decode steps at B = 8 after a 512-token prefill (idle share, the matrix
    products' share, the top device ops)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = TC.get_arch(SWA_ARCH)
    params = TM.init_params(cfg, seed=SEED, device="cuda")
    prefill_step = launch.make_prefill_step(cfg)
    toks = _prompt_tokens(np.random.default_rng(SEED + 51), cfg,
                          *SWA_PREFILL[1])
    prefill_step(params, {"tokens": toks})
    torch.cuda.synchronize()
    for window in range(1, CUPTI_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prefill_step(params, {"tokens": toks})
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev = _device_ops(prof)
        n_swa = sum(c for k, (c, _) in dev.items() if SWA_KERNEL in k)
        if n_swa == cfg.n_layers:
            break
        log(f"profile window {window} of {CUPTI_WINDOWS} lost: {n_swa} "
            f"records of {SWA_KERNEL}, expected {cfg.n_layers}")
    else:
        raise AssertionError("every profiled prefill window was lost")
    busy = sum(t for _, t in dev.values())
    swa_us = sum(t for k, (_, t) in dev.items() if SWA_KERNEL in k)
    mm = _matmul_us(dev)
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:10]
    pre = {"shape": list(SWA_PREFILL[1]), "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy / 1e3,
           "device_idle_share": 1.0 - busy / wall_us,
           "swa_attention_ms": swa_us / 1e3, "swa_attention_launches": n_swa,
           "matmul_ms": mm / 1e3,
           "swa_share_of_busy": swa_us / busy if busy else None,
           "matmul_share_of_busy": mm / busy if busy else None,
           "top_device_ops": {k: {"count": c, "device_ms": t / 1e3}
                              for k, (c, t) in top}}
    log(f"profile swa prefill 1 x {SWA_PREFILL[1][1]}: wall_ms="
        f"{pre['wall_ms']!r} device_busy_ms={pre['device_busy_ms']!r} "
        f"device_idle_share={pre['device_idle_share']!r} swa_attention_ms="
        f"{pre['swa_attention_ms']!r} ({n_swa} launches) matmul_ms="
        f"{pre['matmul_ms']!r} (shares of busy {pre['swa_share_of_busy']!r} / "
        f"{pre['matmul_share_of_busy']!r}) card=\"{card}\"")
    del toks

    b, t, steps = SWA_PREFILL[0][0], SWA_PREFILL[0][1], 16
    dev, wall_us = decode_window(launch, cfg, params, b, t, steps, SEED + 52)
    busy = sum(t_ for _, t_ in dev.values())
    if busy <= 0:
        raise AssertionError("the profiled decode window has no device time")
    mm = _matmul_us(dev)
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:12]
    dec = {"steps": steps, "batch": b, "prompt": t, "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy / 1e3,
           "device_idle_share": 1.0 - busy / wall_us,
           "host_ms_per_step": wall_us / steps / 1e3,
           "device_kernels_per_step": sum(c for c, _ in dev.values()) / steps,
           "matmul_ms": mm / 1e3, "matmul_share_of_busy": mm / busy,
           "top_device_ops": {k: {"count": c, "device_ms": t_ / 1e3}
                              for k, (c, t_) in top}}
    log(f"profile swa decode B={b} x {steps} steps after {t} tokens: wall_ms="
        f"{dec['wall_ms']!r} device_busy_ms={dec['device_busy_ms']!r} "
        f"device_idle_share={dec['device_idle_share']!r} matmul_ms="
        f"{dec['matmul_ms']!r} (share of busy {dec['matmul_share_of_busy']!r}"
        f"); {dec['device_kernels_per_step']!r} device kernels per step; top: "
        + ", ".join(f"{k[:48]} {v['device_ms']!r} ms x {v['count']}"
                    for k, v in list(dec["top_device_ops"].items())[:5])
        + f" card=\"{card}\"")
    del params
    torch.cuda.empty_cache()
    return {"prefill": pre, "decode": dec}


def hgmma_count(_build) -> int:
    """``HGMMA`` instructions (wgmma on the tensor cores) in the built
    library's bf16 swa_attention kernels, by ``cuobjdump -sass``."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build.build_info["library"]],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = SWA_KERNEL in line
        elif inside and "HGMMA" in line:
            count += 1
    return count


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch.rl as rl
    from repro_torch import comm, core, optim, serve
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels import consensus_gather as cg
    from repro_torch.kernels import consensus_step as cs
    from repro_torch.kernels import decay_accum as dacc
    from repro_torch.kernels import flat_update as fu
    from repro_torch.kernels import policy_infer as pinf
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.kernels import topk_scatter as tks
    from repro_torch.kernels import wkv6 as wk
    from repro_torch import configs as TC
    from repro_torch import launch
    from repro_torch import models as TM
    from repro_torch.rl import policy

    km = types.SimpleNamespace(dacc=dacc, fu=fu, cs=cs, cg=cg, tks=tks)

    t_start = time.perf_counter()
    phase_s, t_lap = {}, [t_start]

    def lap(name):
        """Seconds since the previous phase ended, under ``name``."""
        now = time.perf_counter()
        phase_s[name] = now - t_lap[0]
        t_lap[0] = now

    # 1. device
    card = card_line()
    nvcc = _build.nvcc_path()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True, timeout=60).stdout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase device: {card}; torch {torch.__version__}; CUDA "
        f"{torch.version.cuda}; python {sys.version.split()[0]}")
    log(f"phase device: nvcc {nvcc}: {nvcc_ver.strip().splitlines()[-1]}")
    log(f"phase device: matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    lap("1-2 device_and_build")
    log(f"phase build: {build_s!r} s, {_build.build_info.get('sources')} -> "
        f"{_build.build_info['library']} (nvcc runs: {_build.n_builds}; "
        f"flags {_build.build_info.get('flags')})")
    for line in str(_build.build_info.get("log", "")).splitlines():
        if ("ptxas info" in line and "Used" in line) or "(C75" in line or (
                "spill" in line and " 0 bytes spill stores" not in line):
            log(f"phase build: {line.strip()}")
    n_hgmma = hgmma_count(_build)
    log(f"phase build: {n_hgmma} HGMMA instructions in {SWA_KERNEL} "
        f"(cuobjdump -sass)")
    if n_hgmma == 0:
        raise AssertionError(f"{SWA_KERNEL} issues no wgmma")

    # 3. kernel vs plain
    parity = kernel_vs_plain(pinf)
    lap('3 kernel_vs_plain')

    # 4. the serving path
    serving = serving_path(pinf, _build, serve, policy, card)
    lap('4 serving')

    # 5. times
    rows = times(pinf, serving, card)
    prof = profile_serving(serve, card)
    lap('5 times')

    # 6. flat kernels vs plain
    flat = flat_kernels_vs_plain(dacc, fu, dispatch)
    lap('6 flat_kernel_vs_plain')

    # 6b. gossip and compression kernels vs plain
    gossip = gossip_kernels_vs_plain(km, core, comm)
    lap('6b gossip_kernel_vs_plain')

    # 7. the training path (slice 2)
    training = training_path(km, _build, rl, core, optim, comm, serve, card)
    lap('7 training')

    # 7b. the consensus and compression path (slice 3)
    consensus = consensus_path(km, _build, rl, core, optim, comm, card)
    lap('7b consensus')

    # 8. kernel times, a profiled training window
    flat_rows = flat_times(dacc, fu, dispatch, training, card)
    gossip_rows = gossip_times(km, core, comm, consensus, card)
    train_prof = profile_training(rl, core, optim, card)
    lap('8 times')

    # 9. the wkv6 kernel vs plain (slice 4)
    wkv = wkv6_vs_plain(wk)
    lap('9 wkv6_vs_plain')

    # 10. the language-model serving path (slice 4)
    lm = lm_serving_path(wk, _build, TC, TM, launch, card)
    lap('10 lm_serving')

    # 11. wkv6 times, a profiled decode window
    lm_rows = lm_times(wk, lm, card)
    lm_prof = profile_decode(TC, TM, launch, card)
    lap('11 lm_times')

    # 12. the swa_attention kernel vs plain (slice 5)
    swa_parity = swa_vs_plain(sw)
    lap('12 swa_vs_plain')

    # 13. sliding-window attention serving (slice 5)
    swa = swa_serving_path(sw, _build, TC, TM, launch, card)
    lap('13 swa_serving')

    # 14. swa_attention times, a profiled prefill
    swa_rows = swa_times(sw, swa, card)
    swa_prof = profile_swa(TC, TM, launch, card)
    lap('14 swa_times')

    # 15. the sweep path (slice 10): batched kernels, run_sweep on the card
    from repro_torch import sweep
    sweep_parity = sweep_kernels_vs_loop(km, core, comm, dispatch)
    sweeps = sweep_path(km, rl, core, optim, comm, sweep, card)
    sweep_rows = sweep_kernel_times(km, core, comm, card)
    lap('15 sweep')

    top = rows["mean/1024"]
    kernels = [{
        "name": "policy_infer",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/policy_infer.cu",
        "replaces": "src/repro/kernels/policy_infer.py:61",
        "launches": serving["launches"],
        "max_abs_err": parity["max_abs_err"]["float32"],
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "shape": {"batch": 1024, "obs_dim": OBS_DIM, "hidden": HIDDEN,
                  "act_dim": ACT_DIM, "mode": "mean"},
    }]
    sources = {"decay_accum": ("decay_accum.cu", "decay_accum.py:27"),
               "row_mean": ("flat_update.cu", "flat_update.py:41"),
               "momentum_update": ("flat_update.cu", "flat_update.py:79"),
               "adam_update": ("flat_update.cu", "flat_update.py:158")}
    m0, n0 = TIMED_SHAPES[0]
    for name, (src, tpu) in sources.items():
        r = flat_rows[f"{name}/{m0}x{n0}"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": training["launches"][name],
            "max_abs_err": flat["max_abs_err"][name]["float32"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": {"m": m0, "n": n0, "dtype": "float32"},
        })
    sources = {"consensus_step": "consensus_step.py:36",
               "consensus_gather": "consensus_gather.py:51",
               "topk_scatter": "topk_scatter.py:37"}
    for name, tpu in sources.items():
        r = gossip_rows[f"{name}/{m0}x{n0}"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": consensus["launches"][name],
            "max_abs_err": gossip["max_abs_err"][name]["float32"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": {"m": m0, "n": n0, "dtype": "float32",
                      "k_max": r["k_max"]},
        })
    r = lm_rows[f"wkv6/{LM_PREFILL[0][0]}x{LM_PREFILL[0][1]}"]
    kernels.append({
        "name": "wkv6",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6.py:56",
        "launches": lm["launches"],
        "max_abs_err": wkv["max_abs_err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": None,
        "shape": {"B": LM_PREFILL[0][0], "T": LM_PREFILL[0][1], "H": 32,
                  "D": 64, "dtype": "float32"},
    })
    b1, t1 = SWA_PREFILL[1]
    r = swa_rows[f"swa_attention/{b1}x{t1}"]
    timed = [c for c in swa_parity["cases"]
             if c["shape"] == [b1, t1, t1, 32, 8, 120]
             and c["window"] == SWA_WINDOW and c["dtype"] == "bfloat16"][0]
    kernels.append({
        "name": "swa_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/swa_attention.cu",
        "replaces": "src/repro/kernels/swa_attention.py:80",
        "launches": swa["launches"],
        "max_abs_err": timed["err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "library_backend": r["library_backend"],
        "shape": {"B": b1, "S": t1, "H": 32, "KV": 8, "D": 120,
                  "window": SWA_WINDOW, "dtype": "bfloat16"},
        "max_abs_err_all_cases": {k: swa_parity["worst"][k]
                                  for k in ("float32", "bfloat16")},
        "mean_abs_err": {k: timed[k] for k in (
            "mean_err", "plain_mean_err", "one_bf16_p_mean_err")},
    })
    s0, m0_, n0_ = SWEEP_KERNEL_SHAPES[0]
    for k in kernels:
        if k["name"] not in TRAIN_KERNELS:
            continue
        r = sweep_rows[f"{k['name']}/{s0}x{m0_}x{n0_}"]
        k["batched"] = {
            "form": "(S, m, n), one launch", "shape": [s0, m0_, n0_],
            "dtype": "float32", "ms": r["ms"], "loop_ms": r["loop_ms"],
            "cupti_ms": r["cupti_ms"], "loop_cupti_ms": r["loop_cupti_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "sweep_launches": sweeps["launches"][k["name"]],
            "max_abs_err_vs_plain": sweep_parity["max_abs_err"][k["name"]]}
    if len(kernels) != 10 or any(k["launches"] < 1 for k in kernels):
        raise AssertionError(f"kernels line: {len(kernels)} kernels, "
                             f"launches {[k['launches'] for k in kernels]}")
    with open(os.path.join(ROOT, "build", "chip_smoke", "result.json"),
              "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "nvcc": nvcc_ver,
                   "build_seconds": build_s, "build": _build.build_info,
                   "parity": parity, "serving": serving, "times": rows,
                   "profile": prof, "flat_parity": flat,
                   "training": training, "flat_times": flat_rows,
                   "gossip_parity": gossip, "consensus_training": consensus,
                   "gossip_times": gossip_rows,
                   "training_profile": train_prof,
                   "wkv6_parity": wkv, "lm_serving": lm, "lm_times": lm_rows,
                   "lm_decode_profile": lm_prof,
                   "swa_parity": swa_parity, "swa_serving": swa,
                   "swa_times": swa_rows, "swa_profile": swa_prof,
                   "swa_hgmma": n_hgmma,
                   "sweep_parity": sweep_parity, "sweeps": sweeps,
                   "sweep_times": sweep_rows,
                   "kernels": kernels, "phase_seconds": phase_s,
                   "seconds": time.perf_counter() - t_start}, f, indent=1,
                  default=str)
    log(f"chip_smoke: all phases ok in {time.perf_counter() - t_start!r} s; "
        f"seconds by phase {phase_s}")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
