#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, consensus, sweep, async,
task-generic FMARL, language-model serving (RWKV6, sliding-window
attention, head 256 and the whisper encoder-decoder) and federated LM
training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the repository root on a machine with a CUDA card, PyTorch built
for CUDA and ``nvcc``; it imports ``repro_torch`` from ``src/`` and nothing of
JAX or the JAX package. Phases, each of which fails the run when it fails:

1. device — the card, its power limit, torch / CUDA / nvcc versions; TF32
   off for the plain reference's fp32 matmuls;
2. build — every kernel of ``src/repro_torch/kernels/csrc`` with ``nvcc``;
   the bf16 attention kernels (forward, its D = 64 instantiation on its
   own, and the backward's dq and dk / dv kernels) must hold ``HGMMA``
   instructions;
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
   m in {64, 1024, 10000} agents with B = 1 (m = 10000 with SGD only; m = 64
   also with B = 4 and 2 PPO
   epochs of 2 minibatches) and one run with bf16 buffers, each seeded and
   drawing on the card (these give updates/sec per m). The m = 7
   configurations, the m = 64 ones with SGD and the bf16 run run again on
   draws made on the host, on the card and on the CPU, which must agree
   (the CPU runs of phases 7 and 7b go to a pool of spawned processes from
   phase 6 on, beside the card runs; each run's laps are logged); every
   kernel's launches must equal the count
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
   card, the m = 7 ones (the 3-4 topology) and the m = 64 ones again on
   host-made draws on the card and on the CPU, launches held to the loop's
   count (consensus_step once per
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
   fourth completion token by token against single-request greedy decoding
   on the card (bf16: prefill and decode_step at B = 1 fed the loop's tokens, each
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
   step, no build. Checks: every fourth completion (bf16, request 0
   included) and every fp32 one against single-request greedy decoding on
   the card (bf16 with counted near-ties; fp32 outright); an
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
   lambda grid (3 x 1 seed), Fig. 6's eps grid (3 x 1, dense and sparse),
   Fig. 4's taus grid (4 x 1), an eta x momentum / Adam grid (2 x 1) and a
   top-k uplink point (2 seeds), m = 7, T 150, P 25, 2 epochs: each against
   ``run_sweep_loop`` (bitwise or within rtol / atol 1e-4, stated), its
   first 4 runs against the CPU on the same draws (1e-4), launches S times
   fewer than the loop's, runs/s of both forms; and each batched kernel's
   time (events and CUPTI, L2 flushed) against its loop of S launches,
   beside the bound of the S runs' work;
16. async (slice 11) — ``repro_torch.core.async_fed``: the masked server
   step (``scale_rows`` = ``decay_accum``, then ``row_mean``) on the card at
   (7, 9347), (1024, 9347) and (12, 7, 9347) with all, none, part of the
   rows arriving and fractional staleness weights, against the plain
   scaling with the card's row_mean (bitwise) and the CPU (row_mean's rule
   plus the scaling's rounding); a zero-delay async run against the
   periodic run on the card, bitwise; a geometric(0.5) run with staleness
   weights on the card against the CPU on the same draws (rtol / atol 1e-4,
   ledger and bytes exact); the ``delay`` axis (4 points x 3 seeds) and the
   ``k`` axis (3 buffer sizes x 4 seeds; 1 epoch, tau = 2) through
   ``run_sweep`` on the card,
   bitwise against ``run_sweep_loop``, their first 4 runs against the CPU,
   launches S times fewer than the loop's, runs/s of both forms;
17. fmarl (slice 12) — ``repro_torch.core.run_fmarl(device="cuda")``, the
   task-generic Algorithm 1 / 2 driver: ``examples/torch_quickstart.py``'s
   five strategies (m = 7, tau = 8, 320 steps on the noisy quadratic of a
   16 x 16 leaf) on one host-drawn noise table, card against CPU (per-period
   metrics rtol 1e-4, server parameters atol 1e-4, ledgers equal), and the
   example itself on the card; the full-width run, every agent a tree laid
   out like the 6-64-64 actor-critic (n = 9,347) at m = 1024, tau = 2, 3
   periods: periodic, decay, dense and sparse consensus (E = 2, k-NN ring),
   momentum, Adam and a top-k uplink, each timed on the card (steps/s) and
   held against the CPU on the same draws; launches held to the count the
   loop implies (rows 1-7 of the kernel table); one profiled window at
   m = 1024 (momentum; device idle share, time by ``fmarl.*`` range); and
   ``HierarchicalStrategy.server_average`` at (1024, 9347): the cluster mean
   one ``consensus_step`` launch and the global mean one ``row_mean``
   launch, each against the plain version and float64. Alone:
   ``python3 -c 'import chip_smoke as c; c.fmarl_alone()'``.

18. lm train (slice 13) — federated LM training,
   ``repro_torch.launch.train.train(device="cuda")``: first the forward's
   log-sum-exp and the hand-written ``swa_attention_bwd`` kernel against
   their plain versions (S in {1, 127, 1024, 4608} x W in {None, 1, 64,
   4096} x 32 / 8 heads of 120 and 24 / 8 of 128, fp32 and bf16, the main
   path's (2, 1024) and the bf16 kernels' tile edges, ``BWD_EDGE_CASES``:
   S 65-255, W 100 / 200, H = KV; fp32 within 1e-5 of the largest |gradient|, bf16
   against the float64 gradient within 2x / 1.1x the plain version's
   largest / mean error, a second launch bitwise); then the main path,
   h2o-danube-3-4b at its published width cut to 2 of 24 layers
   (555,436,800 bf16 parameters an agent), 2 agents x 2 x 1024 tokens,
   6 steps of sync (tau 1), periodic, decay (lambda 0.98), consensus (eps
   0.4) and periodic with outer momentum 0.9 (tau 2): losses finite and
   falling, agent rows bitwise equal after each sync, launches of
   swa_attention, swa_attention_bwd, adam_update, row_mean and
   consensus_step exactly ``_lmtrain_expected``, tokens/s of a local
   step; one windowed step at 1 x 4608 (W 4096 binds) with the kernels
   against the plain attention; a mid-size fp32 config card vs CPU on
   every strategy (one period each, one layer); the backward's time beside
   its bound, the plain
   version's and SDPA's backward (alone: ``c.bwd_alone()``), one profiled
   window of a period, and ``row_mean`` / ``adam_update`` at the phase's
   (2, 555,436,800) bf16 rows beside ``x.mean(0)`` / ``torch._fused_adamw_``.
   Alone: ``python3 -c 'import chip_smoke as c; c.lm_train_alone()'``.
19. head 256 (slice 15) — the ``swa_attention`` kernels at D = 256 against
   their plain version (fp32 and bf16, Sq = Sk in {1, 63, 64, 65, 127, 128,
   129, 200}, W in {None, 2048, 40}, 1 and 16 KV heads of 16 query heads,
   phase 12's rules, each call repeated bitwise, the lse at two shapes);
   then gemma-7b (7 of its 28 global ``attn`` layers, 16 / 16 heads of
   256, 2.72 B parameters) and recurrentgemma-9b (14 of its 38 layers of
   ``(rglru, rglru, local)``, MQA 16 / 1 heads of 256, W 2048, 4.14 B
   parameters) at full width (the depth cut when phase 23 came), seeded
   bf16 weights, each freed before the next is
   drawn: ``make_prefill_step`` at 8 x 512 and 1 x 8192,
   ``make_serve_step`` for 16 tokens at B = 8, an 8-slot ``ServingLoop``
   over 16 requests of 16-512 prompt and 16-32 new tokens
   (recurrentgemma-9b's request 0 of 2,100 tokens wraps its ring),
   launches counted (one per attention layer per prefill call and
   admission, none per decode step); every fourth completion against
   single-request greedy decoding (bf16 near-ties counted), an admission
   against the other slots' rows of every state leaf (K/V, positions, the
   RG-LRU ``h`` and conv inputs), the kernel against the plain version on
   the first attention layer's q, k, v at both prefill shapes, a profiled
   1 x 8192 prefill (the kernel's and, for recurrentgemma-9b, the RG-LRU
   scan's share of the busy time); phi4-mini-3.8b at full size (a prefill
   at 8 x 512 and an 8-request ``ServingLoop`` held to single-request
   greedy decoding with ``prefill(cache_len=)``); the D = 256 kernel's
   times at the three prefill calls beside its bound, the plain version's
   and SDPA's. Alone: ``python3 -c 'import chip_smoke as c;
   c.head256_alone()'``.
20. train (slice 16) — LM training for every family the port serves:
   first the D = 256 ``swa_attention_bwd`` kernels against their plain
   version on phase 19's grid (fp32 and bf16, Sq in {1, 63, 64, 65, 127,
   128, 129, 200} x W in {None, 2048, 40} x 1 and 16 KV heads of 16; phase
   18's rule, a second launch bitwise, and in bf16 the control with p and
   ds rounded once to bf16, which must break the mean rule) and the
   hand-written ``wkv6_bwd`` against ``wkv6_bwd_plain`` (T on and off its
   16-step chunks, nonzero initial state and final-state gradient, (2,
   1024, 32, 64); within 1e-5 of each gradient's largest |value|, a second
   call bitwise); then gemma-7b (2 of 28 layers), recurrentgemma-9b (3 of
   38: one ``(rglru, rglru, local)`` cycle) and rwkv6-1.6b (all 24) at
   their published width through ``train`` (A 2 x B 2 x S 1024, periodic
   tau 2) and one more period through ``make_local_step`` /
   ``make_sync_step``: launches of swa_attention, swa_attention_bwd,
   wkv6, wkv6_bwd, adam_update and row_mean exactly ``_train_expected``,
   rows bitwise equal after each sync, tokens/s of a local step, sync ms,
   the period's peak device memory, one profiled local step (matmuls,
   attention and wkv6 forward and backward, Adam, the rest), and agent 0's
   loss and gradient with the kernels against the plain attention and
   recurrence (phase 18's rule); the kernels' times at the models' shapes
   beside their bounds, the plain versions' and SDPA's backward, and the
   plain RG-LRU scan's forward and backward. Alone: ``python3 -c 'import
   chip_smoke as c; c.train_alone()'`` (``c.train_kernels_alone()``: the
   two kernel checks only).
21. whisper (slice 18) — the ``swa_attention`` kernels at D = 64 against
   their plain version (fp32 and bf16, phase 12's rules with the bf16
   control required everywhere): the encoder's (8, 1500, 1500, 12 / 12)
   with causal off, the cross-attention's Sq in {1, 4, 227} against
   Sk = 1500, causal Sq = Sk in {4, 227, 448}, the 129 / 255 tile edges
   both ways with causal on and off, B = 3 with H / KV = 4 and 1; then
   whisper-small at full size (12 encoder and 12 decoder layers, d 768, 12
   heads of 64, 238,270,464 seeded bf16 parameters, 1,500 random frame
   embeddings a request) through ``make_prefill_step`` at 8 x 4 and
   1 x 227, the model-level prefill sized for the decode and 64 steps of
   ``make_serve_step`` at B = 8: prefill tokens/s and frames/s, decode
   tokens/s, launches exactly 36 a prefill call and 12 a decode step, no
   build; the encoder's frames/s alone; every fourth row's 65 tokens
   against single-request greedy decoding (bf16 near-ties counted); a
   profiled prefill and 16 profiled decode steps (idle share, the kernel's
   and the matmuls' device time, the decode self-attention block by
   events); in fp32 the card against the CPU (2 x 16 tokens, 4 decode
   steps), the kernel against the plain attention in the model and a
   prefill plus 8 decode steps against one forward (atol 1e-3); a D = 64
   backward on the card refused before any launch; the kernel's times at
   the encoder's, a decode step's and the 227-token prompt's
   cross-attention beside its bound, the plain version's and SDPA's, and
   fp32 kernels at D = 64, 120 and 256 beside SDPA's efficient backend.
   Alone: ``python3 -c 'import chip_smoke as c; c.whisper_alone()'``.
22. whisper train (slice 19) — the D = 64 backward against its plain
   version, whisper-small and the lm-100m example trained at full size,
   the kernels' times. Alone: ``python3 -c 'import chip_smoke as c;
   c.whisper_train_alone()'``.
23. moe (slice 20) — kimi-k2-1t-a32b (its dense first layer and one MoE
   layer of 384 experts top-8 and a shared expert, 19,967,675,392
   parameters) and arctic-480b (2 MoE layers of 128 experts top-2 beside
   a dense residual, 27,681,131,520) at their published widths, seeded
   bf16 weights, each freed before the next is drawn: ``make_prefill_step``
   at 8 x 512 (per-sequence groups) and 1 x 8192 (two groups of 4,096),
   their tokens/s and drop shares, ``make_serve_step`` for 16 tokens at
   B = 8, an 8-slot ``ServingLoop`` over 16 requests, launches counted
   (one per layer per prefill call and admission, none per decode step);
   every fourth completion against single-request greedy decoding in the
   loop's split (bf16 near-ties counted); the kernel against the plain
   attention in the model at 8 x 512 (each layer on its own q, k, v, and
   the routes and logits of the two runs: flips only at counted router
   near-ties); a profiled prefill at each shape (expert products, other
   products, attention, routing, the rest; idle share); the D = 128
   kernel at (8, 512) and (1, 8192) with 64 / 8 and 56 / 8 heads, causal,
   no window: against its plain version by phase 12's rules, repeated
   bitwise, then timed beside its bound, the plain version's and SDPA's.
   Alone: ``python3 -c
   'import chip_smoke as c; c.moe_alone()'``.

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


# The CPU side of phases 7 / 7b's card-vs-CPU checks runs in CPU_WORKERS
# spawned processes (a thread budget each) while the card runs go on: a
# reference needs only its plan entry and SEED, so none waits in turn
# behind the card runs.
CPU_WORKERS, CPU_WORKER_THREADS = 3, 2


def _cpu_worker_init() -> None:
    torch.set_num_threads(CPU_WORKER_THREADS)
    sys.path.insert(0, os.path.join(ROOT, "src"))


def cpu_reference(kw) -> tuple:
    """A worker's task: ``_train_cfg(**kw)`` run on the CPU on the draws
    ``run_plan``'s replayed card run takes (``replay_of`` the host
    generator of SEED). Returns the server parameters, the metrics and the
    run's seconds."""
    import repro_torch.rl as rl
    from repro_torch import comm, core, optim
    t0 = time.perf_counter()
    cfg = _train_cfg(rl, core, optim, comm, **kw)
    params, metrics, _ = rl.run_fedrl(
        cfg, rl.replay_of(cfg, rl.TorchDraws(SEED, "cpu")), device="cpu")
    return params, metrics, time.perf_counter() - t0


def cpu_references(plans):
    """Start the worker pool and submit the CPU reference of every compared
    entry of ``plans``: ``(pool, {label: future})``. The caller shuts the
    pool down."""
    import concurrent.futures
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=CPU_WORKERS, initializer=_cpu_worker_init,
        mp_context=multiprocessing.get_context("spawn"))
    futures = {label: pool.submit(cpu_reference, kw)
               for plan in plans for label, compare, kw in plan if compare}
    return pool, futures


def run_plan(phase, plan, km, _build, rl, core, optim, comm, card,
             refs) -> dict:
    """Drive one slice's training path: every configuration of ``plan``
    ``(label, compare, kwargs of _train_cfg)`` as a seeded, timed run that
    draws on the card (updates/sec), and, where ``compare``, again on draws
    made on the host, on the card and, in ``refs`` (``cpu_references``), on
    the CPU, which must agree. The kernel counts are set to 0 just before
    the path and read just after; every run's launches must equal the count
    the loop implies, with no build on the hot path. Each run's laps are
    logged: the seeded and replayed card runs, the CPU reference's own
    seconds and the time spent waiting for it."""
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
            rp, rmet, _, rwall, rgot = card_run(f"{label} replayed", cfg,
                                                draws)
            t0 = time.perf_counter()
            cp, cm, cpu_s = refs[label].result()
            wait = time.perf_counter() - t0
            rec["vs_cpu"] = _compare_runs(label, cfg, (rp, rmet), (cp, cm))
            rec["replayed_launches"] = rgot
            rec["laps"] = {"replayed_card_s": rwall, "cpu_s": cpu_s,
                           "cpu_wait_s": wait}
        runs.append(rec)
        last_params = params
        log(f"training {label}: {n_updates} updates in {wall!r} s = "
            f"{n_updates / wall!r} updates/s (seeded draws on the card, incl. "
            f"per-epoch eval); nas {metrics['nas'].tolist()} grad_sq "
            f"{metrics['server_grad_sq_norm'].tolist()}; launches "
            f"{ {k: v for k, v in got.items() if v} }"
            + (f"; replayed draws card vs CPU {rec['vs_cpu']}; laps "
               f"{rec['laps']}" if compare else "")
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
    m = 7 on the shared env and on fleets, and one bf16 run. Held against
    the CPU on replayed draws: every m = 7 run, the m = 64 runs with SGD
    and the bf16 run (the m = 64 momentum and Adam replays went when phase
    18 came: their kernels are held card vs CPU at m = 7, in phases 6 and
    15). At m = 10000 SGD only (momentum and Adam went when phase 19 came;
    m = 1024 runs them)."""
    plan = []
    for kind in ("periodic", "decay"):
        for opt in ("sgd", "momentum", "adam"):
            base = dict(kind=kind, opt=opt)
            if kind == "periodic":      # tau = 10: 2 epochs hold a sync
                base["n_epochs"] = CUT_EPOCHS
            plan.append((f"m=7 shared env {kind} {opt}", True,
                         dict(base, m=7)))
            plan.append((f"m=64 B=1 {kind} {opt}", opt == "sgd",
                         dict(base, m=64, B=1)))
            plan.append((f"m=64 B=4 ppo2x2 {kind} {opt}", opt == "sgd",
                         dict(base, m=64, B=4, ppo_epochs=2, n_minibatches=2)))
            for m in TRAIN_FLEETS[1:]:
                if m > 1024 and opt != "sgd":
                    continue          # cut when phase 19 came
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
    gossip. The m = 7 runs on the 3-4 topology are held against the CPU on
    replayed draws, those on the 5-6 one run seeded only (their replays
    went when phase 18 came) and with SGD only (momentum and Adam went when
    phase 19 came)."""
    plan = []
    for topo in (("random_regularish", 7, 3, 4, 0),
                 ("random_regularish", 7, 5, 6, 0)):
        for rounds in (1, 2):
            opts = ("sgd", "momentum", "adam") if topo[2] == 3 else ("sgd",)
            for opt in opts:
                plan.append((
                    f"m=7 consensus rand{topo[2]}-{topo[3]} E={rounds} {opt}",
                    topo[2] == 3, dict(kind="consensus", opt=opt, m=7,
                                       topo=topo, eps="0.9/D", rounds=rounds)))
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


def training_path(km, _build, rl, core, optim, comm, serve, card,
                  refs) -> dict:
    """Slice 2's path (``training_plan``), then the trained server
    parameters served through slice 1's engine."""
    # warm the card's libraries (cuBLAS, the generator) outside the counts
    rl.run_fedrl(_train_cfg(rl, core, optim, comm, "periodic", "sgd", 7,
                            n_epochs=1, epoch_len=50), SEED, device="cuda")
    torch.cuda.synchronize()
    out = run_plan("training", training_plan(), km, _build, rl, core, optim,
                   comm, card, refs)

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


def consensus_path(km, _build, rl, core, optim, comm, card, refs) -> dict:
    """Slice 3's path (``consensus_plan``): consensus gossip (dense fused,
    dense forced, sparse by auto-selection) and compressed payloads."""
    out = run_plan("consensus training", consensus_plan(), km, _build, rl,
                   core, optim, comm, card, refs)
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
# SWEEP_EPOCHS epochs: Fig. 5's lambda grid, Fig. 6's eps grid on the sparse
# E=1 topology (dense path, and the sparse path forced), Fig. 4's taus grid
# at tau = 15 (these four at seed 0: 3-4 runs a batch), a short eta x
# momentum / Adam grid (a static axis of the two optimizers; seed 0) and a
# top-k uplink static point (a compression_axis; seeds 0-1). Seeds 0-3 until
# phase 17 came: the loop of one-run calls that each sweep is held against
# took 64 s of the phase's 103 s; 2 seeds halved it and kept every path; the
# four grids went to seed 0 when phase 19 came (every grid point still runs
# batched and looped). 2 epochs keep each tau = 10 sweep's sync (the top-k
# one's topk_scatter).
SWEEP_EPOCHS = 2
SWEEP_SEEDS = (0, 1)
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
            name="chip_fig5", seeds=SWEEP_SEEDS[:1],
            base=cfg(core.make_strategy(
                "decay", tau=15, taus=taus15,
                decay=core.exponential_decay(0.98))),
            vmapped=(sweep.SweepAxis("lam", (0.98, 0.95, 0.92)),))),
        ("fig6 eps dense", sweep.SweepSpec(
            name="chip_fig6_dense", seeds=SWEEP_SEEDS[:1],
            base=cfg(consensus(False)),
            vmapped=(sweep.SweepAxis("eps", eps),))),
        ("fig6 eps sparse", sweep.SweepSpec(
            name="chip_fig6_sparse", seeds=SWEEP_SEEDS[:1],
            base=cfg(consensus(True)),
            vmapped=(sweep.SweepAxis("eps", eps),))),
        ("fig4 taus", sweep.SweepSpec(
            name="chip_fig4", seeds=SWEEP_SEEDS[:1],
            base=cfg(core.make_strategy("periodic", tau=15, m=m)),
            vmapped=(sweep.SweepAxis("taus", scheds),))),
        ("eta x optimizer", sweep.SweepSpec(
            name="chip_eta_opt", seeds=SWEEP_SEEDS[:1],
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


# --- phase 16: the async path (slice 11) ---------------------------------------

# masked_server_step's shapes: the Table II carry, the m = 1024 fleet and a
# stack of 12 runs at m = 7 (the batched sweeps' form), with all, none and
# part of the rows arriving ({0, 1} weights) and fractional staleness
# weights. With {0, 1} weights the card's scale_rows (g + (w - 1) * g) is
# w * g exactly, so the card equals the plain scaling followed by the card's
# own row_mean bitwise, and the CPU's plain version within row_mean's rule
# (ROW_MEAN_REL of the column's mean |g|, phase 6); fractional weights add
# the scaling's second rounding: 2^-21 of the column's max |g|.
ASYNC_STEP_SHAPES = ((7, 9347), (1024, 9347), (12, 7, 9347))
ASYNC_WEIGHTS = ("all", "none", "part", "frac")
ASYNC_FRAC_ULPS = 2.0 ** -21
# The async runs: the Table II geometry (T 150, P 25, eta 5e-3) at tau = 3
# for 2 epochs, so that 4 boundaries fire; the delay axis's 4 points x 3
# seeds and the k axis's 3 buffer sizes x 4 seeds are S = 12 runs of m = 7
# (84 agent rows, where phase 15 found batched == loop bitwise), cut to 1
# epoch at tau = 2 (3 boundaries) to keep the script in its 642 s.
ASYNC_TAU, ASYNC_EPOCHS = 3, 2
ASYNC_SWEEP_TAU, ASYNC_SWEEP_EPOCHS = 2, 1
ASYNC_SEEDS = (0, 1, 2, 3)
ASYNC_DELAY_POINTS = ((0.0, 0.0), (0.0, 1.0), (1.0, 0.5), (2.0, 1.5))
ASYNC_K_POINTS = (2.0, 4.0, 7.0)


def _async_weights(kind, shape, gen):
    if kind == "all":
        return torch.ones(shape)
    if kind == "none":
        return torch.zeros(shape)
    if kind == "part":
        w = (torch.rand(shape, generator=gen) < 0.5).float()
        w[..., 0] = 1.0
        return w
    w = torch.rand(shape, generator=gen)
    return torch.where(torch.rand(shape, generator=gen) < 0.3,
                       torch.zeros(()), w)


def masked_step_vs_plain(fu, async_fed) -> dict:
    """Phase 16's masked server step: the card (decay_accum's scale_rows,
    then row_mean) against the plain composition and the CPU."""
    gen = torch.Generator().manual_seed(SEED + 161)
    cases, worst, bitwise_cpu = [], 0.0, True
    for shape in ASYNC_STEP_SHAPES:
        g = torch.randn(shape, generator=gen)
        gc = g.cuda()
        m = shape[-2]
        for kind in ASYNC_WEIGHTS:
            w = _async_weights(kind, shape[:-1], gen)
            wc = w.cuda()
            row, denom = async_fed.masked_server_step(gc, wc)
            torch.cuda.synchronize()
            if row.device.type != "cuda" or denom.device.type != "cuda":
                raise AssertionError("masked_server_step left the card")
            cpu_row, cpu_denom = async_fed.masked_server_step(g, w)
            case = f"masked_server_step {tuple(shape)} weights={kind}"
            got, want = row.cpu(), cpu_row
            if kind == "none":
                if bool(torch.isfinite(got).any()) or \
                        bool(torch.isfinite(want).any()) or \
                        bool((denom != 0).any()):
                    raise AssertionError(f"{case}: expected no finite row")
                cases.append({"case": case, "bitwise_vs_cpu": True})
                continue
            if kind != "frac":
                scaled = (gc * wc.unsqueeze(-1)).contiguous()
                mine = (fu.row_mean_cuda(scaled).float()
                        * (m / wc.sum(-1)).unsqueeze(-1))
                if not torch.equal(row, mine):
                    raise AssertionError(f"{case}: not bitwise the plain "
                                         f"scaling + row_mean on the card")
                if not torch.equal(denom.cpu(), cpu_denom):
                    raise AssertionError(f"{case}: denom {denom} vs CPU "
                                         f"{cpu_denom}")
            scale = (m / cpu_denom).unsqueeze(-1)
            tol = (ROW_MEAN_REL * g.abs().mean(-2) * scale
                   + ASYNC_FRAC_ULPS * g.abs().amax(-2) * scale)
            err = (got - want).abs()
            if bool((err > tol).any()) or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{case}: max err {float(err.max())} "
                                     f"past its tolerance")
            same = bool(torch.equal(got, want))
            bitwise_cpu &= same
            worst = max(worst, float(err.max()))
            cases.append({"case": case, "max_abs_err": float(err.max()),
                          "bitwise_vs_cpu": same})
    log(f"phase async: masked_server_step at {len(cases)} cases "
        f"({ASYNC_STEP_SHAPES} x {ASYNC_WEIGHTS}): {{0, 1}} weights bitwise "
        f"the plain scaling + the card's row_mean; vs the CPU max abs "
        f"{worst!r} (bitwise everywhere: {bitwise_cpu}); no arrival gives "
        f"no finite row and denom 0 on the card")
    return {"cases": cases, "max_abs_err": worst,
            "bitwise_vs_cpu": bitwise_cpu}


def _async_cfg(rl, strat, epochs=ASYNC_EPOCHS):
    return rl.FedRLConfig(env=rl.FIGURE_EIGHT, strategy=strat, eta=TRAIN_ETA,
                          n_epochs=epochs, epoch_len=TRAIN_T,
                          minibatch=TRAIN_P)


def async_specs(rl, core, sweep) -> list:
    """``(label, spec)`` of phase 16's two batched async sweeps."""
    from repro_torch.core import async_fed

    n_periods = ASYNC_SWEEP_EPOCHS * (TRAIN_T // TRAIN_P) // ASYNC_SWEEP_TAU
    m = rl.FIGURE_EIGHT.n_rl
    cfg = lambda strat: _async_cfg(rl, strat, ASYNC_SWEEP_EPOCHS)
    base = async_fed.make_schedule("deterministic", 0.0, m, n_periods,
                                   seed=1234)
    kofm = async_fed.kofm_schedule(m, n_periods, 3, dist="geometric",
                                   param=0.5, seed=1234)
    return [
        ("delay", sweep.SweepSpec(
            name="chip_async_delay", seeds=ASYNC_SEEDS[:3],
            base=cfg(core.make_strategy(
                "async", tau=ASYNC_SWEEP_TAU, schedule=base,
                stale_decay=core.exponential_decay(0.8))),
            vmapped=(sweep.SweepAxis("delay", ASYNC_DELAY_POINTS),))),
        ("k", sweep.SweepSpec(
            name="chip_async_k", seeds=ASYNC_SEEDS,
            base=cfg(core.make_strategy(
                "async", tau=ASYNC_SWEEP_TAU, schedule=kofm)),
            vmapped=(sweep.SweepAxis("k", ASYNC_K_POINTS),))),
    ]


def async_path(km, rl, core, sweep, card) -> dict:
    """Phase 16 (slice 11): the masked server step; zero delay against
    periodic on the card, bitwise; a geometric(0.5) run with staleness
    weights on the card against the CPU on the same draws; the ``delay``
    and ``k`` axes batched through ``run_sweep`` on the card (kernel counts
    set to 0 just before, read just after) against their loops and, on
    their first runs, the CPU; runs/s of both forms."""
    from repro_torch.core import async_fed

    t0 = time.perf_counter()
    step = masked_step_vs_plain(km.fu, async_fed)
    m = rl.FIGURE_EIGHT.n_rl
    n_periods = ASYNC_EPOCHS * (TRAIN_T // TRAIN_P) // ASYNC_TAU

    # zero delay == periodic, bitwise, on the card
    per = _async_cfg(rl, core.make_strategy("periodic", tau=ASYNC_TAU, m=m))
    zero = _async_cfg(rl, core.make_strategy(
        "async", tau=ASYNC_TAU, schedule=async_fed.make_schedule(
            "deterministic", 0.0, m, n_periods, seed=1234)))
    sp, mp, _ = rl.run_fedrl(per, SEED, device="cuda")
    sa, ma, _ = rl.run_fedrl(zero, SEED, device="cuda")
    zero_dev = max(float(np.max(np.abs(ma[k] - mp[k]))) for k in mp)
    for h in ("pi", "vf"):
        for k in sp[h]:
            zero_dev = max(zero_dev, float((sa[h][k] - sp[h][k]).detach()
                                           .abs().max()))
    if zero_dev != 0.0:
        raise AssertionError(f"async: zero delay vs periodic on the card "
                             f"deviates by {zero_dev!r}")

    # a delayed run, card vs CPU on the same draws
    sched = async_fed.make_schedule("geometric", 0.5, m, n_periods,
                                    seed=1234)
    geo = _async_cfg(rl, core.make_strategy(
        "async", tau=ASYNC_TAU, schedule=sched,
        stale_decay=core.exponential_decay(0.8)))
    draws = rl.replay_of(geo, rl.TorchDraws(SEED, "cuda", geo.eval_seed))
    card_run = rl.run_fedrl(geo, draws.to("cuda"), device="cuda")
    cpu_run = rl.run_fedrl(geo, draws, device="cpu")
    geo_cmp = _compare_runs("async geometric(0.5)", geo, card_run[:2],
                            cpu_run[:2])
    ledger = card_run[2]
    if ledger.table_row() != cpu_run[2].table_row() or \
            ledger.c1_events != sched.total_arrivals() or \
            ledger.total_bytes() != sched.total_arrivals() * \
            rl.fedrl.policy_payload_elems() * 4:
        raise AssertionError(f"async geometric(0.5): ledger {ledger} vs "
                             f"{sched.total_arrivals()} arrivals")
    log(f"phase async: zero delay vs periodic on the card bitwise (dev "
        f"{zero_dev!r}); geometric(0.5) card vs CPU on the same draws "
        f"{geo_cmp}, {ledger.c1_events} of {m * n_periods} arrivals billed")

    sweeps, launches = {}, {k: 0 for k in TRAIN_KERNELS}
    for name, spec in async_specs(rl, core, sweep):
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
            raise AssertionError(f"async {name}: batched launches {got}, "
                                 f"loop {loop_launches}")
        bitwise, dev = True, 0.0
        for k, v in res.metrics["base"].items():
            w = loop.metrics["base"][k]
            if not np.all(np.isfinite(v)) or v.shape != w.shape:
                raise AssertionError(f"async {name}: bad {k}")
            bitwise &= bool(np.array_equal(v, w))
            dev = max(dev, float(np.max(np.abs(v - w))))
        if not bitwise:
            raise AssertionError(f"async {name}: batched vs loop not "
                                 f"bitwise at {spec.n_runs} x {m} rows "
                                 f"(max abs {dev!r})")
        cpu_rel = _sweep_vs_cpu(rl, sweep, spec, "base", res.metrics["base"])
        wall, loop_wall = res.wall_s["base"], loop.wall_s["base"]
        rec = {"S": spec.n_runs, "wall_s": wall, "loop_wall_s": loop_wall,
               "runs_per_s": spec.n_runs / wall,
               "loop_runs_per_s": spec.n_runs / loop_wall,
               "launches": got, "bitwise_vs_loop": bitwise,
               "max_rel_vs_cpu": cpu_rel}
        sweeps[name] = rec
        log(f"phase async: {name} axis, {spec.n_runs} runs batched in "
            f"{wall!r} s = {rec['runs_per_s']!r} runs/s, loop {loop_wall!r} "
            f"s = {rec['loop_runs_per_s']!r} runs/s; bitwise vs loop; first "
            f"{SWEEP_CPU_RUNS} runs vs CPU max rel {cpu_rel!r}; launches "
            f"{ {k: v for k, v in got.items() if v} } card=\"{card}\"")
    for k in ("decay_accum", "row_mean"):
        if launches[k] == 0:
            raise AssertionError(f"async path: {k} never launched")
    seconds = time.perf_counter() - t0
    log(f"phase async: {seconds!r} s")
    return {"masked_step": step, "zero_delay_dev": zero_dev,
            "geometric_vs_cpu": geo_cmp, "arrivals": ledger.c1_events,
            "sweeps": sweeps, "launches": launches, "seconds": seconds}


def async_alone() -> dict:
    """Phase 16 without the rest of the script (``python3 -c 'import
    chip_smoke as c; c.async_alone()'``): builds the kernels, then the async
    path."""
    if not torch.cuda.is_available():
        raise SystemExit("async_alone: no CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch.rl as rl
    from repro_torch import core, sweep

    km = _sweep_modules()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(f"card {card}")
    return async_path(km, rl, core, sweep, card)


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


# --- phase 17: the task-generic FMARL driver (slice 12) ----------------------------

# (a) examples/torch_quickstart.py's five strategies (m = 7, tau = 8, 320
# local steps each) on one table of host-drawn noise, card against CPU, and
# the example itself on the card; (b) the full-width run: every agent a tree
# laid out like the 6-64-64 actor-critic (n = 9,347), m = 1024, tau = 2, 3
# periods, under the noisy quadratic, for periodic, decay (tau_i ~ U{1, 2}),
# dense and sparse consensus (E = 2 on a k-NN ring), momentum, Adam and a
# top-k uplink, card against CPU. Its noise cycles through FMARL_POOL
# host-drawn (m, n) draws (77 MB of fp32, where 6 distinct steps would copy
# 230 MB); (c) HierarchicalStrategy.server_average at (1024, 9347), the
# cluster mean by consensus_step and the global mean by row_mean, against
# their plain versions and float64.
FMARL_M, FMARL_TAU, FMARL_PERIODS = 1024, 2, 3
FMARL_POOL = 2
FMARL_SIGMA = 0.05
FMARL_ETA = 0.05
FMARL_TOPK = 584
FMARL_CLUSTER = 32           # agents per cluster in (c)
HIER_REL = 1e-6              # (c): |got - float64| <= HIER_REL * max |x|


def _tmap(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _tleaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tleaves(tree[k])]
    return [tree]


def replayed_quadratic(pool, sigma):
    """A batched ``local_grad_fn`` on replayed draws: the noisy quadratic's
    gradient ``p + sigma * pool[step % K]`` per leaf (``pool``: a tree of
    ``(K, m, ...)`` leaves on the run's device) and the per-agent loss
    ``sum |p|^2`` as its aux."""
    k = _tleaves(pool)[0].shape[0]

    def grad_fn(params_m, agent_ids, step, gen):
        g = _tmap(lambda p, z: p + sigma * z[step % k], params_m, pool)
        loss = sum(torch.sum(p * p, dim=tuple(range(1, p.ndim)))
                   for p in _tleaves(params_m))
        return g, {"loss": loss}

    return grad_fn


def _server_eval(params, gen):
    return params                 # the quadratic's gradient at the server


def _fmarl_expected(cfg) -> dict:
    """Launches one ``run_fmarl`` of ``cfg`` implies. Per local step: the
    SGD ``decay_accum`` or the optimizer's launch; a dense fused gossip adds
    one ``consensus_step``, a sparse one a ``scale_rows`` (``decay_accum``)
    and E ``consensus_gather``. Per period: one ``row_mean`` (a
    ``topk_scatter`` for a top-k uplink) and one per moment matrix."""
    strat, opt = cfg.strategy, cfg.optimizer
    steps, periods = cfg.n_periods * strat.tau, cfg.n_periods
    out = {k: 0 for k in TRAIN_KERNELS}
    out["decay_accum" if opt is None else f"{opt.kind}_update"] += steps
    out["topk_scatter" if strat.comm.kind == "topk" else "row_mean"] += periods
    out["row_mean"] += periods * (0 if opt is None else opt.n_moments)
    if hasattr(strat, "rounds"):                     # consensus
        if strat.sparse:
            out["decay_accum"] += steps
            out["consensus_gather"] += strat.rounds * steps
        else:
            out["consensus_step"] += (1 if strat.fused else strat.rounds) * steps
    return out


def fmarl_plan(core, optim, comm) -> list:
    """``(label, FmarlConfig)`` of (b)."""
    m, tau = FMARL_M, FMARL_TAU
    ring = core.knn_ring(m, 4)
    eps = 0.9 / ring.max_degree
    mk = core.make_strategy
    periodic = mk("periodic", tau=tau, m=m)
    decay = mk("decay", tau=tau, taus=core.uniform_taus(1, tau, m),
               decay=core.exponential_decay(0.9))
    cfg = lambda strat, **kw: core.FmarlConfig(
        strategy=strat, eta=FMARL_ETA, n_periods=FMARL_PERIODS, **kw)
    return [
        ("periodic", cfg(periodic)),
        ("decay", cfg(decay)),
        ("dense consensus E=2", cfg(mk("consensus", tau=tau, topo=ring,
                                       eps=eps, rounds=2, sparse=False))),
        ("sparse consensus E=2", cfg(mk("consensus", tau=tau, topo=ring,
                                        eps=eps, rounds=2))),
        ("momentum", cfg(periodic, optimizer=optim.flat_momentum(0.9))),
        ("adam", cfg(decay, optimizer=optim.flat_adam())),
        ("top-k uplink", cfg(periodic.with_comm(comm.topk(FMARL_TOPK)))),
    ]


def _fmarl_compare(label, cfg, card_run, cpu_run, params: bool) -> dict:
    """Card against CPU on the same draws: per-period metrics within
    TRAIN_RTOL, the ledgers equal and, where ``params``, the server
    parameters within TRAIN_ATOL (a top-k uplink's selection may differ in
    an entry whose magnitude ties its row's threshold to an ulp, which moves
    that entry by ~|x| / m: its metrics are held, its parameters reported)."""
    (gs, gm, gl), (cs_, cm, cl) = card_run, cpu_run
    rel = 0.0
    for k, want in (("server_grad_sq_norm", cm["server_grad_sq_norm"]),
                    ("loss", cm["mean_aux"]["loss"])):
        got = gm["server_grad_sq_norm"] if k != "loss" else \
            gm["mean_aux"]["loss"]
        if got.shape != (cfg.n_periods,) or not np.all(np.isfinite(got)):
            raise AssertionError(f"fmarl {label}: bad {k} {got}")
        rel = max(rel, _max_rel(got, want))
        if not np.allclose(got, want, rtol=TRAIN_RTOL, atol=0):
            raise AssertionError(f"fmarl {label}: card {k} {got} vs CPU "
                                 f"{want} (rtol {TRAIN_RTOL})")
    if gl.table_row() != cl.table_row():
        raise AssertionError(f"fmarl {label}: ledgers {gl} vs {cl}")
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        _tleaves(gs.server_params), _tleaves(cs_.server_params)))
    if params and err > TRAIN_ATOL:
        raise AssertionError(f"fmarl {label}: server params card vs CPU max "
                             f"err {err:.3e} > {TRAIN_ATOL}")
    return {"metrics_max_rel": rel, "params_max_abs": err,
            "params_held": params}


def _profile_window(fn) -> dict:
    """One ``torch.profiler`` window around ``fn()``: wall, device busy
    time and idle share, and each ``fmarl.*`` range's host and device ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in ev
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not e.key.startswith("fmarl."))
    phases = {e.key: {"count": e.count, "host_ms": e.cpu_time_total / 1e3,
                      "device_ms": e.device_time_total / 1e3}
              for e in ev if e.key.startswith("fmarl.")
              and e.device_type == DeviceType.CPU}
    if busy_us <= 0:
        raise AssertionError("fmarl profile: no device time in the window")
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us, "phases": phases}


def _actor_critic_tree(rl) -> dict:
    """The 6-64-64 actor-critic's parameters (n = 9,347), seeded."""
    from repro_torch.rl.env import OBS_DIM

    pol = rl.policy.init_policy(OBS_DIM, generator=torch.Generator()
                                .manual_seed(SEED), device="cpu")
    return {h: {k: v.detach().clone() for k, v in pol[h].items()}
            for h in ("pi", "vf")}


def hierarchical_vs_plain(km, core, dispatch, tree_shapes) -> dict:
    """(c): ``HierarchicalStrategy.server_average`` on an (m, n) = (1024,
    9347) tree: a cluster period (one ``consensus_step`` launch, clusters of
    FMARL_CLUSTER agents) and a global one (one ``row_mean``), each against
    the plain version on the same inputs and float64."""
    m = FMARL_M
    clusters = tuple(tuple(range(c, c + FMARL_CLUSTER))
                     for c in range(0, m, FMARL_CLUSTER))
    hs = core.HierarchicalStrategy(tau=FMARL_TAU, clusters=clusters,
                                   global_every=2)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    tree = _tmap(lambda shape: torch.randn((m,) + shape, generator=gen,
                                           device="cuda"), tree_shapes)
    flat, spec = dispatch.stacked_ravel_spec(tree)
    scale = float(flat.abs().max())
    p_local = torch.tensor(hs.cluster_mean_matrix(), device="cuda")
    out = {}
    for period, kernel in ((0, "consensus_step"), (1, "row_mean")):
        _reset_counts(km)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = spec.ravel(hs.server_average(tree, period_idx=period))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in _kernel_counts(km).items() if v}
        if launches != {kernel: 1}:
            raise AssertionError(f"hierarchical period {period}: launches "
                                 f"{launches}, expected {kernel} once")
        if kernel == "consensus_step":
            plain = km.cs.consensus_step_plain(flat, p_local)
            want = (p_local.double() @ flat.double())
            tol = HIER_REL * scale
        else:
            plain = km.fu.row_mean_plain(flat).expand_as(flat)
            want = flat.double().mean(0).expand_as(flat)
            tol = (ROW_MEAN_REL * flat.abs().mean(0)
                   + torch.finfo(torch.float32).eps * want[0].abs()).double()
            if not torch.equal(got, got[:1].expand_as(got)):
                raise AssertionError("hierarchical global period: rows differ")
        for name, x in (("kernel", got), ("plain", plain)):
            if bool(((x.double() - want).abs() > tol).any()):
                raise AssertionError(
                    f"hierarchical period {period}: {name} vs float64 max err "
                    f"{float((x.double() - want).abs().max()):.3e}")
        out[kernel] = {
            "period": period, "wall_ms": wall_ms,
            "max_abs_err": float((got.double() - want).abs().max()),
            "plain_max_abs_err": float((plain.double() - want).abs().max()),
            "max_abs_vs_plain": float((got - plain).abs().max())}
    log(f"phase fmarl: hierarchical server_average at ({m}, {spec.n}), "
        f"clusters of {FMARL_CLUSTER}: cluster period one consensus_step "
        f"{out['consensus_step']}; global period one row_mean "
        f"{out['row_mean']}")
    return out


def fmarl_path(km, rl, core, optim, comm, dispatch, card) -> dict:
    """Phase 17 (slice 12): (a) the quickstart's strategies, card against
    CPU, and the example on the card; (b) the full-width runs, card (timed:
    steps/s) against CPU; counts set to 0 just before the card runs of (a)
    and (b) and read just after, held to ``_fmarl_expected``; one profiled
    window at m = 1024; (c) the hierarchical server average."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from examples import torch_quickstart as qs

    t0 = time.perf_counter()
    # (a): one noise table (320 steps, m = 7, the 16 x 16 leaf)
    qcfgs = qs.configs()
    steps = max(c.n_periods * c.strategy.tau for c in qcfgs.values())
    table = torch.randn((steps, qs.M) + tuple(qs.initial_params()["w"].shape),
                        generator=torch.Generator().manual_seed(SEED))
    q_pool = {"cpu": {"w": table}, "cuda": {"w": table.to("cuda")}}
    tree = _actor_critic_tree(rl)
    shapes = _tmap(lambda v: tuple(v.shape), tree)
    pool = _tmap(lambda shape: torch.randn(
        (FMARL_POOL, FMARL_M) + shape,
        generator=torch.Generator().manual_seed(SEED + 1)), shapes)
    b_pool = {"cpu": pool, "cuda": _tmap(lambda z: z.to("cuda"), pool)}
    plan = fmarl_plan(core, optim, comm)
    parts = {"setup": time.perf_counter() - t0}

    def run(cfg, init, pool_, sigma, device):
        return core.run_fmarl(cfg, init, replayed_quadratic(pool_, sigma),
                              SEED, _server_eval, device=device)

    expected = {k: 0 for k in TRAIN_KERNELS}
    _reset_counts(km)
    card_q, card_b, rates = {}, {}, {}
    for name, cfg in qcfgs.items():
        card_q[name] = run(cfg, qs.initial_params(), q_pool["cuda"],
                           qs.SIGMA, "cuda")
        for k, v in _fmarl_expected(cfg).items():
            expected[k] += 2 * v             # and once in the example below
    qs.main("cuda")
    for label, cfg in plan:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        card_b[label] = run(cfg, tree, b_pool["cuda"], FMARL_SIGMA, "cuda")
        torch.cuda.synchronize()
        rates[label] = cfg.n_periods * cfg.strategy.tau / (
            time.perf_counter() - t1)
        for k, v in _fmarl_expected(cfg).items():
            expected[k] += v
    torch.cuda.synchronize()
    launches = _kernel_counts(km)
    if launches != expected:
        raise AssertionError(f"fmarl launches {launches} != {expected}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"fmarl path: kernels never launched: {missing}")
    parts["card_runs"] = time.perf_counter() - t0 - sum(parts.values())

    cmp_ = {}
    for name, cfg in qcfgs.items():
        cmp_[name] = _fmarl_compare(
            name, cfg, card_q[name],
            run(cfg, qs.initial_params(), q_pool["cpu"], qs.SIGMA, "cpu"),
            True)
    for label, cfg in plan:
        t1 = time.perf_counter()
        cpu_run = run(cfg, tree, b_pool["cpu"], FMARL_SIGMA, "cpu")
        cmp_[label] = dict(_fmarl_compare(
            label, cfg, card_b[label], cpu_run,
            cfg.strategy.comm.kind != "topk"),
            cpu_s=time.perf_counter() - t1)
    parts["cpu_runs"] = time.perf_counter() - t0 - sum(parts.values())

    momentum = dict(plan)["momentum"]
    prof = _profile_window(lambda: run(momentum, tree, b_pool["cuda"],
                                       FMARL_SIGMA, "cuda"))
    prof["steps_per_s"] = FMARL_PERIODS * FMARL_TAU / prof["wall_ms"] * 1e3
    parts["profile"] = time.perf_counter() - t0 - sum(parts.values())
    hier = hierarchical_vs_plain(km, core, dispatch, shapes)
    seconds = time.perf_counter() - t0
    parts["hierarchical"] = seconds - sum(parts.values())
    for label, _ in plan:
        log(f"phase fmarl: m={FMARL_M} n=9347 {label}: "
            f"{rates[label]!r} steps/s (tau {FMARL_TAU}, "
            f"{FMARL_PERIODS} periods, first call); card vs CPU "
            f"{cmp_[label]} card=\"{card}\"")
    log(f"phase fmarl: quickstart (m = {qs.M}, tau = {qs.TAU}, 320 steps) "
        f"card vs CPU on the same draws: "
        + "; ".join(f"{n} {v['metrics_max_rel']:.3e} / "
                    f"{v['params_max_abs']:.3e}" for n, v in cmp_.items()
                    if n in qcfgs))
    log(f"profile fmarl m={FMARL_M} momentum, {FMARL_PERIODS * FMARL_TAU} "
        f"steps + {FMARL_PERIODS} syncs + evals: wall_ms="
        f"{prof['wall_ms']!r} ({prof['steps_per_s']!r} steps/s, warm) "
        f"device_busy_ms={prof['device_busy_ms']!r} "
        f"device_idle_share={prof['device_idle_share']!r}; phases (host ms / "
        f"device ms): " + ", ".join(
            f"{k} x{v['count']} {v['host_ms']:.3f}/{v['device_ms']:.3f}"
            for k, v in sorted(prof["phases"].items())) + f" card=\"{card}\"")
    log(f"phase fmarl: launches on the main path "
        f"{ {k: v for k, v in launches.items() if v} }; seconds by part "
        f"{parts}, {seconds!r} s in all")
    return {"launches": launches, "steps_per_s": rates, "vs_cpu": cmp_,
            "profile": prof, "hierarchical": hier, "seconds": seconds,
            "parts_s": parts}


def fmarl_alone() -> dict:
    """Phase 17 without the rest of the script (``python3 -c 'import
    chip_smoke as c; c.fmarl_alone()'``): builds the kernels, then the FMARL
    path."""
    if not torch.cuda.is_available():
        raise SystemExit("fmarl_alone: no CUDA card")
    km, core, comm, dispatch = _sweep_modules()
    import repro_torch.rl as rl
    from repro_torch import optim
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(f"card {card}")
    _build.load()
    return fmarl_path(km, rl, core, optim, comm, dispatch, card)


# --- phases 9-11: the language-model serving path (slice 4) ------------------------

LM_ARCH = "rwkv6-1.6b"
LM_PARAMS = 1_584_144_384             # the JAX init tree's count at full width
LM_SLOTS = 8
LM_PREFILL = ((8, 512), (1, 4096))    # (B, T) of the prefill step
LM_DECODE_TOKENS = 32
LM_REQUESTS = 16
LM_CHECKED = 4                        # every LM_CHECKED-th completion checked
LM_PROMPT = (16, 512)                 # prompt lengths, inclusive
LM_NEW = (32, 64)                     # new tokens, inclusive
LM_MAX_SEQ = 1024
LM_ADMIT_TIMED = (1, 256)             # an admission of a mid-length prompt
LM_TIMED = 2                          # timed calls per prefill shape
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


def _requests(rng, launch, cfg, long_prompt=None, n=LM_REQUESTS,
              prompt=LM_PROMPT, new=LM_NEW):
    """``n`` requests: prompts of ``prompt`` tokens (inclusive range) and
    ``new`` new tokens; request 0's prompt of ``long_prompt`` tokens where
    given (it wraps a ring of that length's window)."""
    reqs = []
    for i in range(n):
        p = long_prompt if (i == 0 and long_prompt) else int(
            rng.integers(prompt[0], prompt[1] + 1))
        reqs.append(launch.Request(i, rng.integers(0, cfg.vocab_size, p),
                                   int(rng.integers(new[0], new[1] + 1))))
    return reqs


def lm_greedy_check(TM, cfg, params, req, tokens, near_tie,
                    cache_len=None, embeds=None) -> dict:
    """Single-request greedy decoding of ``req`` on the card (prefill, then
    decode_step), fed the loop's own tokens, so that every position is
    checked; the prefill sizes the KV caches for ``cache_len`` positions, as
    the loop's ``max_seq`` sizes its own. ``embeds`` (1, F, d): a VLM's
    patch embeddings, prefilled before the prompt (decoding then starts at
    position F + len(prompt)). A model with an MoE FFN takes the
    prompt as the loop takes it: ``prompt[:-1]`` prefilled, then the last
    prompt token through a decode step (an MoE prefill routes its tokens as
    one group under a capacity, a decode step each token alone). Where a loop
    token is not the single-request argmax, its logit must lie within
    ``near_tie(max logit)`` of the max: such near-ties are returned (with
    how far below the max it lies), any other divergence raises."""
    prompt = torch.as_tensor(req.prompt[None], device="cuda")
    if any(TM.transformer.ffn_kind(cfg, i) == "moe"
           for i in range(cfg.n_layers)):
        st = TM.init_decode_state(cfg, 1, max_seq=cache_len, device="cuda")
        if prompt.shape[1] > 1:
            TM.forward(cfg, params, prompt[:, :-1], mode="prefill",
                       states=st, unembed_out=False)
        lg, st = TM.decode_step(cfg, params, prompt[:, -1:], st,
                                torch.tensor([prompt.shape[1] - 1],
                                             device="cuda"))
    else:
        lg, st = TM.prefill(cfg, params, prompt, embeds=embeds,
                            cache_len=cache_len)
        lg = lg[:, -1:]
    pos = len(req.prompt) + (0 if embeds is None else embeds.shape[1])
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
    """The completions of every fourth request (``LM_CHECKED``: ids 0, 4,
    8, 12) against single-request greedy decoding (``lm_greedy_check``).
    All 16 were checked until phase 18 came, every other one until phase
    20 came; at B = 1 a token's decode step is host-bound, so the check of
    all 16 took 51-62 s."""
    checks = [lm_greedy_check(TM, cfg, params, r, got[r.rid], near_tie,
                              cache_len) for r in reqs[::LM_CHECKED]]
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
    reqs = _requests(rng, launch, cfg)
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

    # --- check: completions are single-request greedy decoding ---
    near_tie = lambda best: LM_BF16_ULPS * bf16_ulp(best)
    chk = loop_vs_single_request(TM, cfg, params, reqs, got, near_tie)
    out["loop_vs_single_request"] = chk
    log(f"check lm ServingLoop bf16: every token of {chk['requests']} of the "
        f"{LM_REQUESTS} completions ({chk['positions']}) is single-request "
        f"greedy on the "
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
# profile_prefill's padding: empty spin kernels at each end of its window
PAD_LAUNCHES = 64
SPIN_KERNEL = "spin_kernel"       # torch.cuda._sleep's kernel


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
    reqs = _requests(rng, launch, cfg, long_prompt=SWA_LONG_PROMPT)
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

    # --- check: completions are single-request greedy decoding ---
    near_tie = lambda best: LM_BF16_ULPS * bf16_ulp(best)
    chk = loop_vs_single_request(TM, cfg, params, reqs, got, near_tie,
                                 cache_len=SWA_MAX_SEQ)
    out["loop_vs_single_request"] = chk
    log(f"check swa ServingLoop bf16: every token of {chk['requests']} of the "
        f"{LM_REQUESTS} completions ({chk['positions']}) is single-request "
        f"greedy on the "
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


def _sdpa_args(q, k, v, window, causal=True) -> tuple:
    """(B, H, S, D) views of q and of K/V repeated to the query heads (the
    TPU kernel's inputs; the repeat is made here, outside any timed call),
    and ``is_causal`` where the window does not bite, else a boolean band
    mask, over which SDPA computes all S^2 pairs; with ``causal`` off (no
    window) no mask at all."""
    from repro_torch.models.attention import _repeat_kv
    qt = q.transpose(1, 2)
    kt, vt = (_repeat_kv(t, q.shape[2]).transpose(1, 2) for t in (k, v))
    s = q.shape[1]
    if not causal:
        return qt, kt, vt, {}
    if window is None or s <= window:
        return qt, kt, vt, {"is_causal": True}
    i = torch.arange(s, device=q.device)
    return qt, kt, vt, {"attn_mask": (i[None, :] <= i[:, None])
                        & (i[None, :] > i[:, None] - window)}


def sdpa_fn(q, k, v, window, backend=None, causal=True):
    """The library yardstick: one ``scaled_dot_product_attention`` call on
    the inputs of ``_sdpa_args``; ``backend`` (an ``SDPBackend`` name)
    restricts it to that backend."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt, kw = _sdpa_args(q, k, v, window, causal)
    if backend is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)

    def call():
        with sdpa_kernel([getattr(SDPBackend, backend)]):
            return F.scaled_dot_product_attention(qt, kt, vt, **kw)
    return call


def sdpa_backend_of(q, k, v, window, causal=True) -> str:
    """The backend the default SDPA call picks, as PyTorch's own dispatcher
    (``torch._fused_sdp_choice``) chooses it."""
    from torch.nn.attention import SDPBackend
    qt, kt, vt, kw = _sdpa_args(q, k, v, window, causal)
    return SDPBackend(torch._fused_sdp_choice(
        qt, kt, vt, kw.get("attn_mask"), 0.0, kw.get("is_causal", False))).name


def sdpa_backends(q, k, v, got, cyc, flush, n_ev, window=SWA_WINDOW,
                  causal=True) -> dict:
    """Each SDPA backend of ``SDPA_BACKENDS`` on these inputs: refused (and
    why), or its device time by CUDA events, L2 flushed, and its largest
    difference from the kernel's output ``got``."""
    import warnings
    out = {}
    for backend in SDPA_BACKENDS:
        fn = sdpa_fn(q, k, v, window, backend, causal)
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


def _spin_pad() -> None:
    """PAD_LAUNCHES empty spin kernels (``torch.cuda._sleep(0)``), then a
    synchronise: laid around a profiled call, they give the records a
    tracer drops at a window's edges (one swa_attention record of 36 in
    every window of whisper-small's prefill late in a full run) something
    other than the call's to drop."""
    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()


def profile_prefill(prefill_step, params, toks, n_attn, batch=None,
                    host_ops=False) -> dict:
    """One ``torch.profiler`` window of a prefill call (after one warm
    call), taken again up to CUPTI_WINDOWS times while the tracer loses the
    kernel's records: wall and device busy time, the idle share, the
    swa_attention kernel's and the matrix products' device time and share
    of the busy time, ``aten::bmm``'s device time, every device op and the
    top ones. ``n_attn``: the kernel launches a call makes; ``batch``
    (default ``{"tokens": toks}``) the step's input. The call sits between
    two ``_spin_pad``s, whose records are left out and whose time is
    outside the wall clock. Device activity only unless ``host_ops``
    (``aten_bmm_ms`` is None without it): recording the host ops of a
    48-layer prefill cost ~8 s and slowed the host in the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = {"tokens": toks} if batch is None else batch
    prefill_step(params, batch)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops
                                      else [])
    for window in range(1, CUPTI_WINDOWS + 1):
        with profile(activities=acts) as prof:
            _spin_pad()
            t0 = time.perf_counter()
            prefill_step(params, batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            _spin_pad()
        dev = _device_ops(prof)
        n_pad = sum(c for k, (c, _) in dev.items() if SPIN_KERNEL in k)
        dev = {k: v for k, v in dev.items() if SPIN_KERNEL not in k}
        n_swa = sum(c for k, (c, _) in dev.items() if SWA_KERNEL in k)
        if n_swa == n_attn:
            break
        log(f"profile window {window} of {CUPTI_WINDOWS} lost: {n_swa} "
            f"records of {SWA_KERNEL}, expected {n_attn}")
    else:
        raise AssertionError("every profiled prefill window was lost")
    busy = sum(t for _, t in dev.values())
    swa_us = sum(t for k, (_, t) in dev.items() if SWA_KERNEL in k)
    mm = _matmul_us(dev)
    ops = {k: {"count": c, "device_ms": t / 1e3} for k, (c, t) in sorted(
        dev.items(), key=lambda kv: -kv[1][1])}
    bmm = sum(e.device_time_total for e in prof.key_averages()
              if e.device_type == DeviceType.CPU and e.key == "aten::bmm"
              ) if host_ops else None
    return {"shape": list(toks.shape), "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "swa_attention_ms": swa_us / 1e3, "swa_attention_launches": n_swa,
            "pad_records_left_out": n_pad, "matmul_ms": mm / 1e3,
            "swa_share_of_busy": swa_us / busy if busy else None,
            "matmul_share_of_busy": mm / busy if busy else None,
            "aten_bmm_ms": None if bmm is None else bmm / 1e3,
            "device_ops": ops,
            "top_device_ops": dict(list(ops.items())[:10])}


def profile_swa(TC, TM, launch, card) -> dict:
    """Two ``torch.profiler`` windows of h2o-danube-3-4b at full width,
    bf16: one 1 x 8192 prefill call (device idle share, the swa_attention
    kernel's and the matrix products' share of the busy time) and 16
    decode steps at B = 8 after a 512-token prefill (idle share, the matrix
    products' share, the top device ops)."""
    cfg = TC.get_arch(SWA_ARCH)
    params = TM.init_params(cfg, seed=SEED, device="cuda")
    prefill_step = launch.make_prefill_step(cfg)
    toks = _prompt_tokens(np.random.default_rng(SEED + 51), cfg,
                          *SWA_PREFILL[1])
    pre = profile_prefill(prefill_step, params, toks, cfg.n_layers)
    n_swa = pre["swa_attention_launches"]
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


def hgmma_counts(_build, kernels) -> dict:
    """``HGMMA`` instructions (wgmma on the tensor cores) in the built
    library's kernels whose name holds each of ``kernels``, from one
    ``cuobjdump -sass`` of the library (each run of it takes seconds)."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build.build_info["library"]],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, inside = {k: 0 for k in kernels}, ()
    for line in sass.splitlines():
        if "Function :" in line:
            inside = [k for k in kernels if k in line]
        else:
            for k in inside:
                counts[k] += "HGMMA" in line
    return counts


# --- phase 18: federated LM training (slice 13) -------------------------------------

LMT_BASE = "h2o-danube-3-4b"
LMT_ARCH = "h2o-danube-3-4b-2l"       # the published width, 2 of its 24 layers
LMT_LAYERS = 2
LMT_PARAMS = 555_436_800              # 2 x 122,880,000 embed / unembed + 3,840
                                      # final norm + 2 x 154,836,480 blocks
LMT_AGENTS, LMT_BATCH, LMT_SEQ, LMT_TAU, LMT_STEPS = 2, 2, 1024, 2, 6
LMT_LONG = (1, 4608)                  # the windowed step: W = 4096 binds
LMT_MID_ARCH = "h2o-danube-3-4b-mid"
# one layer (the CPU side's Adam over the rows dominates the phase's time)
LMT_MID = dict(n_layers=1, d_model=960, n_heads=8, n_kv_heads=2,
               head_dim=120, d_ff=2560, vocab_size=4096, sliding_window=64,
               param_dtype="float32", compute_dtype="float32")
# 2 steps (one period at tau 2): the plain Adam over 2 x 27.2 M fp32 rows
# takes ~1.1 s a step on the CPU, so 4 steps of 5 strategies took 31 s
LMT_MID_RUN = dict(n_agents=2, batch=1, seq=128, steps=2, tau=2)
LMT_MID_LOSS_ATOL = 1e-4              # fp32 card vs CPU: summation order
LMT_MID_PARAM_ATOL = 1e-4             # ... through 2 Adam steps at lr 3e-4
LMT_LONG_LOSS_REL = 2e-3              # bf16: kernel vs plain attention
LMT_LONG_GRAD_REL = 3e-2              # (relative L2 of the gradient row)
LSE_REL = 1e-5                        # |lse - plain| <= LSE_REL * max(1, |lse|)
BWD_REL = 1e-5                        # fp32: |dx - plain| <= BWD_REL * G
BWD_MAX_RATIO, BWD_MEAN_RATIO = 2.0, 1.1   # bf16: against float64, x plain's
BWD_FLOOR = 1e-6                      # ... + BWD_FLOOR * G (W = 1: grads ~ 0)
# The bf16 backward's two kernels (the profile's and the HGMMA count's
# names); the fp32 path runs swa_bwd_dq_kernel and swa_bwd_dkdv_kernel.
BWD_KERNELS = ("swa_bwd_dq_hopper_kernel", "swa_bwd_dkdv_hopper_kernel")
LMT_KERNELS = ("swa_attention", "swa_attention_bwd", "adam_update",
               "row_mean", "consensus_step")


def lmt_configs(TC):
    """The phase's two configurations, registered once (``dataclasses
    .replace`` of ``h2o-danube-3-4b`` and ``register_arch``, as
    ``examples/train_lm_federated.py`` registers its own): the published
    width cut to 2 layers, and the mid-size fp32 one held card vs CPU."""
    base = TC.get_arch(LMT_BASE)
    for name, kw in ((LMT_ARCH, {"n_layers": LMT_LAYERS}),
                     (LMT_MID_ARCH, LMT_MID)):
        if name not in TC.ARCH_REGISTRY:
            TC.register_arch(dataclasses.replace(base, name=name, **kw))
    return TC.get_arch(LMT_ARCH), TC.get_arch(LMT_MID_ARCH)


def lmt_strategies(FT, tau=LMT_TAU) -> list:
    """``(label, FedTrainConfig)`` of the main path: sync (every step),
    periodic, decay (lambda 0.98), consensus (eps 0.4, one round) and
    periodic with outer momentum 0.9."""
    return [("sync", FT(strategy="sync", tau=1)),
            ("periodic", FT(strategy="periodic", tau=tau)),
            ("decay", FT(strategy="decay", tau=tau, decay_lambda=0.98)),
            ("consensus", FT(strategy="consensus", tau=tau,
                             consensus_eps=0.4, consensus_rounds=1)),
            ("periodic+outer", FT(strategy="periodic", tau=tau,
                                  outer_momentum=0.9))]


def _lmtrain_expected(cfg, fed, n_agents, steps) -> dict:
    """Launches one ``train`` run implies, by kernel. Per local step and
    agent: one ``swa_attention`` forward per attention layer (two under
    ``cfg.remat``: the backward recomputes each layer) and one
    ``swa_attention_bwd``; per local step one ``adam_update`` over all
    rows. Per sync (every tau steps): one ``consensus_step`` for
    consensus, else one ``row_mean``; the outer momentum adds none."""
    from repro_torch.models.transformer import remat_layers
    attn = sum(1 for i in range(cfg.n_layers)
               if cfg.block_kind(i) in ("attn", "local"))
    recomputed = sum(1 for i in remat_layers(cfg)
                     if cfg.block_kind(i) in ("attn", "local")) \
        if cfg.remat else 0
    syncs = steps // fed.tau
    out = {k: 0 for k in LMT_KERNELS}
    out["swa_attention"] = steps * n_agents * (attn + recomputed)
    out["swa_attention_bwd"] = steps * n_agents * attn
    out["adam_update"] = steps
    out["consensus_step" if fed.strategy == "consensus" else "row_mean"] = \
        syncs
    return out


def _lmt_counts(km, sw, swb) -> dict:
    c = _kernel_counts(km)
    return {"swa_attention": sw.launches, "swa_attention_bwd": swb.launches,
            **{k: c[k] for k in LMT_KERNELS[2:]},
            "others": {k: v for k, v in c.items() if k not in LMT_KERNELS}}


def _lmt_reset(km, sw, swb) -> None:
    _reset_counts(km)
    sw.launches = swb.launches = 0


def bwd_inputs(b, s, h, kv, d, dtype, seed, sk=None):
    """q, k, v, do ~ N(0, 1) on the card (scores of unit scale); k and v
    hold ``sk`` rows (default s)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *sh: torch.randn(sh, generator=gen, device="cuda").to(dtype)
    sk = s if sk is None else sk
    return rnd(b, s, h, d), rnd(b, sk, kv, d), rnd(b, sk, kv, d), \
        rnd(b, s, h, d)


def bwd_check(sw, swb, q, k, v, do, window, what, causal=True) -> dict:
    """The forward's lse and the backward kernel against their plain
    versions on the card; raises on a break of the rules.

    lse: within LSE_REL * max(1, |lse|) of the plain version's. Backward,
    given the kernel forward's o and lse: fp32 within BWD_REL * G of the
    plain backward (G the largest |gradient| of the three); bf16 against
    the float64 gradient (float64 forward and backward on the same bf16
    values): each of dq, dk, dv within BWD_MAX_RATIO x the plain bf16
    version's largest error and BWD_MEAN_RATIO x its mean error, plus
    BWD_FLOOR * G (with W = 1, dq and dk are 0 up to rounding). A second
    launch must give the same bits. ``causal`` off: every key is seen."""
    kw = dict(window=window, causal=causal)
    o, lse = sw.swa_attention_cuda(q, k, v, with_lse=True, **kw)
    _, plse = sw.swa_attention_plain(q, k, v, with_lse=True, **kw)
    lse_err = float(((lse - plse).abs() / plse.abs().clamp(min=1.0)).max())
    if not lse_err <= LSE_REL:
        raise AssertionError(f"{what}: lse rel err {lse_err!r} > {LSE_REL}")
    got = swb.swa_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    again = swb.swa_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: a second launch gave other bits")
    plain = swb.swa_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    row = {"lse_rel_err": lse_err}
    if q.dtype == torch.float32:
        G = max(float(p.abs().max()) for p in plain)
        err = max(float((a - p).abs().max()) for a, p in zip(got, plain))
        if not err <= BWD_REL * G:
            raise AssertionError(f"{what}: fp32 grad err {err!r} > "
                                 f"{BWD_REL} x {G!r}")
        row.update(err=err, G=G, rel_err=err / G)
        return row
    x64 = [t.double() for t in (q, k, v, do)]
    o64, lse64 = sw.swa_attention_plain(*x64[:3], with_lse=True, **kw)
    want = swb.swa_attention_bwd_plain(*x64[:3], o64, x64[3], lse64, **kw)
    G = max(float(w.abs().max()) for w in want)
    for name, a, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        ea, ep = (a.double() - w).abs(), (p.double() - w).abs()
        lim_max = BWD_MAX_RATIO * float(ep.max()) + BWD_FLOOR * G
        lim_mean = BWD_MEAN_RATIO * float(ep.mean()) + BWD_FLOOR * G
        if not (float(ea.max()) <= lim_max and float(ea.mean()) <= lim_mean):
            raise AssertionError(
                f"{what} {name}: bf16 err max {float(ea.max())!r} / mean "
                f"{float(ea.mean())!r} beyond {lim_max!r} / {lim_mean!r} "
                f"(plain's {float(ep.max())!r} / {float(ep.mean())!r})")
        row[name] = {"err": float(ea.max()), "plain_err": float(ep.max()),
                     "mean_err": float(ea.mean()),
                     "plain_mean_err": float(ep.mean())}
    row.update(G=G, err=max(row[n]["err"] for n in ("dq", "dk", "dv")))
    return row


# Where the bf16 kernels' 64- and 128-row tiles end ragged (S 65, 129, 200,
# 255), a window crosses a tile (W 100, 200), H = KV; both head sizes.
BWD_EDGE_CASES = [(1, 129, 8, 8, 120, 100), (1, 255, 8, 8, 128, 200),
                  (1, 129, 24, 8, 128, 200), (1, 255, 32, 8, 120, 100),
                  (2, 200, 12, 4, 120, 100), (1, 65, 4, 4, 128, None)]


def bwd_vs_plain(sw, swb) -> dict:
    """Phase 18 (1, 2): lse and the backward kernel on the grid S in {1,
    127, 1024, 4608} x W in {None, 1, 64, 4096} x (32 / 8 heads of 120, 24
    / 8 of 128) x {fp32, bf16}, B = 1, the main path's (2, 1024) and the
    tile edges of ``BWD_EDGE_CASES``."""
    cases = [(1, s, h, kv, d, w) for s in (1, 127, 1024, 4608)
             for w in (None, 1, 64, 4096)
             for (h, kv, d) in ((32, 8, 120), (24, 8, 128))]
    cases.append((LMT_BATCH, LMT_SEQ, 32, 8, 120, 4096))
    cases += BWD_EDGE_CASES
    rows, worst = [], {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (b, s, h, kv, d, w) in enumerate(cases):
            q, k, v, do = bwd_inputs(b, s, h, kv, d, dtype, SEED + 180 + i)
            what = f"swa_attention_bwd ({b}, {s}, {h}/{kv}, {d}) W={w} {dtype}"
            row = bwd_check(sw, swb, q, k, v, do, w, what)
            row.update(shape=[b, s, h, kv, d], window=w,
                       dtype=str(dtype).split(".")[1])
            rows.append(row)
            worst[row["dtype"]] = max(worst[row["dtype"]], row["err"])
            del q, k, v, do
    torch.cuda.empty_cache()
    log(f"phase lm train: lse and swa_attention_bwd vs plain at {len(rows)} "
        f"cases ok (fp32 within {BWD_REL} x max |grad|; bf16 within "
        f"{BWD_MAX_RATIO} / {BWD_MEAN_RATIO} x the plain version's max / "
        f"mean error against float64 + {BWD_FLOOR} x max |grad|; lse within "
        f"{LSE_REL} relative; a second launch bitwise); largest |kernel - "
        f"reference| {worst}")
    return {"cases": rows, "worst": worst}


def _state_to(state, device):
    """A copy of a train state on ``device``."""
    mv = lambda t: None if t is None else t.to(device, copy=True)
    return dataclasses.replace(
        state, params=mv(state.params), grads=mv(state.grads),
        opt={k: mv(v) if isinstance(v, torch.Tensor) else v
             for k, v in state.opt.items()},
        anchor=mv(state.anchor), outer_m=mv(state.outer_m))


def lm_train_path(km, sw, swb, TC, TM, launch, card) -> dict:
    """Phase 18 (3): the main path. ``repro_torch.launch.train.train(...,
    device="cuda")`` on the 2-layer full-width h2o-danube-3-4b (555,436,800
    bf16 parameters an agent, A 2, B 2, S 1024) for 6 steps of each
    strategy; the counts are set to 0 before these runs and read after
    them. Checks: losses finite and lower at the end than at the start, the
    agent rows bitwise equal after the last sync (every strategy but
    consensus), launches exactly ``_lmtrain_expected`` per run, no build.
    Then, per strategy, one more period on the returned state through
    ``make_local_step`` / ``make_sync_step``, timed (tokens/s of a local
    step, sync ms); its launches count too, by the same formula for tau
    steps."""
    from repro_torch.kernels import _build
    from repro_torch.launch import train as T
    FT = launch.FedTrainConfig
    cfg, _ = lmt_configs(TC)
    builds = _build.n_builds
    runs, expected = [], {k: 0 for k in LMT_KERNELS}
    _lmt_reset(km, sw, swb)
    for label, fed in lmt_strategies(FT):
        before = _lmt_counts(km, sw, swb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, losses = T.train(LMT_ARCH, reduced=False, steps=LMT_STEPS,
                                fed=fed, n_agents=LMT_AGENTS,
                                batch=LMT_BATCH, seq=LMT_SEQ,
                                log_every=LMT_STEPS + 1, seed=SEED,
                                device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = _lmt_counts(km, sw, swb)
        got = {k: after[k] - before[k] for k in LMT_KERNELS}
        want = _lmtrain_expected(cfg, fed, LMT_AGENTS, LMT_STEPS)
        if got != want or after["others"] != before["others"]:
            raise AssertionError(f"lm train {label}: launches {got}, expected "
                                 f"{want} (others {after['others']})")
        period = _lmtrain_expected(cfg, fed, LMT_AGENTS, fed.tau)
        for k in LMT_KERNELS:
            expected[k] += want[k] + period[k]
        if state.layout.n != LMT_PARAMS:
            raise AssertionError(f"{LMT_ARCH}: {state.layout.n} parameters an "
                                 f"agent, expected {LMT_PARAMS}")
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"lm train {label}: losses {losses}")
        equal = bool(torch.equal(state.params[0], state.params[1]))
        if fed.strategy != "consensus" and not equal:
            raise AssertionError(f"lm train {label}: agent rows differ after "
                                 f"the sync")
        if not bool(torch.isfinite(state.params).all()):
            raise AssertionError(f"lm train {label}: non-finite parameters")
        timing = lmt_period_times(launch, cfg, fed, state)
        runs.append({"label": label, "strategy": fed.strategy,
                     "tau": fed.tau, "outer_momentum": fed.outer_momentum,
                     "losses": losses, "wall_s": wall, "launches": got,
                     "rows_equal_after_sync": equal, **timing})
        log(f"phase lm train: {label} (tau {fed.tau}): losses {losses[0]!r} "
            f"-> {losses[-1]!r}; train() {wall!r} s for {LMT_STEPS} steps "
            f"(init included); local step {timing['local_step_ms']!r} ms = "
            f"{timing['tokens_per_s']!r} tokens/s ({LMT_AGENTS} agents x "
            f"{LMT_BATCH} x {LMT_SEQ}), sync {timing['sync_ms']!r} ms; rows "
            f"equal {equal}; launches {got} card=\"{card}\"")
        del state
        torch.cuda.empty_cache()
    counts = _lmt_counts(km, sw, swb)
    launches = {k: counts[k] for k in LMT_KERNELS}
    if launches != expected:
        raise AssertionError(f"lm train: launches {launches} != {expected}")
    if _build.n_builds != builds:
        raise AssertionError("a build on the lm training hot path")
    log(f"phase lm train: main path launches {launches} (the formula's)")
    return {"arch": LMT_ARCH, "params_per_agent": LMT_PARAMS,
            "agents": LMT_AGENTS, "batch": LMT_BATCH, "seq": LMT_SEQ,
            "steps": LMT_STEPS, "runs": runs, "launches": launches}


def lmt_period_times(launch, cfg, fed, state, agents=LMT_AGENTS,
                     batch=LMT_BATCH, seq=LMT_SEQ, offset=LMT_STEPS) -> dict:
    """One more period on ``state`` (tau local steps on the batches of steps
    ``offset`` on, then the sync), each step and the sync timed by the host
    clock around work that ends in a synchronise. Every step's batch is the
    trainer's (``stub_batch``: an encoder-decoder model's frames, a VLM's
    patch embeddings and cut tokens); ``seq`` rows a sequence either way."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import stub_batch
    from repro_torch.optim import adamw
    local = launch.make_local_step(cfg, adamw(weight_decay=0.01), fed,
                                   n_agents=agents)
    sync = launch.make_sync_step(cfg, fed, n_agents=agents)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seed=SEED)
    times = []
    for j in range(fed.tau):
        toks = torch.from_numpy(np.stack([
            data.batch(offset + j, batch, seq + 1, agent=a)
            for a in range(agents)])).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        local(state, stub_batch(cfg, toks))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    sync(state)
    torch.cuda.synchronize()
    sync_ms = (time.perf_counter() - t0) * 1e3
    ms = statistics.median(times) * 1e3
    return {"local_step_ms": ms, "local_steps_ms": [x * 1e3 for x in times],
            "sync_ms": sync_ms,
            "tokens_per_s": agents * batch * seq / ms * 1e3,
            "tokens_per_s_per_agent": batch * seq / ms * 1e3}


def lmt_windowed_step(sw, TC, launch) -> dict:
    """Phase 18 (4): one local step of one agent at B 1 x S 4608 (W 4096
    binds) with the kernels, against the same step with the plain
    attention (``swa_impl``, differentiated by autograd): losses within
    LMT_LONG_LOSS_REL and the gradient rows within LMT_LONG_GRAD_REL in
    relative L2 (bf16: the two attentions round at other places)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import adamw
    FT = launch.FedTrainConfig
    cfg, _ = lmt_configs(TC)
    fed = FT(strategy="periodic", tau=LMT_TAU)
    opt = adamw(weight_decay=0.01)
    b, s = LMT_LONG
    toks = torch.from_numpy(SyntheticLM(vocab_size=cfg.vocab_size, seed=SEED)
                            .batch(0, b, s + 1)[None]).cuda()
    out = {}
    for name, impl in (("kernel", None), ("plain", sw.swa_attention_plain)):
        state = launch.init_train_state(cfg, SEED, 1, opt, fed, device="cuda")
        step = launch.make_local_step(cfg, opt, fed, n_agents=1,
                                      swa_impl=impl)
        _, m = step(state, {"tokens": toks})
        out[name] = (float(m["loss"]), state.grads[0].float().clone())
        del state
        torch.cuda.empty_cache()
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    grad_rel = float(torch.linalg.vector_norm(gk - gp)
                     / torch.linalg.vector_norm(gp))
    if not (loss_rel <= LMT_LONG_LOSS_REL and grad_rel <= LMT_LONG_GRAD_REL):
        raise AssertionError(f"lm train windowed step: loss {lk!r} vs {lp!r} "
                             f"(rel {loss_rel!r}), gradient rel L2 "
                             f"{grad_rel!r}")
    log(f"phase lm train: windowed step B {b} x S {s} (W 4096): loss kernel "
        f"{lk!r} vs plain {lp!r} (rel {loss_rel!r} <= {LMT_LONG_LOSS_REL}); "
        f"gradient row rel L2 {grad_rel!r} <= {LMT_LONG_GRAD_REL}")
    return {"shape": [b, s], "loss_kernel": lk, "loss_plain": lp,
            "loss_rel": loss_rel, "grad_rel_l2": grad_rel}


def lmt_mid_vs_cpu(TC, launch) -> dict:
    """Phase 18 (5): the mid-size fp32 config (d 960, 8 / 2 heads of 120,
    d_ff 2560, vocab 4096, W 64, 1 layer) through ``train`` on the card
    and on the CPU from one CPU-made state, A 2, B 1, S 128, tau 2, 2
    steps, every strategy: losses within LMT_MID_LOSS_ATOL, parameters
    within LMT_MID_PARAM_ATOL."""
    from repro_torch.launch import train as T
    from repro_torch.optim import adamw
    _, cfg = lmt_configs(TC)
    r = LMT_MID_RUN
    rows, cpu_s = [], 0.0
    for label, fed in lmt_strategies(launch.FedTrainConfig, tau=r["tau"]):
        init = launch.init_train_state(cfg, SEED, r["n_agents"],
                                       adamw(weight_decay=0.01), fed,
                                       device="cpu")
        res = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            st, losses = T.train(LMT_MID_ARCH, reduced=False,
                                 steps=r["steps"], fed=fed,
                                 n_agents=r["n_agents"], batch=r["batch"],
                                 seq=r["seq"], log_every=r["steps"] + 1,
                                 seed=SEED, device=dev,
                                 state=_state_to(init, dev))
            if dev == "cpu":
                cpu_s += time.perf_counter() - t0
            res[dev] = (losses, st.params.cpu())
        dl = max(abs(a - b) for a, b in zip(res["cuda"][0], res["cpu"][0]))
        dp = float((res["cuda"][1] - res["cpu"][1]).abs().max())
        if not (dl <= LMT_MID_LOSS_ATOL and dp <= LMT_MID_PARAM_ATOL):
            raise AssertionError(f"lm train mid {label}: card vs CPU losses "
                                 f"{dl!r}, parameters {dp!r}")
        rows.append({"label": label, "loss_diff": dl, "param_diff": dp,
                     "losses": res["cuda"][0]})
    log(f"phase lm train: mid config card vs CPU, {len(rows)} strategies: "
        f"largest loss diff {max(x['loss_diff'] for x in rows)!r} <= "
        f"{LMT_MID_LOSS_ATOL}, parameter diff "
        f"{max(x['param_diff'] for x in rows)!r} <= {LMT_MID_PARAM_ATOL}; "
        f"CPU side {cpu_s!r} s")
    return {"runs": rows, "cpu_seconds": cpu_s}


def bwd_bound(b, s, h, kv, d, window, sk=None, causal=True) -> dict:
    """The least time of the backward on bf16 inputs: the larger of its
    bytes (q, o, do, k, v and the fp32 lse read once, dq, dk, dv written
    once) over the HBM rate and the FLOP of its five products (s, dp, dv,
    dq, dk: 2 * D each per unmasked pair) over the bf16 tensor cores'
    peak. ``sk`` keys (default s), the mask ``causal`` or not."""
    sk = s if sk is None else sk
    pairs = swa_pairs(b, s, sk, h, window, causal)
    nbytes = 2 * d * (4 * b * s * h + 4 * b * sk * kv) + 4 * b * h * s
    flops = 10 * d * pairs
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / BF16_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": nbytes, "flops": flops, "pairs": pairs}


def sdpa_bwd_fn(q, k, v, do, window, causal=True):
    """The library yardstick: the autograd backward of one
    ``scaled_dot_product_attention`` call on K/V repeated to the query
    heads (``_sdpa_args``), timed alone (the forward runs once, here)."""
    import torch.nn.functional as F
    qt, kt, vt, kw = _sdpa_args(q, k, v, window, causal)
    leaves = [t.detach().contiguous().requires_grad_() for t in (qt, kt, vt)]
    o = F.scaled_dot_product_attention(*leaves, **kw)
    g = do.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(o, leaves, g, retain_graph=True)


def lmt_times(sw, swb, TC, launch, card) -> dict:
    """Phase 18 (6, 7): ``bwd_times``; then one profiled window of 2 local
    steps and a sync (periodic, tau 2) at full width: the device idle share
    and the busy time split between the matrix products, swa_attention,
    swa_attention_bwd (and its two kernels), adam_update and the sync; then
    ``lmt_flat_times``."""
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import adamw
    from torch.profiler import ProfilerActivity, profile
    cyc = sleep_cycles_per_ms()
    flush = l2_flusher()
    rows = bwd_times(sw, swb, cyc, flush, card)

    cfg, _ = lmt_configs(TC)
    fed = launch.FedTrainConfig(strategy="periodic", tau=LMT_TAU)
    opt = adamw(weight_decay=0.01)
    state = launch.init_train_state(cfg, SEED, LMT_AGENTS, opt, fed,
                                    device="cuda")
    local = launch.make_local_step(cfg, opt, fed, n_agents=LMT_AGENTS)
    sync = launch.make_sync_step(cfg, fed, n_agents=LMT_AGENTS)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seed=SEED)
    toks = [torch.from_numpy(np.stack([data.batch(j, LMT_BATCH, LMT_SEQ + 1,
                                                  agent=a)
                                       for a in range(LMT_AGENTS)])).cuda()
            for j in range(LMT_TAU)]
    local(state, {"tokens": toks[0]})              # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for j in range(LMT_TAU):
            local(state, {"tokens": toks[j]})
        sync(state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = _device_ops(prof)
    busy = sum(t for _, t in dev.values())
    if busy <= 0:
        raise AssertionError("lm train profile: no device time")
    pick = lambda *names: sum(t for k, (_, t) in dev.items()
                              if any(n in k for n in names))
    split = {"matmul": _matmul_us(dev) / 1e3,
             "swa_attention": pick("swa_attention_hopper_kernel",
                                   "swa_attention_kernel") / 1e3,
             "swa_attention_bwd": pick(*BWD_KERNELS) / 1e3,
             "swa_attention_bwd_dq": pick(BWD_KERNELS[0]) / 1e3,
             "swa_attention_bwd_dkdv": pick(BWD_KERNELS[1]) / 1e3,
             "adam_update": pick("adam_update_kernel") / 1e3,
             "sync": pick("row_mean_kernel") / 1e3}
    split["other"] = busy / 1e3 - sum(
        v for k, v in split.items() if k not in ("swa_attention_bwd_dq",
                                                 "swa_attention_bwd_dkdv"))
    top = sorted(dev.items(), key=lambda kv_: -kv_[1][1])[:8]
    prof_row = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
                "device_idle_share": 1.0 - busy / wall_us,
                "device_ms": split,
                "top_ops": [[k[:80], c, t / 1e3] for k, (c, t) in top]}
    log(f"profile lm train: {LMT_TAU} local steps + sync (periodic, A "
        f"{LMT_AGENTS} x {LMT_BATCH} x {LMT_SEQ}): wall "
        f"{prof_row['wall_ms']!r} ms, device busy "
        f"{prof_row['device_busy_ms']!r} ms, idle share "
        f"{prof_row['device_idle_share']!r}; device ms by part {split}; top "
        f"{prof_row['top_ops']} card=\"{card}\"")
    del state
    torch.cuda.empty_cache()
    rows["profile"] = prof_row
    rows["flat"] = lmt_flat_times(cyc, flush, card)
    return rows


def _fused_adamw_fn(p, g, w, mu, nu, lr, t, wd):
    """``torch._fused_adamw_`` (the call behind ``torch.optim.AdamW(
    fused=True)``) on the rows of ``p`` and ``g``, with moments in the dtype
    of ``mu`` / ``nu``, step ``t`` and one ``grad_scale`` = 1 / the first
    row's clip weight (it takes one for all rows and divides by it)."""
    rows = lambda x: list(x.unbind(0))
    steps = [torch.full((), float(t), device=p.device) for _ in range(len(p))]
    scale = (1.0 / w[0]).reshape(())
    return lambda: torch._fused_adamw_(
        rows(p), rows(g), rows(mu), rows(nu), [], steps, lr=lr, beta1=0.9,
        beta2=0.95, weight_decay=wd, eps=1e-8, amsgrad=False, maximize=False,
        grad_scale=scale, found_inf=None)


def lmt_flat_times(cyc, flush, card) -> dict:
    """Phase 18 (7): rows 2 and 4 of the kernel table where phase 18 runs
    them, (2, 555,436,800) bf16 rows, with their byte bounds and library
    calls: ``row_mean`` (reads both rows, writes the bf16 mean: 6 bytes a
    column) beside ``x.mean(0)``; ``adam_update`` in place (bf16 p and g,
    fp32 mu and nu, per-row clip weight: 22 bytes an element) beside
    ``torch._fused_adamw_`` on the same rows (fp32 moments where it takes
    them, else bf16 ones: the record says which), and both again at the
    training path's (1024, 9347) fp32, L2 flushed. CUDA events; at 3-24 GB
    a call the L2 plays no part, so the LM-shape calls are not flushed."""
    from repro_torch.kernels import flat_update as fu
    n = LMT_PARAMS
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 187)
    x = torch.randn((LMT_AGENTS, n), generator=gen, device="cuda",
                    dtype=torch.float32).to(torch.bfloat16)
    rec = {"shape": [LMT_AGENTS, n], "dtype": "bfloat16",
           "ms": device_ms(lambda: fu.row_mean_cuda(x), cyc, None, CHUNK)[0],
           "library_ms": device_ms(lambda: x.mean(0), cyc, None, CHUNK)[0],
           "library": "x.mean(0)",
           "bytes": 3 * 2 * n}
    rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    out["row_mean"] = rec
    g = torch.randn((LMT_AGENTS, n), generator=gen, device="cuda",
                    dtype=torch.float32).to(torch.bfloat16).mul_(1e-3)
    mu = torch.zeros((LMT_AGENTS, n), device="cuda")
    nu = torch.zeros((LMT_AGENTS, n), device="cuda")
    w = torch.tensor([0.5, 0.25], device="cuda")
    lr, t, wd = 3e-4, 3, 0.01
    bc1, bc2 = 1.0 - 0.9 ** t, 1.0 - 0.95 ** t

    def adam(p_, g_, mu_, nu_, w_):
        return lambda: fu.adam_update_cuda(
            p_, g_, mu_, nu_, w_, lr, bc1, bc2, b1=0.9, b2=0.95, eps=1e-8,
            weight_decay=wd, p_out=p_, mu_out=mu_, nu_out=nu_)

    rec = {"shape": [LMT_AGENTS, n], "dtype": "bfloat16 p, g; fp32 moments",
           "ms": device_ms(adam(x, g, mu, nu, w), cyc, None, CHUNK)[0],
           "bytes": 22 * LMT_AGENTS * n}
    rec["bound_ms"] = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    try:
        rec["library_ms"] = device_ms(_fused_adamw_fn(x, g, w, mu, nu, lr, t,
                                                      wd), cyc, None, CHUNK)[0]
        rec["library"] = "torch._fused_adamw_, fp32 moments"
    except (RuntimeError, TypeError) as e:
        rec["library_refused"] = str(e).splitlines()[0][:200]
        mu16, nu16 = mu.to(torch.bfloat16), nu.to(torch.bfloat16)
        rec["library_bf16_moments_ms"] = device_ms(
            _fused_adamw_fn(x, g, w, mu16, nu16, lr, t, wd), cyc, None,
            CHUNK)[0]
        rec["library_ms"] = None
        rec["library"] = ("none: torch._fused_adamw_ refuses fp32 moments "
                          "beside bf16 parameters; timed with bf16 moments")
        del mu16, nu16
    out["adam_update"] = rec
    del x, g, mu, nu
    torch.cuda.empty_cache()
    m_, n_ = 1024, 9347
    p32 = torch.randn((m_, n_), generator=gen, device="cuda")
    g32 = torch.randn((m_, n_), generator=gen, device="cuda") * 1e-3
    mu32, nu32 = torch.zeros_like(p32), torch.zeros_like(p32)
    w32 = torch.full((m_,), 0.5, device="cuda")
    out["adam_update_1024"] = {
        "shape": [m_, n_], "dtype": "float32",
        "ms": device_ms(adam(p32, g32, mu32, nu32, w32), cyc, flush)[0],
        "library_ms": device_ms(_fused_adamw_fn(p32, g32, w32, mu32, nu32,
                                                lr, t, wd), cyc, flush)[0],
        "library": "torch._fused_adamw_, one grad_scale for all rows",
        "bytes": 28 * m_ * n_}
    out["adam_update_1024"]["bound_ms"] = \
        out["adam_update_1024"]["bytes"] / HBM_BYTES_PER_S * 1e3
    for k, r in out.items():
        log(f"time {k} at {r['shape']} {r['dtype']}: kernel_ms={r['ms']!r} "
            f"bound_ms={r['bound_ms']!r} (bytes) library_ms="
            f"{r['library_ms']!r} ({r['library']}"
            + (f"; refused: {r['library_refused']}; bf16 moments "
               f"{r['library_bf16_moments_ms']!r} ms"
               if "library_refused" in r else "") + f") card=\"{card}\"")
    del p32, g32, mu32, nu32
    torch.cuda.empty_cache()
    return out


def bwd_times(sw, swb, cyc, flush, card) -> dict:
    """swa_attention_bwd in bf16 at the main path's (2, 1024) and at (1,
    4608), W 4096: CUDA events, L2 flushed and warm, beside its bound, the
    plain backward's time (one call) and SDPA's backward."""
    rows = {}
    for b, s in ((LMT_BATCH, LMT_SEQ), LMT_LONG):
        q, k, v, do = bwd_inputs(b, s, 32, 8, 120, torch.bfloat16, SEED + 18)
        o, lse = sw.swa_attention_cuda(q, k, v, window=4096, with_lse=True)
        kern = lambda: swb.swa_attention_bwd_cuda(q, k, v, o, do, lse,
                                                  window=4096)
        plain = lambda: swb.swa_attention_bwd_plain(q, k, v, o, do, lse,
                                                    window=4096)
        lib = sdpa_bwd_fn(q, k, v, do, 4096)
        n_ev = CHUNK * (2 if s <= LMT_SEQ else 1)
        rec = {"shape": [b, s, 32, 8, 120], "window": 4096,
               "dtype": "bfloat16",
               "ms": device_ms(kern, cyc, flush, n_ev)[0],
               "warm_l2_ms": device_ms(kern, cyc, None, n_ev)[0],
               "plain_ms": events_ms(plain, 1),
               "library_ms": device_ms(lib, cyc, flush, n_ev)[0],
               "library_backend": sdpa_backend_of(q, k, v, 4096),
               **bwd_bound(b, s, 32, 8, 120, 4096)}
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rows[f"swa_attention_bwd/{b}x{s}"] = rec
        log(f"time swa_attention_bwd shape=({b}, {s}, 32/8, 120) bf16 W=4096 "
            f"L2 flushed: kernel_ms={rec['ms']!r} (L2-warm "
            f"{rec['warm_l2_ms']!r}) plain_ms={rec['plain_ms']!r} "
            f"bound_ms={rec['bound_ms']!r} ({rec['bound_by']}; "
            f"{rec['flops']} FLOP at {BF16_FLOP_PER_S / 1e12:g} TFLOP/s, "
            f"{rec['bytes']} B at {HBM_BYTES_PER_S / 1e12:g} TB/s; share "
            f"{rec['share_of_bound']!r}) library_ms={rec['library_ms']!r} "
            f"(SDPA backward, {rec['library_backend']} forward choice) "
            f"card=\"{card}\"")
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return rows


def bwd_alone() -> dict:
    """The backward's times alone (``python3 -c 'import chip_smoke as c;
    c.bwd_alone()'``): builds the kernels, then ``bwd_times``. Run from a
    checkout of another commit (this file copied into it) and from this one
    in turns to compare two kernels in one chip call."""
    if not torch.cuda.is_available():
        raise SystemExit("bwd_alone: no CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.kernels import swa_attention_bwd as swb
    card = card_line()
    _build.load()
    return bwd_times(sw, swb, sleep_cycles_per_ms(), l2_flusher(), card)


def lm_train_phase(km, sw, swb, TC, TM, launch, card) -> dict:
    """Phase 18: (1, 2) lse and the backward kernel vs plain, (3) the main
    path, (4) the windowed step, (5) the mid config card vs CPU, (6)
    times."""
    t0 = time.perf_counter()
    parts, lap = {}, [t0]

    def done(name):
        parts[name] = time.perf_counter() - lap[0]
        lap[0] = time.perf_counter()

    out = {"bwd_parity": bwd_vs_plain(sw, swb)}
    done("bwd_parity")
    out["main"] = lm_train_path(km, sw, swb, TC, TM, launch, card)
    done("main")
    out["windowed"] = lmt_windowed_step(sw, TC, launch)
    done("windowed")
    out["mid_vs_cpu"] = lmt_mid_vs_cpu(TC, launch)
    done("mid_vs_cpu")
    out["times"] = lmt_times(sw, swb, TC, launch, card)
    done("times")
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    log(f"phase lm train: {out['seconds']!r} s; by part {parts}")
    return out


def lm_train_alone() -> dict:
    """Phase 18 without the rest of the script (``python3 -c 'import
    chip_smoke as c; c.lm_train_alone()'``): builds the kernels, then the
    LM training phase."""
    if not torch.cuda.is_available():
        raise SystemExit("lm_train_alone: no CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import configs as TC
    from repro_torch import launch
    from repro_torch import models as TM
    from repro_torch.kernels import _build
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.kernels import swa_attention_bwd as swb
    km, _, _, _ = _sweep_modules()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card {card}")
    _build.load()
    return lm_train_phase(km, sw, swb, TC, TM, launch, card)


# --- phase 19: head-256 serving (slice 15) -----------------------------------------

HD_ARCHS = ("gemma-7b", "recurrentgemma-9b")
# Depth served: 7 of gemma-7b's 28 layers and 14 of recurrentgemma-9b's 38
# (4 cycles of (rglru, rglru, local) and a tail of 2), cut from full depth
# when phase 23 came; the width is the published one.
# Phase 24 serves qwen2-72b (head 128, QKV bias) by the same path, 4 of
# its 80 layers (~145 GB of bf16 at full depth).
HD_LAYERS = {"gemma-7b": 7, "recurrentgemma-9b": 14, "qwen2-72b": 4}
# the trees' counts at that depth (at full depth, 8,537,680,896,
# 9,396,408,320 and 72,706,203,648: the JAX init trees',
# tests/test_torch_head256.py and tests/test_torch_vlm.py)
HD_PARAMS = {"gemma-7b": 2_724_246_528, "recurrentgemma-9b": 4_144_418_816,
             "qwen2-72b": 6_002_163_712}
HD_PREFILL = ((8, 512), (1, 8192))    # (B, T) of the prefill step
HD_TIMED = 1                          # timed prefill calls per shape
HD_DECODE_TOKENS = 16
HD_NEW = (16, 32)                     # new tokens of a loop request
HD_LONG_PROMPT = 2100                 # recurrentgemma request 0: past W = 2048
HD_MAX_SEQ = {"gemma-7b": 640, "recurrentgemma-9b": 2240, "qwen2-72b": 640}
HD_CHECKED = 4                        # every 4th completion held to B = 1
# the D = 256 kernel vs plain: B 1, 16 query heads, Sq = Sk
HD_SQ = (1, 63, 64, 65, 127, 128, 129, 200)
HD_WINDOWS = (None, 2048, 40)
HD_KV = (1, 16)
# timed: (model, B, T, KV heads, window) at the three prefill calls
HD_TIMES = (("gemma-7b", 8, 512, 16, None), ("gemma-7b", 1, 8192, 16, None),
            ("recurrentgemma-9b", 1, 8192, 1, 2048))
PHI4_ARCH = "phi4-mini-3.8b"
PHI4_PARAMS = 3_836_021_760           # tests/test_torch_attention.py
PHI4_REQUESTS = 8
PHI4_PROMPT = (16, 256)
PHI4_NEW = (16, 32)
PHI4_MAX_SEQ = 320


def hd_vs_plain(sw) -> dict:
    """The D = 256 kernels against the plain version on the card: fp32 and
    bf16, Sq = Sk in ``HD_SQ`` (the 64- and 128-row tile edges), windows
    ``HD_WINDOWS``, 1 and 16 KV heads under 16 query heads, by phase 12's
    rules (``swa_check``; the bf16 mean rule's control required wherever a
    row sees more than one key, i.e. Sq > 1 and W > 1); each call repeated
    and held bitwise to the first; the lse (``with_lse``) against the plain
    version's at two shapes."""
    rows, worst = [], {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for n, (sq, window, kv) in enumerate(
                (s, w, k) for s in HD_SQ for w in HD_WINDOWS for k in HD_KV):
            q, k, v = swa_inputs(1, sq, sq, 16, kv, 256, dtype, SEED + 190 + n)
            got = sw.swa_attention_cuda(q, k, v, window=window)
            again = sw.swa_attention_cuda(q, k, v, window=window)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"swa_attention D=256 {name} Sq {sq} "
                                     f"W {window} KV {kv}: repeats differ")
            row = {"sq": sq, "window": window, "kv": kv, "dtype": name}
            row.update(swa_check(sw, q, k, v, got, window, True,
                                 f"swa_attention D=256 Sq {sq} W {window} KV "
                                 f"{kv} {name}", control=sq > 1))
            worst[name] = max(worst[name], row["err"])
            rows.append(row)
    lse_err = 0.0
    for sq, window in ((200, 40), (129, None)):
        q, k, v = swa_inputs(1, sq, sq, 16, 1, 256, torch.bfloat16, SEED + 199)
        _, lse = sw.swa_attention_cuda(q, k, v, window=window, with_lse=True)
        _, plse = sw.swa_attention_plain(q, k, v, window=window,
                                         with_lse=True)
        lse_err = max(lse_err, float(((lse - plse).abs()
                                      / plse.abs().clamp(min=1.0)).max()))
    if not lse_err <= LSE_REL:
        raise AssertionError(f"swa_attention D=256 lse: rel err {lse_err!r}")
    out = {"cases": rows, "worst": worst, "lse_rel_err": lse_err,
           **_mean_ratios([r for r in rows if r["sq"] > 1])}
    log(f"phase head256 kernel vs plain: {len(rows)} cases ok (D 256, Sq "
        f"{HD_SQ}, W {HD_WINDOWS}, KV {HD_KV} of 16 heads), each repeated "
        f"bitwise; max abs err vs float64: fp32 {worst['float32']!r}, bf16 "
        f"{worst['bfloat16']!r} (phase 12's rule); bf16 mean err / plain's at "
        f"most {out['mean_ratio_max']!r} (rule <= {SWA_MEAN_RATIO}), the "
        f"control (one bf16 p) at least {out['control_ratio_min']!r}; lse "
        f"rel err {lse_err!r} (rule <= {LSE_REL})")
    return out


def hd_layer_vs_plain(sw, TM, cfg, params, toks) -> dict:
    """One prefill of ``toks`` in which the first attention layer's q, k, v
    are kept; then the kernel on them against the plain version by phase
    12's rules (the control not required, as in phase 13)."""
    seen = []

    def keep_first(q, k, v, *, window, causal):
        if not seen:
            seen.append((q, k, v, window, causal))
        return sw.swa_attention_cuda(q, k, v, window=window, causal=causal)

    TM.prefill(cfg, params, toks, swa_impl=keep_first)
    q, k, v, window, causal = seen[0]
    got = sw.swa_attention_cuda(q, k, v, window=window, causal=causal)
    row = {"shape": list(q.shape), "kv": k.shape[2], "window": window}
    row.update(swa_check(sw, q, k, v, got, window, causal,
                         f"{cfg.name} {tuple(toks.shape)} layer q/k/v",
                         control=False))
    del seen
    torch.cuda.empty_cache()
    return row


def _hd_profile(TM, launch, cfg, params, rg) -> dict:
    """``profile_prefill`` of one 1 x 8192 prefill call and, for an rglru
    model, the RG-LRU scan's share of its busy time: ``rglru_scan`` timed
    alone by CUDA events at the prefill's (1, 8192, W) fp32 inputs, times
    the model's rglru layers, over the busy time."""
    toks = _prompt_tokens(np.random.default_rng(SEED + 191), cfg,
                          *HD_PREFILL[1])
    n_attn = sum(cfg.block_kind(i) in ("attn", "local")
                 for i in range(cfg.n_layers))
    out = profile_prefill(launch.make_prefill_step(cfg), params, toks,
                          n_attn)
    if rg is not None:
        n_rg = cfg.n_layers - n_attn
        gen = torch.Generator(device="cuda").manual_seed(SEED + 192)
        shape = (1, HD_PREFILL[1][1], cfg.lru_dim)
        a_log = -8.0 * torch.rand(shape, generator=gen, device="cuda")
        x = torch.randn(shape, generator=gen, device="cuda")
        h0 = torch.zeros(shape[0], shape[2], device="cuda")
        scan_ms = events_ms(lambda: rg.rglru_scan(a_log, x, h0), 5)
        out.update(rglru_layers=n_rg, rglru_scan_ms=scan_ms,
                   rglru_scan_share_of_busy=n_rg * scan_ms
                   / out["device_busy_ms"])
    return out


def hd_serving_path(sw, _build, TC, TM, launch, card, arch) -> dict:
    """One model of HD_LAYERS (the head-256 models; qwen2-72b at head 128
    since phase 24) at full width, HD_LAYERS deep, seeded bf16 weights
    on the card, through the user's entry points: ``make_prefill_step`` at
    8 x 512 and 1 x 8192, ``make_serve_step`` for HD_DECODE_TOKENS tokens at
    B = 8, and a ``ServingLoop`` of 8 slots over 16 requests (for
    recurrentgemma-9b request 0's prompt of HD_LONG_PROMPT tokens wraps its
    ring of 2048). The swa_attention counter is set to 0 before this main
    path and read after it: one launch per attention layer per prefill call
    and admission (7 for gemma-7b, 4 for recurrentgemma-9b), none per
    decode step, no build. Then the checks: every HD_CHECKED-th completion
    against single-request greedy decoding (bf16 near-ties counted as in
    phases 10 and 13), an admission against the other slots' rows of every
    state leaf (K/V, positions, the RG-LRU ``h`` and conv inputs), the
    kernel against the plain version on the first attention layer's q, k, v
    at both prefill shapes; then a profiled 1 x 8192 prefill."""
    from repro_torch.models import rglru
    cfg = dataclasses.replace(TC.get_arch(arch), n_layers=HD_LAYERS[arch])
    n_attn = sum(cfg.block_kind(i) in ("attn", "local")
                 for i in range(cfg.n_layers))
    rng = np.random.default_rng(SEED + 193 + list(HD_LAYERS).index(arch))
    t0 = time.perf_counter()
    params = TM.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = TM.count_params(params)
    if n_params != HD_PARAMS[arch]:
        raise AssertionError(f"{arch}: {n_params} parameters, expected "
                             f"{HD_PARAMS[arch]}")
    prefill_step = launch.make_prefill_step(cfg)
    serve_step = launch.make_serve_step(cfg)
    max_seq = HD_MAX_SEQ[arch]
    reqs = _requests(rng, launch, cfg, long_prompt=HD_LONG_PROMPT
                        if cfg.sliding_window else None, new=HD_NEW)
    builds = _build.n_builds
    out = {"arch": arch, "params": n_params, "init_s": init_s,
           "init_peak_gb": init_peak / 1e9, "attention_layers": n_attn,
           "layers": cfg.n_layers, "prefill": {}}

    # --- the main path, counted ---
    sw.launches = 0
    for b, t in HD_PREFILL:
        toks = _prompt_tokens(rng, cfg, b, t)
        secs = []
        for _ in range(1 + HD_TIMED):
            before = sw.launches
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, states = prefill_step(params, {"tokens": toks})
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            if sw.launches - before != n_attn:
                raise AssertionError(f"{arch} prefill {b}x{t}: "
                                     f"{sw.launches - before} swa_attention "
                                     f"launches, expected {n_attn}")
        if tuple(logits.shape) != (b, 1, TM.padded_vocab(cfg)) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch} prefill {b}x{t}: bad logits")
        med = statistics.median(secs[1:])
        out["prefill"][f"{b}x{t}"] = {"first_s": secs[0], "median_s": med,
                                      "tokens_per_s": b * t / med}
        if b == LM_SLOTS:
            dec_logits, dec_states = logits, states
        del states, logits
    tok = dec_logits.argmax(-1)
    pos = torch.full((LM_SLOTS,), HD_PREFILL[0][1], device="cuda")
    before = sw.launches
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(HD_DECODE_TOKENS):
        logits, dec_states = serve_step(params, tok, dec_states, pos + i)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t1
    if sw.launches != before or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} decode: {sw.launches - before} "
                             f"swa_attention launches, expected 0")
    out["decode"] = {"batch": LM_SLOTS, "steps": HD_DECODE_TOKENS,
                     "seconds": dec_s,
                     "tokens_per_s": LM_SLOTS * HD_DECODE_TOKENS / dec_s}
    del dec_states, dec_logits
    loop = launch.ServingLoop(cfg, params, n_slots=LM_SLOTS, max_seq=max_seq)
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
        raise AssertionError(f"an nvcc build ran on the {arch} serving path")
    if loop_launches != n_attn * loop.n_prefills:
        raise AssertionError(f"{arch} ServingLoop: {loop_launches} "
                             f"swa_attention launches for {loop.n_prefills} "
                             f"prefills of {n_attn} attention layers")
    got = {c.rid: c.tokens for c in done}
    if sorted(got) != list(range(len(reqs))) or any(
            len(got[r.rid]) != r.max_new_tokens for r in reqs):
        raise AssertionError(f"{arch} ServingLoop: missing or short "
                             f"completions")
    n_tok = sum(len(c.tokens) for c in done)
    out["loop"] = {"slots": LM_SLOTS, "requests": len(reqs),
                   "max_seq": max_seq,
                   "prompt_tokens": int(sum(len(r.prompt) for r in reqs)),
                   "new_tokens": n_tok, "seconds": loop_s,
                   "tokens_per_s": n_tok / loop_s,
                   "prefills": loop.n_prefills, "steps": loop.n_steps,
                   "launches": loop_launches}
    out["launches"] = launches
    out["launches_per_prefill_call"], out["launches_per_decode_step"] = \
        n_attn, 0
    del loop
    log(f"phase serving: {arch} {n_params} params bf16 ({cfg.n_layers} of "
        f"{TC.get_arch(arch).n_layers} layers, {n_attn} attention, "
        f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.head_dim}) init "
        f"{init_s!r} s, peak "
        f"{out['init_peak_gb']!r} GB; prefill tokens/s " + ", ".join(
            f"{k}: {v['tokens_per_s']!r}" for k, v in out["prefill"].items())
        + f"; decode B={LM_SLOTS} tokens/s {out['decode']['tokens_per_s']!r}; "
        f"ServingLoop {LM_SLOTS} slots x {len(reqs)} requests, max_seq "
        f"{max_seq} ({out['loop']['prompt_tokens']} prompt + {n_tok} new "
        f"tokens, {out['loop']['prefills']} prefills, {out['loop']['steps']} "
        f"steps) "
        f"{out['loop']['tokens_per_s']!r} new tokens/s; swa_attention "
        f"launches {launches} ({n_attn} per prefill call, 0 per decode step; "
        f"no build) card=\"{card}\"")

    out["check_seconds"], t_chk = {}, [time.perf_counter()]

    def checked(name):
        now = time.perf_counter()
        out["check_seconds"][name] = now - t_chk[0]
        t_chk[0] = now

    near_tie = lambda best: LM_BF16_ULPS * bf16_ulp(best)
    checks = [lm_greedy_check(TM, cfg, params, r, got[r.rid], near_tie,
                              cache_len=max_seq) for r in reqs[::HD_CHECKED]]
    ties = [t for c in checks for t in c["ties"]]
    out["loop_vs_single_request"] = {
        "requests": len(checks),
        "positions": sum(c["positions"] for c in checks),
        "min_top2_margin": min(c["min_margin"] for c in checks),
        "equal_requests": sum(not c["ties"] for c in checks),
        "near_ties": ties}
    log(f"check {arch} ServingLoop bf16: every token of {len(checks)} of the "
        f"{len(reqs)} completions (ids {[r.rid for r in reqs[::HD_CHECKED]]}"
        f", {out['loop_vs_single_request']['positions']} positions) is "
        f"single-request greedy on the card or a near-tie; "
        f"{out['loop_vs_single_request']['equal_requests']} equal outright; "
        f"{len(ties)} near-ties (within {LM_BF16_ULPS} bf16 ulp of the max)")
    checked("loop_vs_single_request_bf16")
    adm, _, _ = admission_rows(TM, launch, cfg, params, reqs, max_seq)
    out["admission"] = {"slots_unchanged": LM_SLOTS - 1,
                        "state_keys": _state_keys(adm.state)}
    if cfg.sliding_window:
        cache = adm.state["local"]["cache"]["pos"]
        out["admission"]["slot0_ring_slots_filled"] = int(
            (cache[:, 0] >= 0).sum()) // cache.shape[0]
    log(f"check {arch} admission: {LM_SLOTS - 1} other slots' rows of every "
        f"state leaf ({out['admission']['state_keys']}) bitwise unchanged "
        f"and the new slot's equal to a B = 1 prefill" + (
            f"; slot 0 holds request 0's {HD_LONG_PROMPT - 1}-token prefill "
            f"in {out['admission']['slot0_ring_slots_filled']} of "
            f"{cfg.sliding_window} ring slots" if cfg.sliding_window else ""))
    del adm
    checked("admission")
    out["layer_vs_plain"] = {
        f"{b}x{t}": hd_layer_vs_plain(sw, TM, cfg, params,
                                      _prompt_tokens(rng, cfg, b, t))
        for b, t in HD_PREFILL}
    log(f"check {arch} kernel vs plain on the first attention layer's q, k, "
        f"v: " + "; ".join(f"{k}: max err {v['err']!r}, mean err / plain's "
                           f"{v['mean_err'] / v['plain_mean_err']!r}"
                           for k, v in out["layer_vs_plain"].items()))
    checked("layer_vs_plain")
    out["profile"] = _hd_profile(TM, launch, cfg, params,
                                 rglru if "rglru" in cfg.layer_pattern
                                 else None)
    pr = out["profile"]
    log(f"profile {arch} prefill 1 x {HD_PREFILL[1][1]}: wall_ms="
        f"{pr['wall_ms']!r} device_busy_ms={pr['device_busy_ms']!r} "
        f"device_idle_share={pr['device_idle_share']!r} swa_attention_ms="
        f"{pr['swa_attention_ms']!r} ({pr['swa_attention_launches']} "
        f"launches, share of busy {pr['swa_share_of_busy']!r}) matmul share "
        f"{pr['matmul_share_of_busy']!r}" + (
            f"; rglru_scan {pr['rglru_scan_ms']!r} ms a layer x "
            f"{pr['rglru_layers']} layers = share of busy "
            f"{pr['rglru_scan_share_of_busy']!r}" if "rglru_scan_ms" in pr
            else "") + f" card=\"{card}\"")
    checked("profile")
    log(f"phase serving {arch}: seconds by check {out['check_seconds']}")
    del params
    torch.cuda.empty_cache()
    return out


def _state_keys(state) -> list:
    """The leaf names of a decode state, e.g. ['local/cache/k', ...]."""
    if isinstance(state, dict):
        return [f"{k}/{x}" if x else k for k in sorted(state)
                for x in (_state_keys(state[k]) or [""])]
    return []


def phi4_serving(sw, _build, TC, TM, launch, card) -> dict:
    """phi4-mini-3.8b at full width and depth (32 global attention layers of
    24 / 8 heads of 128, tied embeddings), seeded bf16 weights: a counted
    prefill step at 8 x 512 and a ``ServingLoop`` of 8 slots over
    PHI4_REQUESTS requests at max_seq PHI4_MAX_SEQ, every second completion
    held to single-request greedy decoding whose cache is sized with
    ``prefill(cache_len=max_seq)`` (ROADMAP Queue C 3)."""
    cfg = TC.get_arch(PHI4_ARCH)
    rng = np.random.default_rng(SEED + 195)
    params = TM.init_params(cfg, seed=SEED, device="cuda")
    n_params = TM.count_params(params)
    if n_params != PHI4_PARAMS:
        raise AssertionError(f"{PHI4_ARCH}: {n_params} parameters, expected "
                             f"{PHI4_PARAMS}")
    L = cfg.n_layers
    prefill_step = launch.make_prefill_step(cfg)
    reqs = _requests(rng, launch, cfg, n=PHI4_REQUESTS, prompt=PHI4_PROMPT,
                     new=PHI4_NEW)
    b, t = HD_PREFILL[0]
    toks = _prompt_tokens(rng, cfg, b, t)
    # --- the main path, counted ---
    sw.launches = 0
    secs = []
    for _ in range(1 + HD_TIMED):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, states = prefill_step(params, {"tokens": toks})
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
    del states
    loop = launch.ServingLoop(cfg, params, n_slots=LM_SLOTS,
                              max_seq=PHI4_MAX_SEQ)
    t1 = time.perf_counter()
    done = loop.run(reqs)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t1
    launches = sw.launches
    # --- end of the main path ---
    if launches != L * (1 + HD_TIMED + loop.n_prefills) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{PHI4_ARCH}: {launches} swa_attention "
                             f"launches, expected {L} per prefill call")
    got = {c.rid: c.tokens for c in done}
    if sorted(got) != list(range(len(reqs))) or any(
            len(got[r.rid]) != r.max_new_tokens for r in reqs):
        raise AssertionError(f"{PHI4_ARCH} ServingLoop: missing or short "
                             f"completions")
    n_tok = sum(len(c.tokens) for c in done)
    near_tie = lambda best: LM_BF16_ULPS * bf16_ulp(best)
    chk = loop_vs_single_request(TM, cfg, params, reqs, got, near_tie,
                                 cache_len=PHI4_MAX_SEQ)
    med = statistics.median(secs[1:])
    out = {"arch": PHI4_ARCH, "params": n_params, "launches": launches,
           "prefill": {f"{b}x{t}": {"median_s": med,
                                    "tokens_per_s": b * t / med}},
           "loop": {"requests": len(reqs), "max_seq": PHI4_MAX_SEQ,
                    "new_tokens": n_tok, "seconds": loop_s,
                    "tokens_per_s": n_tok / loop_s,
                    "prefills": loop.n_prefills, "steps": loop.n_steps},
           "loop_vs_single_request": chk}
    log(f"phase head256 {PHI4_ARCH}: {n_params} params bf16 ({L} layers, D "
        f"{cfg.head_dim}); prefill {b}x{t} {b * t / med!r} tokens/s; ServingLoop {LM_SLOTS} slots x {len(reqs)} requests, "
        f"max_seq {PHI4_MAX_SEQ}: {n_tok} new tokens, {n_tok / loop_s!r} "
        f"tokens/s; swa_attention launches {launches} ({L} per prefill call);"
        f" every token of {chk['requests']} completions ({chk['positions']} "
        f"positions) single-request greedy with the cache sized by "
        f"prefill(cache_len={PHI4_MAX_SEQ}) or a near-tie "
        f"({len(chk['near_ties'])}) card=\"{card}\"")
    del params, loop
    torch.cuda.empty_cache()
    return out


def hd_times(sw, card) -> dict:
    """The D = 256 kernel in bf16 at the three prefill calls of HD_TIMES (L2
    flushed and warm, CUDA events and CUPTI) beside its bound, the plain
    version's time (one call, events), SDPA's default call (events, the
    kernels line's ``library_ms``; which backend) and, at 8 x 512, the fp32
    kernel by events."""
    cyc = sleep_cycles_per_ms()
    flush = l2_flusher()
    rows = {}
    for arch, b, t, kv, window in HD_TIMES:
        n_ev, n_cu = ((TIMED_LAUNCHES, CUPTI_CALLS) if b * t <= 4096
                      else (CHUNK, 10))
        q, k, v = swa_inputs(b, t, t, 16, kv, 256, torch.bfloat16, SEED + 196)
        kern = lambda: sw.swa_attention_cuda(q, k, v, window=window)
        lib = sdpa_fn(q, k, v, window)
        got = kern()
        err = float((lib().transpose(1, 2).float() - got.float()).abs()
                    .max())
        bnd = swa_bound(b, t, t, 16, kv, 256, window, True)
        rec = {"arch": arch, "shape": [b, t, 16, kv, 256], "window": window,
               "dtype": "bfloat16",
               "cupti_ms": cupti_ms(kern, flush, SWA_KERNEL, n_cu),
               "warm_l2_cupti_ms": cupti_ms(kern, None, SWA_KERNEL, n_cu),
               "ms": device_ms(kern, cyc, flush, n_ev)[0],
               "warm_l2_ms": device_ms(kern, cyc, None, n_ev)[0],
               "library_ms": device_ms(lib, cyc, flush, n_ev)[0],
               "library_backend": sdpa_backend_of(q, k, v, window),
               "library_vs_kernel_max_abs_diff": err,
               "plain_ms": events_ms(lambda: sw.swa_attention_plain(
                   q, k, v, window=window), 1), **bnd}
        rec["share_of_bound"] = bnd["bound_ms"] / rec["ms"]
        if b * t <= 4096:
            q32, k32, v32 = (x.float() for x in (q, k, v))
            rec["fp32_ms"] = device_ms(lambda: sw.swa_attention_cuda(
                q32, k32, v32, window=window), cyc, flush, n_ev)[0]
            rec["fp32_bound_ms"] = max(
                bnd["bytes"] * 2 / HBM_BYTES_PER_S * 1e3,
                4 * 256 * bnd["pairs"] / FP32_FLOP_PER_S * 1e3)
            del q32, k32, v32
        rows[f"{arch}/{b}x{t}"] = rec
        log(f"time swa_attention D=256 {arch} shape=({b}, {t}, 16/{kv}, 256) "
            f"bf16 W={window} L2 flushed: kernel_ms={rec['ms']!r} (cupti "
            f"{rec['cupti_ms']!r}; L2-warm {rec['warm_l2_ms']!r}, cupti "
            f"{rec['warm_l2_cupti_ms']!r}) plain_ms={rec['plain_ms']!r} "
            f"bound_ms={bnd['bound_ms']!r} ({bnd['bound_by']}; share reached "
            f"{rec['share_of_bound']!r}) SDPA {rec['library_backend']} "
            f"{rec['library_ms']!r} ms (max |SDPA - kernel| {err!r})" + (
                f"; fp32 kernel {rec['fp32_ms']!r} ms (bound "
                f"{rec['fp32_bound_ms']!r})" if "fp32_ms" in rec else "")
            + f" card=\"{card}\"")
        del q, k, v, got
        torch.cuda.empty_cache()
    return rows


def head256_phase(sw, _build, TC, TM, launch, card) -> dict:
    """Phase 19 (slice 15): the D = 256 kernel vs plain, gemma-7b and
    recurrentgemma-9b served at full width, HD_LAYERS deep (each freed
    before the next is drawn), phi4-mini-3.8b at full size, the kernel's
    times."""
    t0 = time.perf_counter()
    parts, lap = {}, [t0]

    def done(name):
        parts[name] = time.perf_counter() - lap[0]
        lap[0] = time.perf_counter()

    out = {"parity": hd_vs_plain(sw)}
    done("parity")
    out["models"] = {}
    for arch in HD_ARCHS:
        torch.cuda.reset_peak_memory_stats()
        out["models"][arch] = hd_serving_path(sw, _build, TC, TM, launch,
                                              card, arch)
        done(arch)
    out["phi4"] = phi4_serving(sw, _build, TC, TM, launch, card)
    done(PHI4_ARCH)
    out["times"] = hd_times(sw, card)
    done("times")
    out["launches"] = (sum(m["launches"] for m in out["models"].values())
                       + out["phi4"]["launches"])
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    log(f"phase head256: {out['seconds']!r} s; by part {parts}")
    return out


def head256_alone() -> dict:
    """Phase 19 without the rest of the script (``python3 -c 'import
    chip_smoke as c; c.head256_alone()'``): builds the kernels, then the
    head-256 phase."""
    if not torch.cuda.is_available():
        raise SystemExit("head256_alone: no CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import configs as TC
    from repro_torch import launch
    from repro_torch import models as TM
    from repro_torch.kernels import _build
    from repro_torch.kernels import swa_attention as sw
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card {card}")
    _build.load()
    return head256_phase(sw, _build, TC, TM, launch, card)


# --- phase 20: LM training for every family (slice 16) -----------------------------

# (arch, layers of the published depth kept): gemma-7b 2 of 28 and
# recurrentgemma-9b 3 of 38 (one (rglru, rglru, local) cycle) fit one card
# with two agents' Adam state; rwkv6-1.6b whole (~24 bytes a parameter).
TR_MODELS = (("gemma-7b", 2), ("recurrentgemma-9b", 3), ("rwkv6-1.6b", 24))
TR_AGENTS, TR_BATCH, TR_SEQ, TR_TAU = 2, 2, 1024, 2
# tokens a row of the kernel-vs-plain step: rwkv6-1.6b's plain recurrence
# is a host loop over t (forward and backward, 24 layers), so its step runs
# the first 256 of the 1024 (wkv6_bwd is held at (2, 1024) on its own)
TR_PLAIN_SEQ = {"rwkv6-1.6b": 256}
TR_KERNELS = ("swa_attention", "swa_attention_bwd", "wkv6", "wkv6_bwd",
              "adam_update", "row_mean")
WKV6_BWD_REL = 1e-5       # |kernel - plain| <= WKV6_BWD_REL * max |plain|
# (B, T, H, nonzero s0, nonzero dL/dS_T): T on and off the kernel's
# 32-step chunks and 4-step sub-chunks, one step, the main path's shape;
# then the chunks' edges (T 31, 32, 33), one block (B H = 1) under one
# chunk and at one step, and ragged last chunks (131: 3 steps, 200: 8)
WKV6_BWD_CASES = ((1, 37, 2, True, True), (2, 16, 3, False, True),
                  (1, 1, 4, True, False), (3, 100, 1, True, True),
                  (TR_BATCH, TR_SEQ, 32, True, True),
                  (1, 31, 2, True, True), (2, 32, 2, True, True),
                  (1, 33, 3, True, True), (1, 20, 1, True, True),
                  (1, 1, 1, True, True), (2, 131, 2, True, True),
                  (1, 200, 2, False, True))
# The D = 256 backward's two bf16 kernels and wkv6_bwd's three kernels (the
# profile's split by name).
BWD256_KERNELS = ("swa_bwd_dq_hopper_d256_kernel",
                  "swa_bwd_dkdv_hopper_d256_kernel")
WKV6_BWD_KERNELS = ("wkv6_bwd_bound_kernel", "wkv6_bwd_chunk_kernel",
                    "wkv6_bwd_du_kernel")
# timed: (model, B, S, KV heads, window) of the models' training steps
HB_TIMES = (("gemma-7b", TR_BATCH, TR_SEQ, 16, None),
            ("recurrentgemma-9b", TR_BATCH, TR_SEQ, 1, 2048))


def bwd_one_bf16_pds(q, k, v, o, do, lse, window, causal=True) -> tuple:
    """The control of the bf16 backward's error rule (the arithmetic of
    ``tests/test_torch_swa.py::_bwd_kernel_numerics`` with ``split``
    False): fp32 s, dp, p, ds from the bf16 inputs, then dv = p^T do, dq =
    ds k and dk = ds^T q with p and ds rounded once to bf16 (exact products,
    float64 sums), bf16 outputs. The rule must reject it. ``causal`` off:
    every key of the window is seen (k may hold another number of rows than
    q)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    kr, vr = (t.repeat_interleave(rep, dim=2).double() for t in (k, v))
    scale = D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kr).float()
    dp = torch.einsum("bqhd,bkhd->bhqk", do.double(), vr).float()
    i = torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        ok &= j <= i
    if window:
        ok &= j > i - window
    p = torch.where(ok, torch.exp(s * scale - lse[..., None]),
                    torch.zeros((), device=q.device))
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    ds = p * (dp - delta[..., None]) * scale
    one = lambda x: x.bfloat16().double()
    fold = lambda g: g.reshape(B, Sk, KV, rep, D).sum(3)
    dq = torch.einsum("bhqk,bkhd->bqhd", one(ds), kr)
    dk = fold(torch.einsum("bhqk,bqhd->bkhd", one(ds), q.double()))
    dv = fold(torch.einsum("bhqk,bqhd->bkhd", one(p), do.double()))
    return tuple(x.float().bfloat16() for x in (dq, dk, dv))


def bwd_control(sw, swb, q, k, v, do, window, row, what,
                causal=True) -> float:
    """The one-bf16 p / ds control (``bwd_one_bf16_pds``) at a bf16 case
    that ``bwd_check`` passed (``row``): for the worst of dq, dk, dv, its
    mean error against float64 less BWD_FLOOR x G, over the plain
    version's mean error. Raises unless that exceeds BWD_MEAN_RATIO, that
    is unless the rule rejects the control."""
    kw = dict(window=window, causal=causal)
    o, lse = sw.swa_attention_cuda(q, k, v, with_lse=True, **kw)
    ctl = bwd_one_bf16_pds(q, k, v, o, do, lse, window, causal)
    x64 = [t.double() for t in (q, k, v, do)]
    o64, lse64 = sw.swa_attention_plain(*x64[:3], with_lse=True, **kw)
    want = swb.swa_attention_bwd_plain(*x64[:3], o64, x64[3], lse64, **kw)
    ratio = max(
        (float((c.double() - w).abs().mean()) - BWD_FLOOR * row["G"])
        / max(row[g]["plain_mean_err"], 1e-30)
        for g, c, w in zip(("dq", "dk", "dv"), ctl, want))
    if not ratio > BWD_MEAN_RATIO:
        raise AssertionError(f"{what}: the one-bf16 p / ds control keeps "
                             f"the mean rule ({ratio!r})")
    return ratio


def hd_bwd_vs_plain(sw, swb) -> dict:
    """Phase 20 (1): the D = 256 backward against its plain version on the
    card, fp32 and bf16, 16 query heads on KV in ``HD_KV``, B = 1, Sq = Sk
    in ``HD_SQ`` (the 64-row tile edges), windows ``HD_WINDOWS``, and the
    models' training shapes (``HB_TIMES``: B = 2, S = 1024, 16 tiles), by
    phase 18's rule (``bwd_check``: the lse, fp32 within BWD_REL of the largest
    |gradient|, bf16 against float64 within BWD_MAX_RATIO / BWD_MEAN_RATIO
    x the plain version's max / mean error, a second launch bitwise); in
    bf16 also the control (``bwd_one_bf16_pds``, p and ds rounded once)
    held to break the mean rule wherever a row sees more than one key."""
    rows, worst = [], {"float32": 0.0, "bfloat16": 0.0}
    control_min = math.inf
    cases = [(1, s, w, k) for s in HD_SQ for w in HD_WINDOWS for k in HD_KV]
    cases += [(b, s, w, kv) for _, b, s, kv, w in HB_TIMES]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for n, (b, sq, window, kv) in enumerate(cases):
            q, k, v, do = bwd_inputs(b, sq, 16, kv, 256, dtype, SEED + 200 + n)
            what = (f"swa_attention_bwd D=256 B {b} Sq {sq} W {window} KV {kv} "
                    f"{name}")
            row = bwd_check(sw, swb, q, k, v, do, window, what)
            row.update(b=b, sq=sq, window=window, kv=kv, dtype=name)
            if dtype == torch.bfloat16 and sq > 1:
                ratio = bwd_control(sw, swb, q, k, v, do, window, row, what)
                row["control_mean_ratio"] = ratio
                control_min = min(control_min, ratio)
            worst[name] = max(worst[name], row["err"])
            rows.append(row)
            del q, k, v, do
    torch.cuda.empty_cache()
    # Sq = 1: dq and dk are 0 in float64 (one key: ds = 0), so the plain
    # version's error is 0 and the floor alone bounds the kernel's
    ratios = [max((r[g]["mean_err"] - BWD_FLOOR * r["G"])
                  / max(r[g]["plain_mean_err"], 1e-30)
                  for g in ("dq", "dk", "dv"))
              for r in rows if r["dtype"] == "bfloat16" and r["sq"] > 1]
    out = {"cases": rows, "worst": worst, "mean_ratio_max": max(ratios),
           "control_ratio_min": control_min}
    log(f"phase train: swa_attention_bwd D=256 vs plain at {len(rows)} cases "
        f"ok (B 1, Sq {HD_SQ}, W {HD_WINDOWS}, KV {HD_KV} of 16 heads; the "
        f"training shapes {[(b, s, kv, w) for _, b, s, kv, w in HB_TIMES]}; "
        f"fp32 within "
        f"{BWD_REL} x max |grad|, bf16 within {BWD_MAX_RATIO} / "
        f"{BWD_MEAN_RATIO} x the plain version's max / mean error against "
        f"float64; a second launch bitwise); largest |kernel - reference| "
        f"{worst}; bf16 mean err / plain's at most {out['mean_ratio_max']!r}, "
        f"the one-bf16 p / ds control at least {control_min!r}")
    return out


def wkv6_bwd_vs_plain(wk) -> dict:
    """Phase 20 (2): ``wkv6_bwd_cuda`` against ``wkv6_bwd_plain`` on the
    card at ``WKV6_BWD_CASES`` (phase 9's inputs, dy ~ N(0, 1), dL/dS_T ~
    0.1 N(0, 1) or none): each gradient within WKV6_BWD_REL of its largest
    |plain value|; a second call bitwise equal to the first."""
    rows, worst = [], 0.0
    for n, (b, t, h, s_on, g_on) in enumerate(WKV6_BWD_CASES):
        r, k, v, w, u, s0 = wkv6_inputs(b, t, h, SEED + 210 + n,
                                        state=0.1 if s_on else 0.0)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 220 + n)
        dy = torch.randn(r.shape, generator=gen, device="cuda")
        dsT = 0.1 * torch.randn(s0.shape, generator=gen, device="cuda") \
            if g_on else None
        got = wk.wkv6_bwd_cuda(r, k, v, w, u, s0, dy, dsT)
        again = wk.wkv6_bwd_cuda(r, k, v, w, u, s0, dy, dsT)
        torch.cuda.synchronize()
        what = f"wkv6_bwd ({b}, {t}, {h}, 64) s0 {s_on} dsT {g_on}"
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{what}: a second call gave other bits")
        plain = wk.wkv6_bwd_plain(r, k, v, w, u, s0, dy, dsT)
        row = {"shape": [b, t, h, 64], "s0": s_on, "dsT": g_on}
        for name, x, p in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                              plain):
            G = float(p.abs().max())
            err = float((x - p).abs().max())
            if not err <= WKV6_BWD_REL * max(G, 1e-30):
                raise AssertionError(f"{what} {name}: err {err!r} > "
                                     f"{WKV6_BWD_REL} x {G!r}")
            row[name] = {"err": err, "G": G}
            worst = max(worst, err / max(G, 1e-30))
        rows.append(row)
        del r, k, v, w, u, s0, dy, dsT, got, again, plain
    torch.cuda.empty_cache()
    log(f"phase train: wkv6_bwd vs plain at {len(rows)} shapes ok (T on and "
        f"off the 32-step chunks and 4-step sub-chunks, one block, nonzero s0 "
        f"and dL/dS_T, {WKV6_BWD_CASES[4][:3]}); "
        f"largest |kernel - plain| / max |plain| {worst!r} <= {WKV6_BWD_REL}; "
        f"a second call bitwise")
    return {"cases": rows, "worst_rel": worst}


def tr_config(TC, arch, layers):
    """``arch`` at its published width with its first ``layers`` layers
    (registered as ``<arch>-<layers>l``); the whole model when ``layers``
    is its depth."""
    base = TC.get_arch(arch)
    if layers == base.n_layers:
        return base
    name = f"{arch}-{layers}l"
    if name not in TC.ARCH_REGISTRY:
        TC.register_arch(dataclasses.replace(base, name=name, n_layers=layers))
    return TC.get_arch(name)


def _train_expected(cfg, fed, n_agents, steps) -> dict:
    """Launches of ``steps`` local steps (and their syncs) by kernel. Per
    step and agent: one forward (two for the layers ``cfg.remat``
    recomputes) and one backward kernel per attention layer
    (``swa_attention`` / ``swa_attention_bwd``) and per ``wkv`` layer
    (``wkv6`` / ``wkv6_bwd``); an encoder-decoder model's attentions are
    its encoder layers' and two a decoder layer (self and cross), every
    layer recomputed under ``cfg.remat``; per step one ``adam_update``; one
    ``row_mean`` a period (periodic)."""
    from repro_torch.models.transformer import remat_layers
    out = {k: 0 for k in TR_KERNELS}
    out["adam_update"] = steps
    out["row_mean"] = steps // fed.tau
    if cfg.is_encoder_decoder:
        n = cfg.n_encoder_layers + 2 * cfg.n_layers
        out["swa_attention"] = steps * n_agents * n * (2 if cfg.remat else 1)
        out["swa_attention_bwd"] = steps * n_agents * n
        return out
    rec = set(remat_layers(cfg)) if cfg.remat else set()
    for i in range(cfg.n_layers):
        kind = cfg.block_kind(i)
        fwd, bwd = {"attn": ("swa_attention", "swa_attention_bwd"),
                    "local": ("swa_attention", "swa_attention_bwd"),
                    "wkv": ("wkv6", "wkv6_bwd")}.get(kind, (None, None))
        if fwd is None:
            continue
        out[fwd] += steps * n_agents * (2 if i in rec else 1)
        out[bwd] += steps * n_agents
    return out


def _tr_counts(km, sw, swb, wk) -> dict:
    c = _kernel_counts(km)
    return {"swa_attention": sw.launches, "swa_attention_bwd": swb.launches,
            "wkv6": wk.launches, "wkv6_bwd": wk.bwd_launches,
            "adam_update": c["adam_update"], "row_mean": c["row_mean"],
            "others": {k: v for k, v in c.items()
                       if k not in ("adam_update", "row_mean")}}


def _tr_reset(km, sw, swb, wk) -> None:
    _reset_counts(km)
    sw.launches = swb.launches = wk.launches = wk.bwd_launches = 0


class PlainWkv6(torch.autograd.Function):
    """The reference recurrence of the kernel-vs-plain step: ``wkv6_plain``
    forward and ``wkv6_bwd_plain`` backward on the card (autograd through
    the plain loop would keep every step's state of every layer)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        from repro_torch.kernels import wkv6 as wk
        ctx.save_for_backward(r, k, v, w, u, s0)
        return wk.wkv6_plain(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, dy, ds):
        from repro_torch.kernels import wkv6 as wk
        saved = ctx.saved_tensors
        dy = torch.zeros_like(saved[0]) if dy is None else dy.contiguous()
        return wk.wkv6_bwd_plain(*saved, dy, ds)


def tr_kernel_vs_plain(sw, TM, cfg, state, batch) -> dict:
    """Agent 0's loss and gradient row on ``state`` (its ``batch``: tokens,
    and frames for an encoder-decoder model) with the kernels and
    with the plain attention (``swa_impl``, by autograd) and recurrence
    (``PlainWkv6``): losses within LMT_LONG_LOSS_REL, gradient rows within
    LMT_LONG_GRAD_REL in relative L2 (phase 18's rule; bf16). Both sides
    run with ``remat`` off (the same values: tests/test_torch_train_
    families.py holds remat on and off bitwise), so the plain recurrence's
    host loop runs once a layer. The state's gradient buffer is
    overwritten; no launch here counts."""
    cfg = dataclasses.replace(cfg, remat=False)
    out = {}
    for name, kw in (("kernel", {}),
                     ("plain", {"swa_impl": sw.swa_attention_plain,
                                "wkv_impl": PlainWkv6.apply})):
        state.grads[0].zero_()
        row = state.params[0].detach().requires_grad_()
        params = state.layout.model_params(row, state.grads, 0)
        loss = TM.lm_loss(cfg, params, batch, **kw)
        loss.backward()
        out[name] = (float(loss), state.grads[0].float().clone())
        del loss, params, row
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    grad_rel = float(torch.linalg.vector_norm(gk - gp)
                     / torch.linalg.vector_norm(gp))
    if not (loss_rel <= LMT_LONG_LOSS_REL and grad_rel <= LMT_LONG_GRAD_REL):
        raise AssertionError(f"train {cfg.name}: kernel vs plain loss {lk!r} "
                             f"vs {lp!r} (rel {loss_rel!r}), gradient rel L2 "
                             f"{grad_rel!r}")
    return {"loss_kernel": lk, "loss_plain": lp, "loss_rel": loss_rel,
            "grad_rel_l2": grad_rel}


def _tr_split(prof) -> dict:
    """A profiled step's device ms: matmuls, attention forward and backward,
    wkv6 forward and backward, Adam, row_mean, other (the RG-LRU scan and
    the rest of the elementwise work)."""
    dev = _device_ops(prof)
    busy = sum(t for _, t in dev.values())
    if busy <= 0:
        raise AssertionError("train profile: no device time")
    pick = lambda *names: sum(t for k, (_, t) in dev.items()
                              if any(n in k for n in names)) / 1e3
    split = {"matmul": _matmul_us(dev) / 1e3,
             "swa_attention": pick("swa_attention_hopper_kernel",
                                   "swa_attention_kernel"),
             "swa_attention_bwd": pick("swa_bwd_"),
             "wkv6": pick("wkv6_kernel"),
             "wkv6_bwd": pick(*WKV6_BWD_KERNELS),
             "adam_update": pick("adam_update_kernel"),
             "row_mean": pick("row_mean_kernel")}
    split["other"] = busy / 1e3 - sum(split.values())
    top = sorted(dev.items(), key=lambda kv_: -kv_[1][1])[:8]
    return {"device_busy_ms": busy / 1e3, "device_ms": split,
            "top_ops": [[k[:80], c, t / 1e3] for k, (c, t) in top]}


def train_model_path(km, sw, swb, wk, TC, TM, launch, card, arch,
                     layers, seq=TR_SEQ) -> dict:
    """Phase 20 (3), phase 22 (2): one model at its published width through
    ``repro_torch.launch.train.train`` (A 2, B 2, S ``seq``, periodic tau
    2, 2 steps: one period and its sync), the counts set to 0 before and
    read after: launches exactly ``_train_expected``, losses finite, the
    agent rows bitwise equal after the sync. Then on the returned state, one
    more period through ``make_local_step`` / ``make_sync_step``, timed
    (tokens/s of a local step, frames/s for an encoder-decoder model, sync
    ms, the peak device memory of the period); one profiled local step; and
    the kernel-vs-plain step (not counted; the first ``TR_PLAIN_SEQ`` tokens
    of each row where that is set)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.launch import train as T
    from repro_torch.optim import adamw
    from torch.profiler import ProfilerActivity, profile
    cfg = tr_config(TC, arch, layers)
    fed = launch.FedTrainConfig(strategy="periodic", tau=TR_TAU)
    builds = _build.n_builds
    _tr_reset(km, sw, swb, wk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parts, lap = {}, [t0]

    def done(name):
        now = time.perf_counter()
        parts[name], lap[0] = now - lap[0], now

    state, losses = T.train(cfg.name, reduced=False, steps=TR_TAU, fed=fed,
                            n_agents=TR_AGENTS, batch=TR_BATCH, seq=seq,
                            log_every=TR_TAU + 1, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train {cfg.name}: losses {losses}")
    equal = bool(torch.equal(state.params[0], state.params[1]))
    if not equal or not bool(torch.isfinite(state.params).all()):
        raise AssertionError(f"train {cfg.name}: agent rows differ after the "
                             f"sync, or are not finite")
    done("train")
    audio = cfg.frontend == "audio"
    torch.cuda.reset_peak_memory_stats()
    timing = lmt_period_times(launch, cfg, fed, state, TR_AGENTS, TR_BATCH,
                              seq, TR_TAU)
    peak = torch.cuda.max_memory_allocated()
    if audio:
        timing["frames_per_s"] = (TR_AGENTS * TR_BATCH * cfg.n_frontend_tokens
                                  / timing["local_step_ms"] * 1e3)
    done("period")
    local = launch.make_local_step(cfg, adamw(weight_decay=0.01), fed,
                                   n_agents=TR_AGENTS)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seed=SEED)
    toks = torch.from_numpy(np.stack([
        data.batch(3 * TR_TAU, TR_BATCH, seq + 1, agent=a)
        for a in range(TR_AGENTS)])).cuda()
    torch.cuda.synchronize()
    # device activity only: the split reads kernels alone, and recording
    # every host op of rwkv6-1.6b's 24 layers made the profile's processing
    # the largest part of its run
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        local(state, T.stub_batch(cfg, toks))
        torch.cuda.synchronize()
        step_us = (time.perf_counter() - t1) * 1e6
    split = _tr_split(prof)
    done("profile")
    split.update(wall_ms=step_us / 1e3,
                 device_idle_share=1.0 - split["device_busy_ms"] * 1e3
                 / step_us)
    counts = _tr_counts(km, sw, swb, wk)
    got = {k: counts[k] for k in TR_KERNELS}
    want = _train_expected(cfg, fed, TR_AGENTS, 2 * TR_TAU + 1)
    want["row_mean"] = 2
    if got != want or counts["others"] != {k: 0 for k in counts["others"]}:
        raise AssertionError(f"train {cfg.name}: launches {got}, expected "
                             f"{want} (others {counts['others']})")
    if _build.n_builds != builds:
        raise AssertionError("a build on the training hot path")
    plain_seq = TR_PLAIN_SEQ.get(arch, seq)
    parity = tr_kernel_vs_plain(sw, TM, cfg, state, {
        k: v[0] for k, v in T.stub_batch(cfg, toks[:, :, :plain_seq + 1])
        .items()})
    parity["seq"] = plain_seq
    done("kernel_vs_plain")
    n_params = state.layout.n
    frames = (f" = {timing['frames_per_s']!r} frames/s ({cfg.n_frontend_tokens}"
              f" a row)" if audio else "")
    log(f"phase train: {cfg.name} ({n_params} parameters an agent, A "
        f"{TR_AGENTS} x {TR_BATCH} x {seq}): losses {losses}; train() "
        f"{wall!r} s for {TR_TAU} steps (init included); local step "
        f"{timing['local_step_ms']!r} ms = {timing['tokens_per_s']!r} tokens/s"
        f"{frames}, sync {timing['sync_ms']!r} ms, peak device memory {peak} B; rows "
        f"equal after the sync; launches {got} (the formula's); profiled step "
        f"wall {split['wall_ms']!r} ms, busy {split['device_busy_ms']!r} ms, "
        f"idle {split['device_idle_share']!r}, device ms {split['device_ms']};"
        f" kernel vs plain (S {plain_seq}): loss {parity['loss_kernel']!r} / "
        f"{parity['loss_plain']!r} (rel {parity['loss_rel']!r}), gradient "
        f"rel L2 {parity['grad_rel_l2']!r} card=\"{card}\"; seconds by part "
        f"{parts}")
    del state
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": layers, "params_per_agent": n_params,
            "part_seconds": parts, "losses": losses, "train_wall_s": wall, **timing,
            "peak_memory_bytes": peak, "rows_equal_after_sync": equal,
            "launches": got, "profile": split, "kernel_vs_plain": parity}


def wkv6_bwd_bound(b, t, h) -> dict:
    """The least time of wkv6_bwd (fp32, D 64): its bytes (r, k, v, w, dy
    read, dr, dk, dv, dw written, u, du, s0, dL/dS_T, ds0) over the HBM
    rate against its FLOP (per step and (i, j): the state's recomputation,
    G's update and the four sums, 2 each: 12 D^2, + 10 D for c_t and the
    bonus terms) at the fp32 peak."""
    d = 64
    nbytes = 4 * (9 * b * t * h * d + 2 * h * d + 3 * b * h * d * d)
    flops = b * t * h * (12 * d * d + 10 * d)
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": nbytes, "flops": flops}


def train_times(sw, swb, wk, card) -> dict:
    """Phase 20 (4): the D = 256 backward in bf16 at the models' training
    shapes (``HB_TIMES``) and wkv6_bwd at (2, 1024, 32, 64): CUPTI (L2
    flushed; the kernels' records summed) and CUDA events (flushed and
    warm), beside the bound, the plain version's time (one call, events)
    and, for attention, SDPA's autograd backward on repeated K/V."""
    cyc = sleep_cycles_per_ms()
    flush = l2_flusher()
    rows = {}
    for arch, b, s, kv, window in HB_TIMES:
        q, k, v, do = bwd_inputs(b, s, 16, kv, 256, torch.bfloat16, SEED + 230)
        o, lse = sw.swa_attention_cuda(q, k, v, window=window, with_lse=True)
        kern = lambda: swb.swa_attention_bwd_cuda(q, k, v, o, do, lse,
                                                  window=window)
        lib = sdpa_bwd_fn(q, k, v, do, window)
        rec = {"arch": arch, "shape": [b, s, 16, kv, 256], "window": window,
               "dtype": "bfloat16",
               "cupti_ms": sum(cupti_ms(kern, flush, n)
                               for n in BWD256_KERNELS),
               "ms": device_ms(kern, cyc, flush, CHUNK)[0],
               "warm_l2_ms": device_ms(kern, cyc, None, CHUNK)[0],
               "plain_ms": events_ms(lambda: swb.swa_attention_bwd_plain(
                   q, k, v, o, do, lse, window=window), 1),
               "library_ms": device_ms(lib, cyc, flush, CHUNK)[0],
               "library_backend": sdpa_backend_of(q, k, v, window),
               **bwd_bound(b, s, 16, kv, 256, window)}
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rows[f"swa_attention_bwd_d256/{arch}"] = rec
        log(f"time swa_attention_bwd D=256 {arch} shape=({b}, {s}, 16/{kv}, "
            f"256) bf16 W={window} L2 flushed: kernel_ms={rec['ms']!r} (cupti "
            f"{rec['cupti_ms']!r}; L2-warm {rec['warm_l2_ms']!r}) plain_ms="
            f"{rec['plain_ms']!r} bound_ms={rec['bound_ms']!r} "
            f"({rec['bound_by']}; share {rec['share_of_bound']!r}) "
            f"library_ms={rec['library_ms']!r} (SDPA backward, "
            f"{rec['library_backend']} forward choice) card=\"{card}\"")
        del q, k, v, do, o, lse, lib
        torch.cuda.empty_cache()
    rows["wkv6_bwd"] = wkv6_bwd_times(wk, cyc, flush, card)
    rows["rglru_scan"] = rglru_scan_times(card)
    return rows


def _device_kernels(fn, part) -> tuple:
    """The names of the device kernels one call of ``fn`` launches that
    contain ``part``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return tuple(sorted({e.key for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA
                         and part in e.key}))


def wkv6_bwd_times(wk, cyc, flush, card, names=WKV6_BWD_KERNELS) -> dict:
    """wkv6_bwd at (2, 1024, 32, 64) fp32: CUPTI (L2 flushed; the records
    of each kernel in ``names`` summed; None: the kernels whose name holds
    "wkv6_bwd", found by profiling one call, which a fresh process needs
    for a checkout whose names it does not know) and CUDA events (flushed
    and warm) beside the bound, and the plain version's time (one call,
    events)."""
    r, k, v, w, u, s0 = wkv6_inputs(TR_BATCH, TR_SEQ, 32, SEED + 231)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 232)
    dy = torch.randn(r.shape, generator=gen, device="cuda")
    dsT = 0.1 * torch.randn(s0.shape, generator=gen, device="cuda")
    kern = lambda: wk.wkv6_bwd_cuda(r, k, v, w, u, s0, dy, dsT)
    names = names or _device_kernels(kern, "wkv6_bwd")
    if not names:
        raise AssertionError("wkv6_bwd: the profile shows none of its kernels")
    by_kernel = {n.split("::")[-1].split("(")[0]: cupti_ms(kern, flush, n)
                 for n in names}
    rec = {"shape": [TR_BATCH, TR_SEQ, 32, 64], "dtype": "float32",
           "cupti_ms": sum(by_kernel.values()), "cupti_by_kernel": by_kernel,
           "ms": device_ms(kern, cyc, flush, CHUNK)[0],
           "warm_l2_ms": device_ms(kern, cyc, None, CHUNK)[0],
           "plain_ms": events_ms(lambda: wk.wkv6_bwd_plain(
               r, k, v, w, u, s0, dy, dsT), 1),
           "library_ms": None, **wkv6_bwd_bound(TR_BATCH, TR_SEQ, 32)}
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    del r, k, v, w, u, s0, dy, dsT
    torch.cuda.empty_cache()
    log(f"time wkv6_bwd shape=({TR_BATCH}, {TR_SEQ}, 32, 64) fp32 L2 flushed: "
        f"kernel_ms={rec['ms']!r} (cupti {rec['cupti_ms']!r}: {by_kernel}; "
        f"L2-warm {rec['warm_l2_ms']!r}) plain_ms={rec['plain_ms']!r} "
        f"bound_ms={rec['bound_ms']!r} ({rec['bound_by']}; {rec['flops']} "
        f"FLOP, {rec['bytes']} B; share {rec['share_of_bound']!r}) "
        f"library_ms=None card=\"{card}\"")
    return rec


def wkv6_bwd_alone() -> dict:
    """wkv6_bwd's times alone (``python3 -c 'import chip_smoke as c;
    c.wkv6_bwd_alone()'``): builds the kernels and times ``wkv6_bwd_cuda``
    as phase 20 does, its kernels found by profiling. Copied into another
    checkout it times that checkout's kernels, so two commits compare in
    one call (parent, change, change, parent)."""
    if not torch.cuda.is_available():
        raise SystemExit("wkv6_bwd_alone: no CUDA card")
    TC, launch, TM, _build, sw, swb, wk = _alone_modules()
    card = card_line()
    log(f"card {card}")
    _build.load()
    return wkv6_bwd_times(wk, sleep_cycles_per_ms(), l2_flusher(), card,
                          names=None)


def rglru_scan_times(card) -> dict:
    """The plain RG-LRU scan of one recurrentgemma-9b layer at the training
    step's (2, 1024, 4096) fp32 (no kernel: JAX has no Pallas twin), by
    CUDA events: the forward alone, forward + backward (autograd through
    the log-depth recursion), and the device memory its saved levels hold
    between the two."""
    from repro_torch.models import rglru as rg
    gen = torch.Generator(device="cuda").manual_seed(SEED + 233)
    shape = (TR_BATCH, TR_SEQ, 4096)
    a_log = -8.0 * torch.rand(shape, generator=gen, device="cuda")
    gate = torch.randn(shape, generator=gen, device="cuda")
    h0 = torch.randn((TR_BATCH, 4096), generator=gen, device="cuda")
    leaves = [t.requires_grad_() for t in (a_log, gate, h0)]
    g = torch.randn(shape, generator=gen, device="cuda")

    def fwd_bwd():
        h, last = rg.rglru_scan(*leaves)
        return torch.autograd.grad((h * g).sum() + last.sum(), leaves)
    with torch.no_grad():
        fwd_ms = events_ms(lambda: rg.rglru_scan(*leaves), 5)
    both_ms = events_ms(fwd_bwd, 5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    h, last = rg.rglru_scan(*leaves)
    saved = torch.cuda.memory_allocated() - base
    del h, last
    rec = {"shape": list(shape), "fwd_ms": fwd_ms, "fwd_bwd_ms": both_ms,
           "saved_bytes": saved, "input_bytes": 4 * shape[0] * shape[1]
           * shape[2]}
    log(f"time rglru_scan (plain) shape={shape} fp32: forward "
        f"{fwd_ms!r} ms, forward + backward {both_ms!r} ms (events); the "
        f"forward under autograd holds {saved} B ({saved / rec['input_bytes']!r}"
        f" x one (B, S, W) fp32 input) for the backward card=\"{card}\"")
    return rec


def train_phase(km, sw, swb, wk, TC, TM, launch, card) -> dict:
    """Phase 20 (slice 16): (1) the D = 256 backward and (2) wkv6_bwd
    against their plain versions, (3) gemma-7b, recurrentgemma-9b and
    rwkv6-1.6b trained at their published width, (4) the kernels' times."""
    t0 = time.perf_counter()
    parts, lap = {}, [t0]

    def done(name):
        parts[name] = time.perf_counter() - lap[0]
        lap[0] = time.perf_counter()

    out = {"bwd256_parity": hd_bwd_vs_plain(sw, swb)}
    done("bwd256_parity")
    out["wkv6_bwd_parity"] = wkv6_bwd_vs_plain(wk)
    done("wkv6_bwd_parity")
    out["models"] = {}
    for arch, layers in TR_MODELS:
        out["models"][arch] = train_model_path(km, sw, swb, wk, TC, TM,
                                               launch, card, arch, layers)
        done(arch)
    out["times"] = train_times(sw, swb, wk, card)
    done("times")
    out["launches"] = {k: sum(m["launches"][k] for m in out["models"].values())
                       for k in TR_KERNELS}
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    log(f"phase train: {out['seconds']!r} s; by part {parts}; main path "
        f"launches {out['launches']}")
    return out


def _alone_modules():
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import configs as TC
    from repro_torch import launch
    from repro_torch import models as TM
    from repro_torch.kernels import _build
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.kernels import swa_attention_bwd as swb
    from repro_torch.kernels import wkv6 as wk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return TC, launch, TM, _build, sw, swb, wk


def train_kernels_alone() -> dict:
    """Phase 20's kernel checks alone (``python3 -c 'import chip_smoke as c;
    c.train_kernels_alone()'``): builds the kernels, prints ptxas's lines
    for the new kernels, then the D = 256 backward and wkv6_bwd against
    their plain versions."""
    if not torch.cuda.is_available():
        raise SystemExit("train_kernels_alone: no CUDA card")
    TC, launch, TM, _build, sw, swb, wk = _alone_modules()
    log(f"card {card_line()}")
    _build.load()
    for line in str(_build.build_info.get("log", "")).splitlines():
        if ("ptxas info" in line and ("Used" in line or "Compiling" in line)
                and ("d256" in line or "wkv6_bwd" in line
                     or "swa_bwd_d" in line)) or "(C75" in line or (
                "spill" in line and " 0 bytes spill stores" not in line):
            log(f"build: {line.strip()}")
    log(f"HGMMA: {hgmma_counts(_build, BWD256_KERNELS)}")
    return {"bwd256": hd_bwd_vs_plain(sw, swb), "wkv6": wkv6_bwd_vs_plain(wk)}


def train_alone() -> dict:
    """Phase 20 without the rest of the script (``python3 -c 'import
    chip_smoke as c; c.train_alone()'``): builds the kernels, then the
    training phase."""
    if not torch.cuda.is_available():
        raise SystemExit("train_alone: no CUDA card")
    TC, launch, TM, _build, sw, swb, wk = _alone_modules()
    km, _, _, _ = _sweep_modules()
    card = card_line()
    log(f"card {card}")
    _build.load()
    return train_phase(km, sw, swb, wk, TC, TM, launch, card)


# --- phase 21: whisper-small serving (slice 18) -------------------------------------

WH_ARCH = "whisper-small"
WH_PARAMS = 238_270_464               # the JAX tree's (tests/test_torch_encdec.py)
WH_FRAMES = 1500                      # frame embeddings a request (30 s at 50 Hz)
WH_BATCH, WH_PROMPT = 8, 4            # SOT, language, task, no-timestamps
WH_LONG = 227                         # B = 1: 223 previous-text tokens + 4
WH_DECODE = 64                        # decode steps at B = WH_BATCH
WH_TIMED = 2                          # timed calls per prefill shape
WH_CHECKED = 4                        # every 4th completion held to B = 1
WH_F32_TOKENS = 16                    # fp32 checks: 2 requests of 16 tokens
WH_F32_STEPS = (4, 8)                 # decode steps: card vs CPU, vs forward
WH_PER_PREFILL = 36                   # 12 encoder + 12 self + 12 cross
WH_PER_STEP = 12                      # the cross-attentions of a decode step
WH_PROFILE_STEPS = 16
# The D = 64 kernel vs plain (phase 12's rules, both dtypes): b, sq, sk, h,
# kv, causal. The encoder's self-attention, the cross-attention of a decode
# step, of the 4-token prompts and of the 227-token one; causal prefills;
# the 128-row tile edges both ways; B = 3 with H / KV = 4 and 1.
WH_CASES = ((8, 1500, 1500, 12, 12, False), (8, 1, 1500, 12, 12, False),
            (8, 4, 1500, 12, 12, False), (1, 227, 1500, 12, 12, False),
            (8, 4, 4, 12, 12, True), (1, 227, 227, 12, 12, True),
            (1, 448, 448, 12, 12, True), (1, 129, 255, 12, 12, False),
            (1, 255, 129, 12, 12, False), (1, 129, 255, 12, 12, True),
            (1, 255, 129, 12, 12, True), (3, 255, 255, 12, 3, True),
            (3, 129, 300, 4, 4, False),
            (4, 128, 128, 8, 4, True))     # the lm-100m twin's training step
# timed (name, b, sq, sk, causal), bf16
WH_TIMES = (("encoder", 8, 1500, 1500, False),
            ("cross_decode", 8, 1, 1500, False),
            ("cross_prefill_227", 1, 227, 1500, False))
# fp32 kernels beside SDPA's efficient backend (fp32): (name, b, s, h, kv,
# d, window, causal); D = 120 and 256 are row 10's fp32 entries (danube's
# and gemma-7b's 8 x 512 prefill)
WH_F32_TIMES = (("d64_encoder", 8, 1500, 12, 12, 64, None, False),
                ("d120_8x512", 8, 512, 32, 8, 120, SWA_WINDOW, True),
                ("d256_8x512", 8, 512, 16, 16, 256, None, True))
# the D = 64 instantiation of the bf16 kernel, by its mangled name in
# cuobjdump's listing (CUPTI's records carry the demangled SWA_KERNEL<64>)
WH_KERNEL_SASS = "swa_attention_hopper_kernelILi64E"


def wh_vs_plain(sw) -> dict:
    """The D = 64 kernels against their plain version on the card at
    ``WH_CASES``, fp32 and bf16, by phase 12's rules (``swa_check``; in
    bf16 the mean rule with its control, one bf16 p, which must break it
    in every case)."""
    rows, worst = [], {"float32": 0.0, "bfloat16": 0.0}
    for n, (b, sq, sk, h, kv, causal) in enumerate(WH_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            q, k, v = swa_inputs(b, sq, sk, h, kv, 64, dtype, SEED + 210 + n)
            got = sw.swa_attention_cuda(q, k, v, causal=causal)
            torch.cuda.synchronize()
            row = {"shape": [b, sq, sk, h, kv, 64], "window": None,
                   "causal": causal, "dtype": name}
            row.update(swa_check(sw, q, k, v, got, None, causal,
                                 f"swa_attention D=64 {(b, sq, sk, h, kv)} "
                                 f"causal={causal} {name}"))
            worst[name] = max(worst[name], row["err"])
            rows.append(row)
            del q, k, v, got
    torch.cuda.empty_cache()
    out = {"cases": rows, "worst": worst, **_mean_ratios(rows)}
    log(f"phase whisper kernel vs plain: {len(rows)} cases ok (D 64, "
        f"{len(WH_CASES)} shapes x fp32 / bf16, causal on and off, Sq != Sk "
        f"either way); max abs err vs float64: fp32 {worst['float32']!r}, "
        f"bf16 {worst['bfloat16']!r} (phase 12's rule); bf16 mean err / "
        f"plain's at most {out['mean_ratio_max']!r} (rule <= "
        f"{SWA_MEAN_RATIO}), the control (one bf16 p) at least "
        f"{out['control_ratio_min']!r}")
    return out


def _wh_frames(b, d, seed):
    """Stub frame embeddings, ``0.1 * N(0, 1)`` (fp32; the model casts)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return 0.1 * torch.randn((b, WH_FRAMES, d), generator=gen, device="cuda")


def _wh_decode_state(TM, cfg, st, b, max_seq):
    """A decode state glued from a prefill's states (the JAX test's
    glue)."""
    state = TM.init_encdec_decode_state(cfg, b, max_seq, WH_FRAMES,
                                        device="cuda")
    state.update(self=st["cache"], cross_k=st["cross"]["k"],
                 cross_v=st["cross"]["v"])
    return state


def wh_greedy_check(TM, cfg, params, prompt, frames, tokens,
                    near_tie) -> dict:
    """Single-request greedy decoding on the card (a B = 1 prefill sized
    for the whole completion, then ``encdec_decode_step``), fed the batch's
    own ``tokens``, so that every position is checked: where a batch token
    is not the B = 1 argmax, its logit must lie within ``near_tie(max
    logit)`` of the max (such near-ties are returned), else it raises."""
    n = prompt.shape[1] + len(tokens) - 1
    with torch.no_grad():
        lg, st = TM.encdec_forward(cfg, params, prompt, frames,
                                   mode="prefill", cache_len=n)
        state = _wh_decode_state(TM, cfg, st, 1, n)
        lg = lg[:, -1:]
        min_margin, ties = float("inf"), []
        for i, tok in enumerate(tokens):
            top, margin = _margins(lg[0, 0])
            min_margin = min(min_margin, float(margin))
            if int(top) != tok:
                best = float(lg[0, 0].max())
                below = best - float(lg[0, 0, tok])
                tie = {"index": i, "batch": tok, "single": int(top),
                       "below_max": below, "tolerance": near_tie(best)}
                if not below <= near_tie(best):
                    raise AssertionError(f"whisper decode: token {i} is not "
                                         f"single-request greedy: {tie}")
                ties.append(tie)
            if i + 1 < len(tokens):
                lg, state = TM.encdec_decode_step(
                    cfg, params, torch.tensor([[tok]], device="cuda"), state,
                    torch.tensor([prompt.shape[1] + i], device="cuda"))
    return {"positions": len(tokens), "min_margin": min_margin, "ties": ties}


def wh_serving_path(sw, _build, TC, TM, launch, card) -> dict:
    """whisper-small at full size, seeded bf16 weights on the card, through
    the user's entry points: ``make_prefill_step`` at B = 8 with 4-token
    prompts and at B = 1 with a 227-token one (1,500 frames a request), the
    model-level prefill sized for the decode (``encdec_forward(...,
    cache_len=)``), then ``make_serve_step`` for WH_DECODE steps at B = 8.
    The swa_attention counter is set to 0 before this main path and read
    after it: WH_PER_PREFILL launches a prefill call, WH_PER_STEP a decode
    step, no build."""
    cfg = TC.get_arch(WH_ARCH)
    rng = np.random.default_rng(SEED + 211)
    t0 = time.perf_counter()
    params = TM.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = TM.count_params(params)
    if n_params != WH_PARAMS:
        raise AssertionError(f"{WH_ARCH}: {n_params} parameters, expected "
                             f"{WH_PARAMS}")
    prefill_step = launch.make_prefill_step(cfg)
    serve_step = launch.make_serve_step(cfg)
    frames = _wh_frames(WH_BATCH, cfg.d_model, SEED + 212)
    prompts = {(WH_BATCH, WH_PROMPT): _prompt_tokens(rng, cfg, WH_BATCH,
                                                      WH_PROMPT),
               (1, WH_LONG): _prompt_tokens(rng, cfg, 1, WH_LONG)}
    builds = _build.n_builds
    out = {"arch": WH_ARCH, "params": n_params, "init_s": init_s,
           "frames": WH_FRAMES, "prefill": {}}

    # --- the main path, counted ---
    sw.launches = 0
    for (b, t), toks in prompts.items():
        batch = {"tokens": toks, "frames": frames[:b]}
        secs = []
        for _ in range(1 + WH_TIMED):
            before = sw.launches
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, states = prefill_step(params, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            if sw.launches - before != WH_PER_PREFILL:
                raise AssertionError(f"whisper prefill {b}x{t}: "
                                     f"{sw.launches - before} swa_attention "
                                     f"launches, expected {WH_PER_PREFILL}")
        if tuple(logits.shape) != (b, 1, TM.padded_vocab(cfg)) or \
                not bool(torch.isfinite(logits).all()) or \
                tuple(states["cross"]["k"].shape) != (
                    cfg.n_layers, b, WH_FRAMES, cfg.n_kv_heads, cfg.head_dim):
            raise AssertionError(f"whisper prefill {b}x{t}: bad logits or "
                                 f"states")
        med = statistics.median(secs[1:])
        out["prefill"][f"{b}x{t}"] = {
            "first_s": secs[0], "median_s": med, "tokens_per_s": b * t / med,
            "frames_per_s": b * WH_FRAMES / med}
        del logits, states
    toks = prompts[(WH_BATCH, WH_PROMPT)]
    max_seq = WH_PROMPT + WH_DECODE
    before = sw.launches
    with torch.no_grad():
        lg, st = TM.encdec_forward(cfg, params, toks, frames, mode="prefill",
                                   cache_len=max_seq)
    if sw.launches - before != WH_PER_PREFILL:
        raise AssertionError("whisper sized prefill: launches")
    state = _wh_decode_state(TM, cfg, st, WH_BATCH, max_seq)
    tok = lg[:, -1:].argmax(-1)
    seq = [tok]
    pos = torch.full((WH_BATCH,), WH_PROMPT, device="cuda")
    before = sw.launches
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(WH_DECODE):
        logits, state = serve_step(params, tok, state, pos + i)
        tok = logits.argmax(-1)
        seq.append(tok)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t1
    dec_launches = sw.launches - before
    launches = sw.launches
    # --- end of the main path ---
    if _build.n_builds != builds:
        raise AssertionError("an nvcc build ran on the whisper serving path")
    if dec_launches != WH_PER_STEP * WH_DECODE or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"whisper decode: {dec_launches} swa_attention "
                             f"launches for {WH_DECODE} steps, expected "
                             f"{WH_PER_STEP} a step")
    out["decode"] = {"batch": WH_BATCH, "steps": WH_DECODE, "seconds": dec_s,
                     "tokens_per_s": WH_BATCH * WH_DECODE / dec_s}
    out.update(launches=launches, launches_per_prefill_call=WH_PER_PREFILL,
               launches_per_decode_step=WH_PER_STEP)
    p8 = out["prefill"][f"{WH_BATCH}x{WH_PROMPT}"]
    log(f"phase whisper serving: {n_params} params bf16 "
        f"({cfg.n_encoder_layers} + {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}) init {init_s!r} s; prefill "
        + ", ".join(f"{k}: {v['tokens_per_s']!r} tokens/s, "
                    f"{v['frames_per_s']!r} frames/s"
                    for k, v in out["prefill"].items())
        + f"; decode B={WH_BATCH} x {WH_DECODE} steps "
        f"{out['decode']['tokens_per_s']!r} tokens/s; swa_attention launches "
        f"{launches} ({WH_PER_PREFILL} per prefill call, {WH_PER_STEP} per "
        f"decode step; no build) card=\"{card}\"")

    out["check_seconds"], t_chk = {}, [time.perf_counter()]

    def checked(name):
        now = time.perf_counter()
        out["check_seconds"][name] = now - t_chk[0]
        t_chk[0] = now

    # encoder alone: frames/s of encode() at B = 8
    enc = lambda: TM.encode(cfg, params, frames)
    with torch.no_grad():
        enc_ms = events_ms(enc, 5)
    out["encoder"] = {"ms": enc_ms,
                      "frames_per_s": WH_BATCH * WH_FRAMES / enc_ms * 1e3,
                      "share_of_prefill": enc_ms / 1e3 / p8["median_s"]}
    log(f"time whisper encoder B={WH_BATCH} x {WH_FRAMES} frames: {enc_ms!r} "
        f"ms (events) = {out['encoder']['frames_per_s']!r} frames/s; "
        f"{out['encoder']['share_of_prefill']!r} of a {WH_BATCH} x "
        f"{WH_PROMPT} prefill call card=\"{card}\"")
    checked("encoder_time")
    # every WH_CHECKED-th completion against single-request greedy decoding
    done = torch.cat(seq, dim=1).tolist()
    near_tie = lambda best: LM_BF16_ULPS * bf16_ulp(best)
    checks = [wh_greedy_check(TM, cfg, params, toks[r:r + 1],
                              frames[r:r + 1], done[r], near_tie)
              for r in range(0, WH_BATCH, WH_CHECKED)]
    ties = [t for c in checks for t in c["ties"]]
    out["batch_vs_single_request"] = {
        "rows": list(range(0, WH_BATCH, WH_CHECKED)),
        "positions": sum(c["positions"] for c in checks),
        "min_top2_margin": min(c["min_margin"] for c in checks),
        "equal_rows": sum(not c["ties"] for c in checks),
        "near_ties": ties}
    log(f"check whisper bf16 decode: every token of rows "
        f"{out['batch_vs_single_request']['rows']} of the {WH_BATCH} "
        f"({out['batch_vs_single_request']['positions']} positions) is "
        f"single-request greedy on the card or a near-tie; "
        f"{out['batch_vs_single_request']['equal_rows']} equal outright; "
        f"{len(ties)} near-ties (within {LM_BF16_ULPS} bf16 ulp of the max)")
    checked("batch_vs_single_request_bf16")
    out["profile"] = wh_profile(TM, launch, cfg, params, frames, toks, card)
    checked("profile")
    del params, state, st, lg, logits
    torch.cuda.empty_cache()
    out.update(wh_fp32_checks(sw, TM, cfg, rng))
    checked("fp32")
    log(f"phase whisper: seconds by check {out['check_seconds']}")
    return out


def wh_profile(TM, launch, cfg, params, frames, toks, card) -> dict:
    """One profiled B = 8 prefill call (``profile_prefill``: idle share,
    the kernel's and the matmuls' share of the busy time) and a profiled
    window of WH_PROFILE_STEPS decode steps at B = 8 after a sized prefill
    and 4 unprofiled steps (idle share, the kernel's and the matmuls'
    device time), beside the decoder's self-attention blocks of a step
    (``attention_decode``: projections, the ring-cache write, the plain
    grouped scores, softmax and sum) timed alone by CUDA events, x 12."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import attention as at
    pre = profile_prefill(launch.make_prefill_step(cfg), params, toks,
                          WH_PER_PREFILL, batch={"tokens": toks,
                                                 "frames": frames})
    serve_step = launch.make_serve_step(cfg)
    n = WH_PROMPT + 4 + WH_PROFILE_STEPS
    with torch.no_grad():
        lg, st = TM.encdec_forward(cfg, params, toks, frames, mode="prefill",
                                   cache_len=n)
    state = _wh_decode_state(TM, cfg, st, WH_BATCH, n)
    tok = lg[:, -1:].argmax(-1)
    pos = torch.full((WH_BATCH,), WH_PROMPT, device="cuda")
    for i in range(4):
        lg, state = serve_step(params, tok, state, pos + i)
        tok = lg.argmax(-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(WH_PROFILE_STEPS):
            lg, state = serve_step(params, tok, state, pos + 4 + i)
            tok = lg.argmax(-1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = _device_ops(prof)
    busy = sum(t for _, t in dev.values())
    if busy <= 0:
        raise AssertionError("the profiled whisper decode window has no "
                             "device time")
    kern = sum(t for k, (_, t) in dev.items() if SWA_KERNEL in k)
    n_kern = sum(c for k, (c, _) in dev.items() if SWA_KERNEL in k)
    mm = _matmul_us(dev)
    # the self-attention block of one decoder layer, alone, on a copy of
    # layer 0's cache at the window's last position
    p0 = TM.transformer.layer_state(params["dec_blocks"], 0)["attn"]
    cache = {k: v[0].clone() for k, v in state["self"].items()}
    xa = torch.randn((WH_BATCH, 1, cfg.d_model), device="cuda",
                     dtype=torch.bfloat16)
    p_last = pos + 3 + WH_PROFILE_STEPS
    with torch.no_grad():
        self_ms = events_ms(lambda: at.attention_decode(
            p0, xa, cache, cfg, kind="attn", pos=p_last), 20)
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:10]
    dec = {"steps": WH_PROFILE_STEPS, "batch": WH_BATCH,
           "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "device_idle_share": 1.0 - busy / wall_us,
           "host_ms_per_step": wall_us / WH_PROFILE_STEPS / 1e3,
           "swa_attention_ms": kern / 1e3, "swa_attention_launches": n_kern,
           "swa_share_of_busy": kern / busy, "matmul_ms": mm / 1e3,
           "matmul_share_of_busy": mm / busy,
           "self_attention_block_ms_events": self_ms,
           "self_attention_blocks_per_step_ms": cfg.n_layers * self_ms,
           "top_device_ops": {k: {"count": c, "device_ms": t / 1e3}
                              for k, (c, t) in top}}
    log(f"profile whisper prefill {WH_BATCH} x {WH_PROMPT} (+ {WH_FRAMES} "
        f"frames): wall_ms={pre['wall_ms']!r} device_busy_ms="
        f"{pre['device_busy_ms']!r} device_idle_share="
        f"{pre['device_idle_share']!r} swa_attention_ms="
        f"{pre['swa_attention_ms']!r} ({pre['swa_attention_launches']} "
        f"launches, share of busy {pre['swa_share_of_busy']!r}) matmul share "
        f"{pre['matmul_share_of_busy']!r} ({pre['pad_records_left_out']} pad "
        f"records left out) card=\"{card}\"")
    log(f"profile whisper decode B={WH_BATCH} x {WH_PROFILE_STEPS} steps: "
        f"wall_ms={dec['wall_ms']!r} device_busy_ms={dec['device_busy_ms']!r} "
        f"device_idle_share={dec['device_idle_share']!r}; swa_attention "
        f"(cross) {dec['swa_attention_ms']!r} ms ({n_kern} launches, share "
        f"of busy {dec['swa_share_of_busy']!r}); matmuls {dec['matmul_ms']!r} "
        f"ms (share {dec['matmul_share_of_busy']!r}); the self-attention "
        f"block alone {self_ms!r} ms a layer by events, x {cfg.n_layers} = "
        f"{dec['self_attention_blocks_per_step_ms']!r} ms a step; top: "
        + ", ".join(f"{k[:48]} {v['device_ms']!r} ms x {v['count']}"
                    for k, v in list(dec["top_device_ops"].items())[:5])
        + f" card=\"{card}\"")
    del state, st, lg, cache
    return {"prefill": pre, "decode": dec}


def wh_fp32_checks(sw, TM, cfg, rng) -> dict:
    """The fp32 model at full size: the card against the CPU (2 requests,
    WH_F32_TOKENS prompt tokens, WH_F32_STEPS[0] decode steps), the model
    with the kernel against the same with the plain attention, and a
    prefill plus WH_F32_STEPS[1] decode steps against one forward over the
    whole sequence, each within LM_F32_ATOL."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    p_gpu = TM.init_params(cfg32, seed=SEED, device="cuda")
    frames = _wh_frames(2, cfg.d_model, SEED + 213)
    n_dec = max(WH_F32_STEPS)
    seq = _prompt_tokens(rng, cfg, 2, WH_F32_TOKENS + n_dec)
    toks = seq[:, :WH_F32_TOKENS]
    out = {}
    with torch.no_grad():
        # card vs CPU
        t1 = time.perf_counter()
        p_cpu = TM.transformer.tree_map(lambda t: t.cpu(), p_gpu)
        n_c = WH_F32_TOKENS + WH_F32_STEPS[0]

        def side(p, dev):
            """The prefill's last logits and each step's, and the state."""
            lg, st = TM.encdec_forward(cfg32, p, toks.to(dev), frames.to(dev),
                                       mode="prefill", cache_len=n_c)
            state = TM.init_encdec_decode_state(cfg32, 2, n_c, WH_FRAMES,
                                                device=dev)
            state.update(self=st["cache"], cross_k=st["cross"]["k"],
                         cross_v=st["cross"]["v"])
            lgs = [lg[:, -1:].cpu()]
            for i in range(WH_F32_STEPS[0]):
                tok = seq[:, WH_F32_TOKENS + i:WH_F32_TOKENS + i + 1]
                lg, state = TM.encdec_decode_step(
                    cfg32, p, tok.to(dev), state,
                    torch.full((2,), WH_F32_TOKENS + i, device=dev))
                lgs.append(lg.cpu())
            return lgs, state

        (lg_g, st_g), (lg_c, st_c) = side(p_gpu, "cuda"), side(p_cpu, "cpu")
        errs = [float((a - b).abs().max()) for a, b in zip(lg_g, lg_c)]
        cross_err = float((st_g["cross_k"].cpu() - st_c["cross_k"])
                          .abs().max())
        if not max(errs) <= LM_F32_ATOL:
            raise AssertionError(f"whisper fp32 card vs CPU: logits errs "
                                 f"{errs}")
        out["card_vs_cpu_fp32"] = {"logits_max_abs_err": errs,
                                   "cross_k_max_abs_err": cross_err,
                                   "atol": LM_F32_ATOL,
                                   "seconds": time.perf_counter() - t1}
        log(f"check whisper fp32 card vs CPU (2 x {WH_FRAMES} frames, 2 x "
            f"{WH_F32_TOKENS} prompt tokens + {WH_F32_STEPS[0]} decode steps)"
            f": logits max abs err per call {errs} (atol {LM_F32_ATOL}); "
            f"cross k {cross_err!r}")
        del p_cpu, st_g, st_c
        # the kernel against the plain attention, the whole sequence
        full, _ = TM.encdec_forward(cfg32, p_gpu, seq, frames)
        plain, _ = TM.encdec_forward(cfg32, p_gpu, seq, frames,
                                     swa_impl=sw.swa_attention_plain)
        k_err = float((full - plain).abs().max())
        if not k_err <= LM_F32_ATOL:
            raise AssertionError(f"whisper kernel vs plain attention (fp32 "
                                 f"model): {k_err!r}")
        out["kernel_vs_plain_model_fp32"] = {
            "tokens": seq.shape[1], "logits_max_abs_err": k_err,
            "atol": LM_F32_ATOL}
        # prefill + decode against the forward
        n_f = WH_F32_TOKENS + WH_F32_STEPS[1]
        lg, st = TM.encdec_forward(cfg32, p_gpu, toks, frames, mode="prefill",
                                   cache_len=n_f)
        d_err = float((lg - full[:, :WH_F32_TOKENS]).abs().max())
        state = _wh_decode_state(TM, cfg32, st, 2, n_f)
        for i in range(WH_F32_STEPS[1]):
            p_i = WH_F32_TOKENS + i
            lg, state = TM.encdec_decode_step(
                cfg32, p_gpu, seq[:, p_i:p_i + 1], state,
                torch.full((2,), p_i, device="cuda"))
            d_err = max(d_err, float((lg[:, 0] - full[:, p_i]).abs().max()))
        if not d_err <= LM_F32_ATOL:
            raise AssertionError(f"whisper fp32 prefill + decode vs forward: "
                                 f"{d_err!r}")
        out["decode_vs_forward_fp32"] = {
            "prefill": WH_F32_TOKENS, "decode": WH_F32_STEPS[1],
            "logits_max_abs_err": d_err, "atol": LM_F32_ATOL}
    log(f"check whisper fp32: kernel vs plain attention in the model "
        f"({seq.shape[1]} tokens, every position) {k_err!r}; prefill "
        f"{WH_F32_TOKENS} + {WH_F32_STEPS[1]} decode steps vs one forward "
        f"{d_err!r} (atol {LM_F32_ATOL})")
    del p_gpu, full, plain, state, st
    torch.cuda.empty_cache()
    return out


def wh_times(sw, card) -> dict:
    """The D = 64 kernel in bf16 at WH_TIMES (L2 flushed and warm, CUDA
    events and CUPTI) beside its bound (and the SFU's limit), the plain
    version's time (one call, events) and SDPA's: the default call (events;
    the kernels line's ``library_ms``), which backend it picks, and each of
    flash, efficient and cuDNN that accepts the call. Then fp32 at
    WH_F32_TIMES: the CUDA-core kernel beside SDPA's efficient backend in
    fp32, by events, flushed."""
    cyc = sleep_cycles_per_ms()
    flush = l2_flusher()
    rows = {}
    for name, b, sq, sk, causal in WH_TIMES:
        q, k, v = swa_inputs(b, sq, sk, 12, 12, 64, torch.bfloat16,
                             SEED + 215)
        kern = lambda: sw.swa_attention_cuda(q, k, v, causal=causal)
        lib = sdpa_fn(q, k, v, None, causal=causal)
        got = kern()
        err = float((lib().transpose(1, 2).float() - got.float()).abs()
                    .max())
        bnd = swa_bound(b, sq, sk, 12, 12, 64, None, causal)
        rec = {"shape": [b, sq, sk, 12, 12, 64], "causal": causal,
               "dtype": "bfloat16",
               "cupti_ms": cupti_ms(kern, flush, SWA_KERNEL),
               "warm_l2_cupti_ms": cupti_ms(kern, None, SWA_KERNEL),
               "ms": device_ms(kern, cyc, flush)[0],
               "warm_l2_ms": device_ms(kern, cyc, None)[0],
               "library_ms": device_ms(lib, cyc, flush)[0],
               "library_backend": sdpa_backend_of(q, k, v, None, causal),
               "library_backends": sdpa_backends(q, k, v, got, cyc, flush,
                                                 TIMED_LAUNCHES, None,
                                                 causal),
               "library_vs_kernel_max_abs_diff": err,
               "plain_ms": events_ms(lambda: sw.swa_attention_plain(
                   q, k, v, causal=causal), 1), **bnd}
        rec["share_of_bound"] = bnd["bound_ms"] / rec["ms"]
        rows[name] = rec
        lim = bnd["limits_ms"]
        log(f"time swa_attention D=64 {name} ({b}, {sq}, {sk}, 12/12, 64) "
            f"bf16 causal={causal} L2 flushed: kernel_ms={rec['ms']!r} (cupti "
            f"{rec['cupti_ms']!r}; L2-warm {rec['warm_l2_ms']!r}, cupti "
            f"{rec['warm_l2_cupti_ms']!r}) plain_ms={rec['plain_ms']!r} "
            f"bound_ms={bnd['bound_ms']!r} ({bnd['bound_by']}; share reached "
            f"{rec['share_of_bound']!r}); limits ms: bytes {lim['bytes']!r}, "
            f"tensor-core FLOP {lim['operations']!r}, SFU exp "
            f"{lim['sfu_exp']!r}; SDPA default {rec['library_backend']} "
            f"{rec['library_ms']!r} ms (max |SDPA - kernel| {err!r}); by "
            f"backend: " + "; ".join(
                f"{k_}: {v_['ms']!r} ms" if v_["accepted"]
                else f"{k_}: refused ({v_['why'][:60]})"
                for k_, v_ in rec["library_backends"].items())
            + f" card=\"{card}\"")
        del q, k, v, got
        torch.cuda.empty_cache()
    for name, b, s, h, kv, d, window, causal in WH_F32_TIMES:
        q, k, v = swa_inputs(b, s, s, h, kv, d, torch.float32, SEED + 216)
        kern = lambda: sw.swa_attention_cuda(q, k, v, window=window,
                                             causal=causal)
        lib = sdpa_fn(q, k, v, window, "EFFICIENT_ATTENTION", causal)
        err = float((lib().transpose(1, 2) - kern()).abs().max())
        bnd = swa_bound(b, s, s, h, kv, d, window, causal)
        lim = {"bytes": bnd["bytes"] * 2 / HBM_BYTES_PER_S * 1e3,
               "operations": 4 * d * bnd["pairs"] / FP32_FLOP_PER_S * 1e3}
        rec = {"shape": [b, s, s, h, kv, d], "window": window,
               "causal": causal, "dtype": "float32",
               "ms": device_ms(kern, cyc, flush, CHUNK * 2)[0],
               "library_ms": device_ms(lib, cyc, flush, CHUNK * 2)[0],
               "library_backend": "EFFICIENT_ATTENTION",
               "library_vs_kernel_max_abs_diff": err,
               "bound_ms": max(lim.values()),
               "bound_by": max(lim, key=lim.get)}
        rows[f"fp32/{name}"] = rec
        log(f"time swa_attention fp32 {name} ({b}, {s}, {h}/{kv}, {d}) "
            f"W={window} causal={causal} L2 flushed, events: kernel "
            f"{rec['ms']!r} ms, SDPA efficient (fp32) {rec['library_ms']!r} "
            f"ms (max |diff| {err!r}), bound {rec['bound_ms']!r} ms "
            f"({rec['bound_by']}; 4 D FLOP a pair at "
            f"{FP32_FLOP_PER_S / 1e12:g} TFLOP/s) card=\"{card}\"")
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def whisper_phase(sw, _build, TC, TM, launch, card) -> dict:
    """Phase 21 (slice 18): the D = 64 kernel vs plain, whisper-small served
    at full size, the kernel's times."""
    t0 = time.perf_counter()
    parts, lap = {}, [t0]

    def done(name):
        parts[name] = time.perf_counter() - lap[0]
        lap[0] = time.perf_counter()

    out = {"parity": wh_vs_plain(sw)}
    done("parity")
    out["serving"] = wh_serving_path(sw, _build, TC, TM, launch, card)
    done("serving")
    out["times"] = wh_times(sw, card)
    done("times")
    out["launches"] = out["serving"]["launches"]
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    log(f"phase whisper: {out['seconds']!r} s; by part {parts}")
    return out


def whisper_alone() -> dict:
    """Phase 21 without the rest of the script (``python3 -c 'import
    chip_smoke as c; c.whisper_alone()'``): builds the kernels, logs
    ptxas's lines and the HGMMA count of the D = 64 kernel, then the
    whisper phase."""
    if not torch.cuda.is_available():
        raise SystemExit("whisper_alone: no CUDA card")
    TC, launch, TM, _build, sw, _, _ = _alone_modules()
    card = card_line()
    log(f"card {card}")
    _build.load()
    for line in str(_build.build_info.get("log", "")).splitlines():
        if ("ptxas info" in line and ("Used" in line or "Compiling" in line)
                and "swa_attention" in line and "ILi64E" in line) or \
                "(C75" in line or ("spill" in line
                                   and " 0 bytes spill stores" not in line):
            log(f"build: {line.strip()}")
    n = hgmma_counts(_build, (WH_KERNEL_SASS,))
    log(f"HGMMA: {n}")
    if not n[WH_KERNEL_SASS]:
        raise AssertionError(f"the D = 64 bf16 kernel issues no wgmma: {n}")
    return whisper_phase(sw, _build, TC, TM, launch, card)


# --- phase 22: whisper-small training (slice 19) -----------------------------------

WT_ARCH = WH_ARCH
WT_SEQ = 448                          # whisper's text context (tokens a row)
# The D = 64 backward's shapes on whisper-small's training step (A 2 x B 2
# rows, 1,500 frames, 448 tokens, 12 / 12 heads): (name, b, sq, sk, causal)
WT_SHAPES = (("encoder", TR_BATCH, WH_FRAMES, WH_FRAMES, False),
             ("cross", TR_BATCH, WT_SEQ, WH_FRAMES, False),
             ("decoder", TR_BATCH, WT_SEQ, WT_SEQ, True))
# the example twin: examples/torch_train_lm_federated.py at full size, A 2
# x 4 x 128 tokens, periodic tau 8, 8 steps (one period and its sync)
LM100M_RUN = dict(steps=8, agents=2, tau=8, strategy="periodic")
# The cases held against the plain version: (name, b, sq, sk, causal, h, kv)
# of whisper-small's step (12 / 12 heads) and the lm-100m twin's (B 4, 128
# tokens, 8 query heads on 4 KV heads: the D = 64 dk / dv head-group sum)
WT_CHECKS = tuple(c + (12, 12) for c in WT_SHAPES) + (
    ("lm100m", 4, 128, 128, True, 8, 4),)


def wt_bwd_vs_plain(sw, swb) -> dict:
    """Phase 22 (1): the D = 64 backward (and the forward's lse) against
    their plain versions at ``WT_CHECKS``, fp32 and bf16, by phase 18's rule
    (``bwd_check``: lse within LSE_REL, fp32 within BWD_REL of the largest
    |gradient|, bf16 against float64 within BWD_MAX_RATIO / BWD_MEAN_RATIO
    x the plain version's max / mean error, a second launch bitwise); in
    bf16 also the one-bf16 p / ds control (``bwd_control``), which the rule
    must reject at every case."""
    rows, worst = [], {"float32": 0.0, "bfloat16": 0.0}
    control_min = math.inf
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for n, (label, b, sq, sk, causal, h, kv) in enumerate(WT_CHECKS):
            q, k, v, do = bwd_inputs(b, sq, h, kv, 64, dtype, SEED + 240 + n,
                                     sk)
            what = (f"swa_attention_bwd D=64 {label} ({b}, {sq}, {sk}, "
                    f"{h}/{kv}) causal={causal} {name}")
            row = bwd_check(sw, swb, q, k, v, do, None, what, causal)
            row.update(name=label, shape=[b, sq, sk, h, kv, 64],
                       causal=causal, dtype=name)
            if dtype == torch.bfloat16:
                row["control_mean_ratio"] = bwd_control(
                    sw, swb, q, k, v, do, None, row, what, causal)
                control_min = min(control_min, row["control_mean_ratio"])
            worst[name] = max(worst[name], row["err"])
            rows.append(row)
            del q, k, v, do
    torch.cuda.empty_cache()
    ratios = [max(r[g]["mean_err"] / max(r[g]["plain_mean_err"], 1e-30)
                  for g in ("dq", "dk", "dv"))
              for r in rows if r["dtype"] == "bfloat16"]
    out = {"cases": rows, "worst": worst, "mean_ratio_max": max(ratios),
           "control_ratio_min": control_min,
           "lse_rel_err_max": max(r["lse_rel_err"] for r in rows)}
    log(f"phase whisper train: swa_attention_bwd D=64 vs plain at {len(rows)} "
        f"cases ok ({[c[0] for c in WT_CHECKS]} x fp32 / bf16; fp32 within "
        f"{BWD_REL} x max |grad|, bf16 within {BWD_MAX_RATIO} / "
        f"{BWD_MEAN_RATIO} x the plain version's max / mean error against "
        f"float64; the forward's lse within {LSE_REL}; a second launch "
        f"bitwise); largest |kernel - reference| {worst}; bf16 mean err / "
        f"plain's at most {out['mean_ratio_max']!r}, the one-bf16 p / ds "
        f"control at least {control_min!r}; lse rel err at most "
        f"{out['lse_rel_err_max']!r}")
    return out


def lm100m_twin(km, sw, swb, wk, _build, card) -> dict:
    """Phase 22 (3): ``examples/torch_train_lm_federated.py``'s ``run`` at
    full size (``LM100M_RUN``: the fp32 D = 64 backward on the CUDA cores,
    causal, 8 query heads on 4 KV heads), the counts set to 0 before and
    read after: launches exactly ``_train_expected``, losses finite, the
    agent rows bitwise equal after the sync, no build."""
    import importlib.util
    from repro_torch.launch.fedtrain import FedTrainConfig
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm_federated",
        os.path.join(ROOT, "examples", "torch_train_lm_federated.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    cfg = ex.lm100m()
    r = LM100M_RUN
    fed = FedTrainConfig(strategy=r["strategy"], tau=r["tau"])
    builds = _build.n_builds
    _tr_reset(km, sw, swb, wk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = ex.run(r["steps"], r["agents"], r["tau"], r["strategy"],
                           device="cuda", log_every=r["steps"] + 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _tr_counts(km, sw, swb, wk)
    got = {k: counts[k] for k in TR_KERNELS}
    want = _train_expected(cfg, fed, r["agents"], r["steps"])
    if got != want or counts["others"] != {k: 0 for k in counts["others"]}:
        raise AssertionError(f"lm-100m: launches {got}, expected {want} "
                             f"(others {counts['others']})")
    if _build.n_builds != builds:
        raise AssertionError("a build on the lm-100m training path")
    equal = bool(torch.equal(state.params[0], state.params[1]))
    if not (all(math.isfinite(x) for x in losses) and equal):
        raise AssertionError(f"lm-100m: losses {losses}, rows equal {equal}")
    tokens = r["steps"] * r["agents"] * ex.BATCH * ex.SEQ
    out = {"arch": cfg.name, "params_per_agent": state.layout.n,
           "losses": losses, "wall_s": wall,
           "tokens_per_s_incl_init": tokens / wall, "launches": got,
           "rows_equal_after_sync": equal, **r}
    log(f"phase whisper train: lm-100m twin (examples/torch_train_lm_"
        f"federated.py, {state.layout.n} fp32 parameters an agent, A "
        f"{r['agents']} x {ex.BATCH} x {ex.SEQ}, {r['strategy']} tau "
        f"{r['tau']}, {r['steps']} steps) {wall!r} s with init, losses "
        f"{losses[0]!r} -> {losses[-1]!r}; rows equal after the sync; "
        f"launches {got} (the formula's) card=\"{card}\"")
    del state
    torch.cuda.empty_cache()
    return out


def wt_times(sw, swb, card) -> dict:
    """Phase 22 (4): the D = 64 backward in bf16 at ``WT_SHAPES``: CUPTI (L2
    flushed; the dq and dk / dv kernels' records summed) and CUDA events
    (flushed and warm), beside the bound (``bwd_bound``), the plain
    version's time (one call, events) and SDPA's autograd backward on
    repeated K/V (events, flushed)."""
    cyc = sleep_cycles_per_ms()
    flush = l2_flusher()
    rows = {}
    for label, b, sq, sk, causal in WT_SHAPES:
        q, k, v, do = bwd_inputs(b, sq, 12, 12, 64, torch.bfloat16,
                                 SEED + 250, sk)
        o, lse = sw.swa_attention_cuda(q, k, v, causal=causal, with_lse=True)
        kern = lambda: swb.swa_attention_bwd_cuda(q, k, v, o, do, lse,
                                                  causal=causal)
        lib = sdpa_bwd_fn(q, k, v, do, None, causal)
        rec = {"shape": [b, sq, sk, 12, 12, 64], "causal": causal,
               "dtype": "bfloat16",
               "cupti_ms": sum(cupti_ms(kern, flush, n) for n in BWD_KERNELS),
               "ms": device_ms(kern, cyc, flush, CHUNK)[0],
               "warm_l2_ms": device_ms(kern, cyc, None, CHUNK)[0],
               "plain_ms": events_ms(lambda: swb.swa_attention_bwd_plain(
                   q, k, v, o, do, lse, causal=causal), 1),
               "library_ms": device_ms(lib, cyc, flush, CHUNK)[0],
               "library_backend": sdpa_backend_of(q, k, v, None, causal),
               **bwd_bound(b, sq, 12, 12, 64, None, sk, causal)}
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rows[label] = rec
        log(f"time swa_attention_bwd D=64 {label} ({b}, {sq}, {sk}, 12/12, "
            f"64) bf16 causal={causal} L2 flushed: kernel_ms={rec['ms']!r} "
            f"(cupti {rec['cupti_ms']!r}; L2-warm {rec['warm_l2_ms']!r}) "
            f"plain_ms={rec['plain_ms']!r} bound_ms={rec['bound_ms']!r} "
            f"({rec['bound_by']}; {rec['pairs']} pairs, {rec['flops']} FLOP, "
            f"{rec['bytes']} B; share {rec['share_of_bound']!r}) library_ms="
            f"{rec['library_ms']!r} (SDPA backward, {rec['library_backend']} "
            f"forward choice) card=\"{card}\"")
        del q, k, v, do, o, lse, lib
        torch.cuda.empty_cache()
    return rows


def whisper_train_phase(km, sw, swb, wk, _build, TC, TM, launch,
                        card) -> dict:
    """Phase 22 (slice 19): (1) the D = 64 backward vs plain at whisper's
    and the lm-100m twin's training shapes (``WT_CHECKS``), (2) whisper-small trained at full size through
    ``train()`` (``train_model_path``: A 2 x 2 x 448 tokens, 1,500 frames
    a row), (3) the lm-100m example twin, (4) the backward's times."""
    t0 = time.perf_counter()
    parts, lap = {}, [t0]

    def done(name):
        parts[name] = time.perf_counter() - lap[0]
        lap[0] = time.perf_counter()

    out = {"bwd64_parity": wt_bwd_vs_plain(sw, swb)}
    done("bwd64_parity")
    cfg = TC.get_arch(WT_ARCH)
    out["whisper"] = train_model_path(km, sw, swb, wk, TC, TM, launch, card,
                                      WT_ARCH, cfg.n_layers, seq=WT_SEQ)
    done("whisper")
    out["lm100m"] = lm100m_twin(km, sw, swb, wk, _build, card)
    done("lm100m")
    out["times"] = wt_times(sw, swb, card)
    done("times")
    out["launches"] = {k: out["whisper"]["launches"][k]
                       + out["lm100m"]["launches"][k] for k in TR_KERNELS}
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    log(f"phase whisper train: {out['seconds']!r} s; by part {parts}; main "
        f"path launches {out['launches']}")
    return out


def whisper_train_alone() -> dict:
    """Phase 22 without the rest of the script (``python3 -c 'import
    chip_smoke as c; c.whisper_train_alone()'``): builds the kernels, logs
    ptxas's lines for the D = 64 backward kernels, then the phase."""
    if not torch.cuda.is_available():
        raise SystemExit("whisper_train_alone: no CUDA card")
    TC, launch, TM, _build, sw, swb, wk = _alone_modules()
    km, _, _, _ = _sweep_modules()
    card = card_line()
    log(f"card {card}")
    _build.load()
    for line in str(_build.build_info.get("log", "")).splitlines():
        if ("ptxas info" in line and ("Used" in line or "Compiling" in line)
                and "swa_bwd" in line and "ILi64E" in line) or \
                "(C75" in line or ("spill" in line
                                   and " 0 bytes spill stores" not in line):
            log(f"build: {line.strip()}")
    return whisper_train_phase(km, sw, swb, wk, _build, TC, TM, launch, card)


# --- phase 23: MoE serving (slice 20) ----------------------------------------------

MOE_ARCHS = ("kimi-k2-1t-a32b", "arctic-480b")
# kimi-k2: its dense first layer and one MoE layer of 61; arctic: 2 of 35
# MoE layers. Three kimi layers would hold ~74 GB of the card's 80.
MOE_LAYERS = 2
# the 2-layer trees' counts (tests/test_torch_moe.py)
MOE_PARAMS = {"kimi-k2-1t-a32b": 19_967_675_392, "arctic-480b": 27_681_131_520}
MOE_PREFILL = ((8, 512), (1, 8192))   # per-sequence groups; two of 4096
MOE_TIMED = 1                         # timed prefill calls per shape
MOE_DECODE_TOKENS = 16
MOE_NEW = (16, 32)                    # new tokens of a loop request
MOE_MAX_SEQ = 576                     # prompts of 16-512 tokens + 32 new
MOE_CHECKED = 4                       # every 4th completion held to B = 1
# Kernel vs plain attention in the bf16 model at 8 x 512: the two runs'
# hidden states differ by the attention's roundings, so a token's top-k may
# differ where router logits nearly tie. A token whose ordered top-k differs
# is accepted only where, all read on the plain run's logits and within
# MOE_FLIP_ULPS bf16 ulp of the token's largest |router logit|
# (``moe_route_gaps``): at each rank where the two runs differ, the plain
# run's expert and the kernel run's; every expert of the kernel run's top k
# and the plain run's k-th; every plain top-k expert the kernel run left
# out and every one it took in its place (the router product is rounded to
# bf16 once in each run, and the attention's one-ulp differences move
# every logit by a fraction of an ulp of that scale more). A token at or
# after a route change of an earlier MoE layer in its sequence (it sees
# that change through attention) is counted, not held; so is a kept slot
# that changes after a flip in its group (the flip shifts the positions in
# two experts). The logits of the rows that saw no change (none at or
# before them in an earlier MoE layer, none of their own in the last) must
# lie within MOE_LOGIT_ULPS bf16 ulp of the row's largest |logit| (a bf16
# product rounded once in each run, over two layers of bf16 residual adds,
# norms and FFNs).
MOE_FLIP_ULPS = 4
MOE_LOGIT_ULPS = 8
# timed: (model, B, T, query heads, KV heads) at D = 128, causal, no window
MOE_TIMES = (("kimi-k2-1t-a32b", 8, 512, 64, 8),
             ("kimi-k2-1t-a32b", 1, 8192, 64, 8),
             ("arctic-480b", 8, 512, 56, 8),
             ("arctic-480b", 1, 8192, 56, 8))
# kernels of a profiled prefill counted as routing: the top-k and position
# sorts, the count scatter, the dispatch and combine gathers (and the
# embedding's row gather, a few µs)
MOE_ROUTING_OPS = ("sort", "radix", "scatter", "gather", "index", "scan")


def moe_config(TC, arch):
    """``arch`` at its published width, cut to MOE_LAYERS layers."""
    return dataclasses.replace(TC.get_arch(arch), n_layers=MOE_LAYERS)


class RecordedRoutes:
    """While entered, every ``moe.route`` call's ``Routing`` is appended to
    ``self.routes`` (the module function is wrapped and put back)."""

    def __init__(self, moe):
        self.moe, self.routes = moe, []

    def __enter__(self):
        orig = self._orig = self.moe.route

        def recorded(router, xg, cfg):
            r = orig(router, xg, cfg)
            self.routes.append(r)
            return r
        self.moe.route = recorded
        return self

    def __exit__(self, *exc):
        self.moe.route = self._orig
        return False


def _drop_share(routes) -> float:
    """The share of (token, slot) assignments dropped over ``routes``."""
    kept = sum(int(r.keep.sum()) for r in routes)
    total = sum(r.keep.numel() for r in routes)
    return 1.0 - kept / total


def _bf16_ulps(x: torch.Tensor) -> torch.Tensor:
    """``bf16_ulp`` elementwise: 2^(floor(log2 |x|) - 7)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
                      - 7)


def moe_route_gaps(rk, rp) -> torch.Tensor:
    """``(G, S_g)``: how far the kernel run's routing ``rk`` strays from the
    plain run's ``rp``, on the plain run's router logits, in bf16 ulp of
    the token's largest |logit|; 0 where the two top-k agree. The largest
    of: at each rank where the experts differ, the gap between the plain
    run's logit there and the plain logit of the kernel run's expert; how
    far the lowest plain logit of the kernel run's experts lies below the
    plain run's k-th; how far the highest plain logit of an expert that
    only the plain run chose lies above the lowest of one that only the
    kernel run chose."""
    lp = rp.logits
    at_p, at_k = lp.gather(-1, rp.experts), lp.gather(-1, rk.experts)
    rank = torch.where(rk.experts != rp.experts, (at_p - at_k).abs(),
                       0.0).amax(-1)
    below_kth = (at_p.amin(-1, keepdim=True) - at_k).clamp(min=0).amax(-1)
    p_only = ~(rp.experts[..., :, None] == rk.experts[..., None, :]).any(-1)
    k_only = ~(rk.experts[..., :, None] == rp.experts[..., None, :]).any(-1)
    swapped = (torch.where(p_only, at_p, -torch.inf).amax(-1)
               - torch.where(k_only, at_k, torch.inf).amin(-1)).clamp(min=0)
    gap = torch.maximum(torch.maximum(rank, below_kth), swapped)
    return gap / _bf16_ulps(lp.abs().amax(-1))


def moe_kernel_vs_plain(sw, moe, TM, cfg, params, toks) -> dict:
    """bf16, one prefill of ``toks`` (B x T, per-sequence groups) with the
    kernel, each attention layer's output held against the plain version on
    its own q, k, v (phase 12's rules, the control not required), and one
    with the plain attention; the routes of both recorded. Route changes,
    flips at near-ties and the logits by the MOE_FLIP_ULPS / MOE_LOGIT_ULPS
    rule (see there); raises where it breaks."""
    b, t = toks.shape
    rows = []

    def checked_kernel(q, k, v, *, window, causal):
        got = sw.swa_attention_cuda(q, k, v, window=window, causal=causal)
        row = {"layer": len(rows), "window": window}
        row.update(swa_check(sw, q, k, v, got, window, causal,
                             f"{cfg.name} {b}x{t} layer {len(rows)}",
                             control=False))
        rows.append(row)
        return got

    def plain(q, k, v, *, window, causal):
        return sw.swa_attention_plain(q, k, v, window=window, causal=causal)

    logits, routes = {}, {}
    for name, impl in (("kernel", checked_kernel), ("plain", plain)):
        with RecordedRoutes(moe) as rec:
            logits[name], _ = TM.prefill(cfg, params, toks, swa_impl=impl)
        routes[name] = rec.routes
    if len(rows) != cfg.n_layers:
        raise AssertionError(f"{cfg.name}: {len(rows)} attention calls, "
                             f"expected {cfg.n_layers}")
    pos = torch.arange(t, device=toks.device)
    first = torch.full((b,), t, device=toks.device)  # a sequence's first change
    layers = []
    for rk, rp in zip(routes["kernel"], routes["plain"]):
        if rp.experts.shape[:2] != (b, t):
            raise AssertionError(f"{cfg.name}: groups {tuple(rp.experts.shape)}"
                                 f" are not the {b} sequences")
        clean = pos[None, :] < first[:, None]
        changed = (rk.experts != rp.experts).any(-1)
        kept = (rk.keep != rp.keep).any(-1) & ~changed
        gap_ulps = moe_route_gaps(rk, rp)
        held = clean & changed
        if bool((gap_ulps[held] > MOE_FLIP_ULPS).any()):
            raise AssertionError(
                f"{cfg.name}: a route flip where the router logits do not "
                f"nearly tie: {float(gap_ulps[held].max())!r} bf16 ulp apart "
                f"(rule <= {MOE_FLIP_ULPS})")
        # a kept-slot change with no flip needs an earlier flip in its group
        flip_before = torch.cummax(changed.int(), dim=1).values.bool()
        flip_before = torch.cat([torch.zeros_like(flip_before[:, :1]),
                                 flip_before[:, :-1]], 1)
        if bool((clean & kept & ~flip_before).any()):
            raise AssertionError(f"{cfg.name}: a kept slot changed with no "
                                 f"flip before it in its group")
        any_change = changed | kept
        own_last, first_before_last = any_change, first
        first_here = torch.where(any_change, pos[None, :], t).amin(1)
        layers.append({
            "flips_held": int(held.sum()),
            "flip_gap_ulps_max": float(gap_ulps[held].max()) if bool(
                held.any()) else None,
            "flips_after_a_change": int((changed & ~clean).sum()),
            "kept_slot_changes": int(kept.sum()),
            "drop_share_kernel": _drop_share([rk]),
            "drop_share_plain": _drop_share([rp])})
        first = torch.minimum(first, first_here)
    # rows that saw no change: none at or before them in an earlier MoE
    # layer, none of their own in the last (its output reaches only them)
    clean = (pos[None, :] < first_before_last[:, None]) & ~own_last
    lk, lp = logits["kernel"], logits["plain"]
    ulp = _bf16_ulps(lp.abs().amax(-1))
    err_ulps = ((lk - lp).abs().amax(-1) / ulp)[clean]
    worst = float(err_ulps.max()) if err_ulps.numel() else 0.0
    if not worst <= MOE_LOGIT_ULPS:
        raise AssertionError(f"{cfg.name}: kernel vs plain logits "
                             f"{worst!r} bf16 ulp apart on rows before any "
                             f"route change (rule <= {MOE_LOGIT_ULPS})")
    out = {"shape": [b, t], "moe_layers": layers,
           "rows_held": int(clean.sum()), "rows": b * t,
           "logit_err_ulps_max": worst,
           "logit_max_abs_diff_held": float((lk - lp).abs().amax(-1)[clean]
                                            .max()) if bool(clean.any())
           else 0.0,
           "attention_max_err": max(r["err"] for r in rows),
           **_mean_ratios(rows)}
    del logits, routes
    torch.cuda.empty_cache()
    return out


def _moe_split(pr) -> dict:
    """A profiled MoE prefill's (``profile_prefill``'s) device ms: the
    expert FFN's batched products (``aten::bmm``), the other matrix
    products, the attention kernel, the routing's sorts, scatters and
    gathers (MOE_ROUTING_OPS), the rest."""
    routing = sum(o["device_ms"] for name, o in pr["device_ops"].items()
                  if any(n in name.lower() for n in MOE_ROUTING_OPS))
    split = {"expert_matmul": pr["aten_bmm_ms"],
             "other_matmul": pr["matmul_ms"] - pr["aten_bmm_ms"],
             "swa_attention": pr["swa_attention_ms"], "routing": routing}
    split["rest"] = pr["device_busy_ms"] - sum(split.values())
    return split


def moe_serving_path(sw, moe, _build, TC, TM, launch, card, arch) -> dict:
    """One MoE model at its published width, MOE_LAYERS layers, seeded bf16
    weights, through the user's entry points: ``make_prefill_step`` at
    8 x 512 (per-sequence groups) and 1 x 8192 (two groups of 4096),
    ``make_serve_step`` for MOE_DECODE_TOKENS tokens at B = 8, and an
    8-slot ``ServingLoop`` over 16 requests; the swa_attention counter set
    to 0 before this main path and read after it (one launch per layer per
    prefill call and admission, none per decode step, no build). The drop
    share of each prefill shape from its first call's routes. Then every
    MOE_CHECKED-th completion against single-request greedy decoding in
    the loop's split (bf16 near-ties counted), the kernel against the
    plain attention at 8 x 512 (``moe_kernel_vs_plain``) and a profiled
    prefill at each shape (``_moe_split``)."""
    cfg = moe_config(TC, arch)
    rng = np.random.default_rng(SEED + 230 + MOE_ARCHS.index(arch))
    t0 = time.perf_counter()
    params = TM.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = TM.count_params(params)
    if n_params != MOE_PARAMS[arch]:
        raise AssertionError(f"{arch}: {n_params} parameters, expected "
                             f"{MOE_PARAMS[arch]}")
    L = cfg.n_layers
    prefill_step = launch.make_prefill_step(cfg)
    serve_step = launch.make_serve_step(cfg)
    reqs = _requests(rng, launch, cfg, new=MOE_NEW)
    builds = _build.n_builds
    out = {"arch": arch, "params": n_params, "layers": L,
           "moe_layers": sum(TM.transformer.ffn_kind(cfg, i) == "moe"
                             for i in range(L)),
           "init_s": init_s, "init_peak_gb": init_peak / 1e9, "prefill": {}}

    # --- the main path, counted ---
    sw.launches = 0
    for b, t in MOE_PREFILL:
        toks = _prompt_tokens(rng, cfg, b, t)
        secs = []
        for i in range(1 + MOE_TIMED):
            before = sw.launches
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if i == 0:
                with RecordedRoutes(moe) as rec:
                    logits, states = prefill_step(params, {"tokens": toks})
            else:
                logits, states = prefill_step(params, {"tokens": toks})
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            if sw.launches - before != L:
                raise AssertionError(f"{arch} prefill {b}x{t}: "
                                     f"{sw.launches - before} swa_attention "
                                     f"launches, expected {L}")
        if tuple(logits.shape) != (b, 1, TM.padded_vocab(cfg)) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch} prefill {b}x{t}: bad logits")
        med = statistics.median(secs[1:])
        g = rec.routes[0].experts.shape[:2]
        out["prefill"][f"{b}x{t}"] = {
            "first_s": secs[0], "median_s": med, "tokens_per_s": b * t / med,
            "groups": list(g), "capacity": rec.routes[0].capacity,
            "drop_share": _drop_share(rec.routes),
            "drop_share_by_layer": [_drop_share([r]) for r in rec.routes]}
        del rec
        if b == LM_SLOTS:
            dec_logits, dec_states = logits, states
        del states, logits
    tok = dec_logits.argmax(-1)
    pos = torch.full((LM_SLOTS,), MOE_PREFILL[0][1], device="cuda")
    before = sw.launches
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(MOE_DECODE_TOKENS):
        logits, dec_states = serve_step(params, tok, dec_states, pos + i)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t1
    if sw.launches != before or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} decode: {sw.launches - before} "
                             f"swa_attention launches, expected 0")
    out["decode"] = {"batch": LM_SLOTS, "steps": MOE_DECODE_TOKENS,
                     "seconds": dec_s, "ms_per_step": dec_s * 1e3
                     / MOE_DECODE_TOKENS,
                     "tokens_per_s": LM_SLOTS * MOE_DECODE_TOKENS / dec_s}
    del dec_states, dec_logits
    loop = launch.ServingLoop(cfg, params, n_slots=LM_SLOTS,
                              max_seq=MOE_MAX_SEQ)
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
        raise AssertionError(f"an nvcc build ran on the {arch} serving path")
    if loop_launches != L * loop.n_prefills:
        raise AssertionError(f"{arch} ServingLoop: {loop_launches} "
                             f"swa_attention launches for {loop.n_prefills} "
                             f"prefills of {L} attention layers")
    got = {c.rid: c.tokens for c in done}
    if sorted(got) != list(range(len(reqs))) or any(
            len(got[r.rid]) != r.max_new_tokens for r in reqs):
        raise AssertionError(f"{arch} ServingLoop: missing or short "
                             f"completions")
    n_tok = sum(len(c.tokens) for c in done)
    out["loop"] = {"slots": LM_SLOTS, "requests": len(reqs),
                   "max_seq": MOE_MAX_SEQ,
                   "prompt_tokens": int(sum(len(r.prompt) for r in reqs)),
                   "new_tokens": n_tok, "seconds": loop_s,
                   "tokens_per_s": n_tok / loop_s,
                   "prefills": loop.n_prefills, "steps": loop.n_steps,
                   "launches": loop_launches}
    out["launches"] = launches
    del loop
    pf = out["prefill"]
    log(f"phase moe serving: {arch} {n_params} params bf16 ({L} of "
        f"{TC.get_arch(arch).n_layers} layers, {out['moe_layers']} MoE: "
        f"{cfg.n_experts} experts top-{cfg.top_k} of {cfg.expert_d_ff}; "
        f"attention {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}) "
        f"init {init_s!r} s, peak {out['init_peak_gb']!r} GB; prefill "
        f"tokens/s " + ", ".join(
            f"{k}: {v['tokens_per_s']!r} (groups {v['groups']}, C "
            f"{v['capacity']}, drop share {v['drop_share']!r})"
            for k, v in pf.items())
        + f"; decode B={LM_SLOTS} tokens/s {out['decode']['tokens_per_s']!r} "
        f"({out['decode']['ms_per_step']!r} ms a step); ServingLoop "
        f"{LM_SLOTS} slots x {len(reqs)} requests, max_seq {MOE_MAX_SEQ} "
        f"({out['loop']['prompt_tokens']} prompt + {n_tok} new tokens, "
        f"{out['loop']['prefills']} prefills, {out['loop']['steps']} steps) "
        f"{out['loop']['tokens_per_s']!r} new tokens/s; swa_attention "
        f"launches {launches} ({L} per prefill call, 0 per decode step; no "
        f"build) card=\"{card}\"")

    out["check_seconds"], t_chk = {}, [time.perf_counter()]

    def checked(name):
        now = time.perf_counter()
        out["check_seconds"][name] = now - t_chk[0]
        t_chk[0] = now

    near_tie = lambda best: LM_BF16_ULPS * bf16_ulp(best)
    checks = [lm_greedy_check(TM, cfg, params, r, got[r.rid], near_tie,
                              cache_len=MOE_MAX_SEQ)
              for r in reqs[::MOE_CHECKED]]
    ties = [t for c in checks for t in c["ties"]]
    out["loop_vs_single_request"] = {
        "requests": len(checks),
        "positions": sum(c["positions"] for c in checks),
        "min_top2_margin": min(c["min_margin"] for c in checks),
        "equal_requests": sum(not c["ties"] for c in checks),
        "near_ties": ties}
    log(f"check {arch} ServingLoop bf16: every token of {len(checks)} of the "
        f"{len(reqs)} completions (ids {[r.rid for r in reqs[::MOE_CHECKED]]}"
        f", {out['loop_vs_single_request']['positions']} positions) is "
        f"single-request greedy on the card (prompt[:-1] prefilled, then "
        f"decode steps, as the loop splits it) or a near-tie; "
        f"{out['loop_vs_single_request']['equal_requests']} equal outright; "
        f"{len(ties)} near-ties (within {LM_BF16_ULPS} bf16 ulp of the max)")
    checked("loop_vs_single_request_bf16")
    kvp = moe_kernel_vs_plain(sw, moe, TM, cfg, params, _prompt_tokens(
        rng, cfg, *MOE_PREFILL[0]))
    out["kernel_vs_plain"] = kvp
    log(f"check {arch} kernel vs plain attention (bf16 model, prefill "
        f"{MOE_PREFILL[0][0]} x {MOE_PREFILL[0][1]}): each attention layer "
        f"on its own q, k, v max abs err {kvp['attention_max_err']!r}, mean "
        f"err / plain's at most {kvp['mean_ratio_max']!r} (phase 12's rule);"
        f" by MoE layer: flips held {[m['flips_held'] for m in kvp['moe_layers']]}"
        f" (largest plain-run gap "
        f"{[m['flip_gap_ulps_max'] for m in kvp['moe_layers']]} bf16 ulp, "
        f"rule <= {MOE_FLIP_ULPS}), flips after a change "
        f"{[m['flips_after_a_change'] for m in kvp['moe_layers']]}, kept-slot"
        f" changes {[m['kept_slot_changes'] for m in kvp['moe_layers']]}; "
        f"logits of {kvp['rows_held']} of {kvp['rows']} rows (those that saw"
        f" no route change) within {kvp['logit_err_ulps_max']!r} "
        f"bf16 ulp of the row's max (rule <= {MOE_LOGIT_ULPS}; max abs diff "
        f"{kvp['logit_max_abs_diff_held']!r})")
    checked("kernel_vs_plain")
    out["profile"] = {}
    for b, t in MOE_PREFILL:
        out["profile"][f"{b}x{t}"] = pr = profile_prefill(
            prefill_step, params, _prompt_tokens(rng, cfg, b, t), L,
            host_ops=True)
        pr["device_ms"] = _moe_split(pr)
        log(f"profile {arch} prefill {b} x {t}: wall_ms={pr['wall_ms']!r} "
            f"device_busy_ms={pr['device_busy_ms']!r} device_idle_share="
            f"{pr['device_idle_share']!r}; device ms {pr['device_ms']} "
            f"card=\"{card}\"")
    checked("profile")
    log(f"phase moe {arch}: seconds by check {out['check_seconds']}")
    del params
    torch.cuda.empty_cache()
    return out


def d128_times(sw, card, shapes, seed) -> dict:
    """The D = 128 kernel in bf16 at a model's prefill calls (``shapes``:
    (arch, B, S, H, KV), causal, no window): first held against the plain
    version on the same q, k, v by phase 12's rules (``swa_check``, the
    control required) and repeated bitwise; then timed, L2 flushed and
    warm, CUDA events and CUPTI, beside its bound (row 10's formula), the
    plain version's time (one call, events) and SDPA's default call
    (events, the kernels line's ``library_ms``; which backend). Phase 23
    (MOE_TIMES: GQA 64 / 8 and 56 / 8) and phase 24 (VLM_TIMES: 48 / 8)."""
    cyc = sleep_cycles_per_ms()
    flush = l2_flusher()
    rows = {}
    for arch, b, t, h, kv in shapes:
        n_ev, n_cu = ((TIMED_LAUNCHES, CUPTI_CALLS) if b * t <= 4096
                      else (CHUNK, 10))
        q, k, v = swa_inputs(b, t, t, h, kv, 128, torch.bfloat16, seed)
        kern = lambda: sw.swa_attention_cuda(q, k, v)
        lib = sdpa_fn(q, k, v, None)
        got = kern()
        what = f"swa_attention D=128 {arch} ({b}, {t}, {h}/{kv}) bf16"
        if not torch.equal(got, kern()):
            raise AssertionError(f"{what}: repeats differ")
        check = swa_check(sw, q, k, v, got, None, True, what)
        err = float((lib().transpose(1, 2).float() - got.float()).abs()
                    .max())
        bnd = swa_bound(b, t, t, h, kv, 128, None, True)
        rec = {"arch": arch, "shape": [b, t, h, kv, 128], "window": None,
               "dtype": "bfloat16", "check": check,
               "cupti_ms": cupti_ms(kern, flush, SWA_KERNEL, n_cu),
               "warm_l2_cupti_ms": cupti_ms(kern, None, SWA_KERNEL, n_cu),
               "ms": device_ms(kern, cyc, flush, n_ev)[0],
               "warm_l2_ms": device_ms(kern, cyc, None, n_ev)[0],
               "library_ms": device_ms(lib, cyc, flush, n_ev)[0],
               "library_backend": sdpa_backend_of(q, k, v, None),
               "library_vs_kernel_max_abs_diff": err,
               "plain_ms": events_ms(lambda: sw.swa_attention_plain(q, k, v),
                                     1), **bnd}
        rec["share_of_bound"] = bnd["bound_ms"] / rec["ms"]
        rows[f"{arch}/{b}x{t}"] = rec
        log(f"check {what} causal vs plain (phase 12's rule, repeated "
            f"bitwise): max abs err {check['err']!r} (plain fp32 "
            f"{check['plain_err']!r}); mean err / plain's "
            f"{check['mean_err'] / check['plain_mean_err']!r} (rule <= "
            f"{SWA_MEAN_RATIO}); the control (one bf16 p) "
            f"{check['one_bf16_p_mean_err'] / check['plain_mean_err']!r}")
        log(f"time swa_attention D=128 {arch} shape=({b}, {t}, {h}/{kv}, "
            f"128) bf16 causal L2 flushed: kernel_ms={rec['ms']!r} (cupti "
            f"{rec['cupti_ms']!r}; L2-warm {rec['warm_l2_ms']!r}, cupti "
            f"{rec['warm_l2_cupti_ms']!r}) plain_ms={rec['plain_ms']!r} "
            f"bound_ms={bnd['bound_ms']!r} ({bnd['bound_by']}; share reached "
            f"{rec['share_of_bound']!r}) SDPA {rec['library_backend']} "
            f"{rec['library_ms']!r} ms (max |SDPA - kernel| {err!r}) "
            f"card=\"{card}\"")
        del q, k, v, got
        torch.cuda.empty_cache()
    return rows


def moe_phase(sw, _build, TC, TM, launch, card) -> dict:
    """Phase 23 (slice 20): kimi-k2-1t-a32b and arctic-480b served at their
    published widths, MOE_LAYERS layers each (each freed before the next
    is drawn), and the D = 128 kernel's times at their shapes."""
    from repro_torch.models import moe
    t0 = time.perf_counter()
    parts, lap = {}, [t0]

    def done(name):
        parts[name] = time.perf_counter() - lap[0]
        lap[0] = time.perf_counter()

    out = {"models": {}}
    for arch in MOE_ARCHS:
        torch.cuda.reset_peak_memory_stats()
        out["models"][arch] = moe_serving_path(sw, moe, _build, TC, TM,
                                               launch, card, arch)
        out["models"][arch]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        done(arch)
    out["times"] = d128_times(sw, card, MOE_TIMES, SEED + 231)
    done("times")
    out["launches"] = sum(m["launches"] for m in out["models"].values())
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    log(f"phase moe: {out['seconds']!r} s; by part {parts}; peak device "
        f"memory GB {[m['peak_gb'] for m in out['models'].values()]}")
    return out


def moe_alone() -> dict:
    """Phase 23 without the rest of the script (``python3 -c 'import
    chip_smoke as c; c.moe_alone()'``): builds the kernels, then the MoE
    phase."""
    if not torch.cuda.is_available():
        raise SystemExit("moe_alone: no CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import configs as TC
    from repro_torch import launch
    from repro_torch import models as TM
    from repro_torch.kernels import _build
    from repro_torch.kernels import swa_attention as sw
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card {card}")
    _build.load()
    return moe_phase(sw, _build, TC, TM, launch, card)


# --- phase 24: the VLM prefix and qwen2-72b (slice 21) ------------------------

VLM_ARCH = "internvl2-26b"
VLM_LAYERS = 48                       # the published depth
VLM_PARAMS = 19_900_471_296           # the JAX tree's (tests/test_torch_vlm.py)
VLM_F = 256                           # patch-embedding rows a request
# (B, text tokens) after the VLM_F-row prefix: 768 rows a sequence, 8192
# (the profiled call) and 756 (off the kernel's 128-row tile)
VLM_PREFILL = ((8, 512), (1, 7936), (1, 500))
VLM_TIMED = 1                         # timed prefill calls per shape
VLM_DECODE_TOKENS = 16
VLM_CHECKED = 4                       # every 4th decoded row held to B = 1
# the kernel's shapes on the serving path: (arch, B, S, H, KV), S = F + tokens
VLM_TIMES = tuple((VLM_ARCH, b, VLM_F + t, 48, 8) for b, t in VLM_PREFILL)
VLM_TRAIN_LAYERS = 2                  # two agents' Adam state: ~24 B a parameter
VLM_TRAIN_PARAMS = 1_956_673_536      # the 2-layer JAX tree's
VLM_TRAIN_SEQ = 1024                  # rows: the 256-row prefix and 768 tokens
QWEN_ARCH = "qwen2-72b"               # hd_serving_path, HD_LAYERS deep


def vlm_embeds(cfg, b, seed):
    """The stub frontend's patch embeddings: (b, F, d) ~ N(0, 1) in bf16 on
    the card (no ViT, no image)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, cfg.n_frontend_tokens, cfg.d_model), generator=gen,
                       device="cuda").to(torch.bfloat16)


def vlm_serving_path(sw, _build, TC, TM, launch, card) -> dict:
    """internvl2-26b at its published width, VLM_LAYERS deep, seeded bf16
    weights, through the user's entry points: ``make_prefill_step`` with
    ``patch_embeds`` (VLM_F seeded rows a request before the tokens) at
    8 x (256 + 512), 1 x (256 + 7936) and 1 x (256 + 500), then
    ``make_serve_step`` for VLM_DECODE_TOKENS steps at B = 8 from position
    F + S (the step's caches hold F + S slots, as JAX's step sizes them, so
    decoding writes over the oldest, as in JAX). The swa_attention counter
    is set to 0 before this main path and read after it: one launch a layer
    per prefill call, none per decode step, no build. Then every
    VLM_CHECKED-th row of the decode against single-request greedy decoding
    with the same prefix (bf16 near-ties counted as in phases 10, 13, 19)
    and a profiled 1 x 8192 prefill."""
    cfg = tr_config(TC, VLM_ARCH, VLM_LAYERS)
    F, L = cfg.n_frontend_tokens, cfg.n_layers
    if F != VLM_F:
        raise AssertionError(f"{VLM_ARCH}: {F} frontend tokens, expected "
                             f"{VLM_F}")
    rng = np.random.default_rng(SEED + 240)
    t0 = time.perf_counter()
    params = TM.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = TM.count_params(params)
    if n_params != VLM_PARAMS:
        raise AssertionError(f"{VLM_ARCH}: {n_params} parameters, expected "
                             f"{VLM_PARAMS}")
    prefill_step = launch.make_prefill_step(cfg)
    serve_step = launch.make_serve_step(cfg)
    builds = _build.n_builds
    out = {"arch": VLM_ARCH, "params": n_params, "layers": L,
           "frontend_tokens": F, "init_s": init_s,
           "init_peak_gb": init_peak / 1e9, "prefill": {}}

    # --- the main path, counted ---
    sw.launches = 0
    for n, (b, t) in enumerate(VLM_PREFILL):
        batch = {"tokens": _prompt_tokens(rng, cfg, b, t),
                 "patch_embeds": vlm_embeds(cfg, b, SEED + 241 + n)}
        secs = []
        for _ in range(1 + VLM_TIMED):
            before = sw.launches
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, states = prefill_step(params, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            if sw.launches - before != L:
                raise AssertionError(f"{VLM_ARCH} prefill {b}x({F}+{t}): "
                                     f"{sw.launches - before} swa_attention "
                                     f"launches, expected {L}")
        if tuple(logits.shape) != (b, 1, TM.padded_vocab(cfg)) or \
                not bool(torch.isfinite(logits).all()) or \
                states["cache"]["k"].shape[2] != F + t:
            raise AssertionError(f"{VLM_ARCH} prefill {b}x({F}+{t}): bad "
                                 f"logits or caches")
        med = statistics.median(secs[1:])
        out["prefill"][f"{b}x{F + t}"] = {
            "first_s": secs[0], "median_s": med,
            "tokens_per_s": b * (F + t) / med,
            "text_tokens_per_s": b * t / med}
        if b == LM_SLOTS:
            dec_batch, dec_logits, dec_states = batch, logits, states
        del states, logits, batch
    S = dec_batch["tokens"].shape[1]
    tok = dec_logits.argmax(-1)
    decoded = [tok]
    pos = torch.full((LM_SLOTS,), F + S, device="cuda")
    before = sw.launches
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(VLM_DECODE_TOKENS):
        logits, dec_states = serve_step(params, tok, dec_states, pos + i)
        tok = logits.argmax(-1)
        decoded.append(tok)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t1
    launches = sw.launches
    # --- end of the main path ---
    if launches != before or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{VLM_ARCH} decode: {launches - before} "
                             f"swa_attention launches, expected 0")
    if _build.n_builds != builds:
        raise AssertionError(f"an nvcc build ran on the {VLM_ARCH} serving "
                             f"path")
    out["decode"] = {"batch": LM_SLOTS, "steps": VLM_DECODE_TOKENS,
                     "from_position": F + S, "seconds": dec_s,
                     "ms_per_step": dec_s * 1e3 / VLM_DECODE_TOKENS,
                     "tokens_per_s": LM_SLOTS * VLM_DECODE_TOKENS / dec_s}
    out["launches"] = launches
    out["launches_per_prefill_call"], out["launches_per_decode_step"] = L, 0
    del dec_states, dec_logits
    pf = out["prefill"]
    log(f"phase vlm serving: {VLM_ARCH} {n_params} params bf16 ({L} of "
        f"{TC.get_arch(VLM_ARCH).n_layers} layers; {cfg.n_heads} / "
        f"{cfg.n_kv_heads} heads of {cfg.head_dim}; {F} patch-embedding rows "
        f"a request) init {init_s!r} s, peak {out['init_peak_gb']!r} GB; "
        f"prefill rows/s (prefix + tokens) " + ", ".join(
            f"{k}: {v['tokens_per_s']!r}" for k, v in pf.items())
        + f"; decode B={LM_SLOTS} from position {F + S} tokens/s "
        f"{out['decode']['tokens_per_s']!r} ({out['decode']['ms_per_step']!r}"
        f" ms a step); swa_attention launches {launches} ({L} per prefill "
        f"call, 0 per decode step; no build) card=\"{card}\"")

    out["check_seconds"], t_chk = {}, [time.perf_counter()]

    def checked(name):
        now = time.perf_counter()
        out["check_seconds"][name] = now - t_chk[0]
        t_chk[0] = now

    near_tie = lambda best: LM_BF16_ULPS * bf16_ulp(best)
    rows = range(0, LM_SLOTS, VLM_CHECKED)
    toks = dec_batch["tokens"].cpu().numpy()
    checks = [lm_greedy_check(
        TM, cfg, params, launch.Request(r, toks[r], len(decoded)),
        [int(t[r, 0]) for t in decoded], near_tie, cache_len=F + S,
        embeds=dec_batch["patch_embeds"][r:r + 1]) for r in rows]
    ties = [t for c in checks for t in c["ties"]]
    bvs = out["batch_vs_single_request"] = {
        "rows": list(rows), "positions": sum(c["positions"] for c in checks),
        "min_top2_margin": min(c["min_margin"] for c in checks),
        "equal_rows": sum(not c["ties"] for c in checks), "near_ties": ties}
    log(f"check {VLM_ARCH} bf16: every token of rows {list(rows)} of the "
        f"B = {LM_SLOTS} prefill + decode ({bvs['positions']} positions) is "
        f"single-request greedy with the same {F}-row prefix on the card (a "
        f"B = 1 prefill of prefix and prompt, caches of {F + S}, then decode "
        f"steps) or a near-tie; {bvs['equal_rows']} rows equal outright; "
        f"{len(ties)} near-ties (within {LM_BF16_ULPS} bf16 ulp of the max)")
    del dec_batch
    checked("batch_vs_single_request_bf16")
    b, t = VLM_PREFILL[1]
    batch = {"tokens": _prompt_tokens(rng, cfg, b, t),
             "patch_embeds": vlm_embeds(cfg, b, SEED + 244)}
    out["profile"] = pr = profile_prefill(prefill_step, params,
                                          batch["tokens"], L, batch=batch)
    busy = pr["device_busy_ms"]
    pr["device_ms"] = {"matmul": pr["matmul_ms"],
                       "swa_attention": pr["swa_attention_ms"],
                       "rest": busy - pr["matmul_ms"] - pr["swa_attention_ms"]}
    pr["share_of_busy"] = {k: v / busy for k, v in pr["device_ms"].items()}
    log(f"profile {VLM_ARCH} prefill 1 x ({F} + {t}): wall_ms="
        f"{pr['wall_ms']!r} device_busy_ms={busy!r} device_idle_share="
        f"{pr['device_idle_share']!r}; device ms {pr['device_ms']}, share of "
        f"busy {pr['share_of_busy']} card=\"{card}\"")
    checked("profile")
    log(f"phase vlm {VLM_ARCH}: seconds by check {out['check_seconds']}")
    del params, batch
    torch.cuda.empty_cache()
    return out


def vlm_bwd(sw, swb, card) -> dict:
    """The D = 128 backward at the VLM training step's shape, (2, 1024, 48 /
    8), causal, no window: against its plain version by phase 18's rule
    (``bwd_check``, fp32 and bf16; in bf16 the one-bf16 p / ds control
    required), then timed in bf16 (CUPTI and CUDA events, L2 flushed and
    warm) beside its bound, the plain version's time (one call) and SDPA's
    autograd backward on repeated K/V."""
    b, s, h, kv = TR_BATCH, VLM_TRAIN_SEQ, 48, 8
    out = {"shape": [b, s, h, kv, 128], "window": None, "checks": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q, k, v, do = bwd_inputs(b, s, h, kv, 128, dtype, SEED + 245)
        what = f"swa_attention_bwd D=128 ({b}, {s}, {h}/{kv}) {name}"
        row = bwd_check(sw, swb, q, k, v, do, None, what)
        if dtype == torch.bfloat16:
            row["control_mean_ratio"] = bwd_control(sw, swb, q, k, v, do,
                                                    None, row, what)
        out["checks"][name] = row
        del q, k, v, do
    cyc = sleep_cycles_per_ms()
    flush = l2_flusher()
    q, k, v, do = bwd_inputs(b, s, h, kv, 128, torch.bfloat16, SEED + 246)
    o, lse = sw.swa_attention_cuda(q, k, v, with_lse=True)
    kern = lambda: swb.swa_attention_bwd_cuda(q, k, v, o, do, lse)
    lib = sdpa_bwd_fn(q, k, v, do, None)
    out.update({
        "dtype": "bfloat16",
        "cupti_ms": sum(cupti_ms(kern, flush, n) for n in BWD_KERNELS),
        "ms": device_ms(kern, cyc, flush, CHUNK)[0],
        "warm_l2_ms": device_ms(kern, cyc, None, CHUNK)[0],
        "plain_ms": events_ms(lambda: swb.swa_attention_bwd_plain(
            q, k, v, o, do, lse), 1),
        "library_ms": device_ms(lib, cyc, flush, CHUNK)[0],
        "library_backend": sdpa_backend_of(q, k, v, None),
        **bwd_bound(b, s, h, kv, 128, None)})
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    c16 = out["checks"]["bfloat16"]
    out["max_abs_err"] = c16["err"]
    ratio = max(c16[g]["mean_err"] / c16[g]["plain_mean_err"]
                for g in ("dq", "dk", "dv"))
    log(f"check swa_attention_bwd D=128 ({b}, {s}, {h}/{kv}) causal vs plain:"
        f" fp32 err {out['checks']['float32']['err']!r} (G "
        f"{out['checks']['float32']['G']!r}, rule {BWD_REL} x G); bf16 err "
        f"{c16['err']!r}, mean err / plain's {ratio!r} (rule <= "
        f"{BWD_MEAN_RATIO}), the one-bf16 p / ds control "
        f"{c16['control_mean_ratio']!r}; repeats bitwise")
    log(f"time swa_attention_bwd D=128 shape=({b}, {s}, {h}/{kv}, 128) bf16 "
        f"causal L2 flushed: kernel_ms={out['ms']!r} (cupti "
        f"{out['cupti_ms']!r}; L2-warm {out['warm_l2_ms']!r}) plain_ms="
        f"{out['plain_ms']!r} bound_ms={out['bound_ms']!r} ({out['bound_by']};"
        f" share {out['share_of_bound']!r}) library_ms={out['library_ms']!r} "
        f"(SDPA backward, {out['library_backend']} forward choice) "
        f"card=\"{card}\"")
    del q, k, v, do, o, lse, lib
    torch.cuda.empty_cache()
    return out


def vlm_phase(km, sw, swb, wk, _build, TC, TM, launch, card) -> dict:
    """Phase 24 (slice 21): internvl2-26b served at its published width and
    depth with its patch-embedding prefix (``vlm_serving_path``), the D =
    128 kernel at its GQA 48 / 8 prefill shapes (``d128_times``: checked,
    then timed), qwen2-72b at its published width, HD_LAYERS deep
    (``hd_serving_path``: prefill, decode, an 8-slot ``ServingLoop`` and its
    checks), and internvl2-26b trained at its published width,
    VLM_TRAIN_LAYERS deep, on the trainer's stub batch (``train_model_path``:
    the launch formula, rows equal after the sync, kernel vs plain by phase
    20's rule), with its backward checked and timed at its shape
    (``vlm_bwd``). Each model is freed before the next is drawn."""
    t0 = time.perf_counter()
    parts, lap = {}, [t0]

    def done(name):
        parts[name] = time.perf_counter() - lap[0]
        lap[0] = time.perf_counter()

    out = {}
    torch.cuda.reset_peak_memory_stats()
    out["serving"] = vlm_serving_path(sw, _build, TC, TM, launch, card)
    out["serving"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    done("serving")
    out["times"] = d128_times(sw, card, VLM_TIMES, SEED + 247)
    done("times")
    torch.cuda.reset_peak_memory_stats()
    out["qwen"] = hd_serving_path(sw, _build, TC, TM, launch, card, QWEN_ARCH)
    out["qwen"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    done(QWEN_ARCH)
    tr = train_model_path(km, sw, swb, wk, TC, TM, launch, card, VLM_ARCH,
                          VLM_TRAIN_LAYERS, seq=VLM_TRAIN_SEQ)
    if tr["params_per_agent"] != VLM_TRAIN_PARAMS:
        raise AssertionError(f"{tr['arch']}: {tr['params_per_agent']} "
                             f"parameters an agent, expected "
                             f"{VLM_TRAIN_PARAMS}")
    out["train"] = tr
    done("train")
    out["bwd"] = vlm_bwd(sw, swb, card)
    done("bwd")
    out["launches"] = dict(tr["launches"])
    out["launches"]["swa_attention"] += (out["serving"]["launches"]
                                         + out["qwen"]["launches"])
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    log(f"phase vlm: {out['seconds']!r} s; by part {parts}; peak device "
        f"memory GB: serving {out['serving']['peak_gb']!r}, {QWEN_ARCH} "
        f"{out['qwen']['peak_gb']!r}, training (a period) "
        f"{tr['peak_memory_bytes'] / 1e9!r}")
    return out


def vlm_alone() -> dict:
    """Phase 24 without the rest of the script (``python3 -c 'import
    chip_smoke as c; c.vlm_alone()'``): builds the kernels, then the VLM
    phase."""
    if not torch.cuda.is_available():
        raise SystemExit("vlm_alone: no CUDA card")
    TC, launch, TM, _build, sw, swb, wk = _alone_modules()
    km, _, _, _ = _sweep_modules()
    card = card_line()
    log(f"card {card}")
    _build.load()
    return vlm_phase(km, sw, swb, wk, _build, TC, TM, launch, card)


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
    from repro_torch.kernels import swa_attention_bwd as swb
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
    log(f"phase build: {build_s!r} s, {_build.build_info.get('sources')} -> "
        f"{_build.build_info['library']} (nvcc runs: {_build.n_builds}; "
        f"flags {_build.build_info.get('flags')})")
    for line in str(_build.build_info.get("log", "")).splitlines():
        if ("ptxas info" in line and "Used" in line) or "(C75" in line or (
                "spill" in line and " 0 bytes spill stores" not in line):
            log(f"phase build: {line.strip()}")
    n_hgmma = hgmma_counts(_build, (SWA_KERNEL, WH_KERNEL_SASS) + BWD_KERNELS
                           + BWD256_KERNELS)
    log(f"phase build: HGMMA instructions by kernel (cuobjdump -sass): "
        f"{n_hgmma}")
    if not all(n_hgmma.values()):
        raise AssertionError(f"a bf16 attention kernel issues no wgmma: "
                             f"{n_hgmma}")
    lap("1-2 device_and_build")

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

    # the CPU references of phases 7 / 7b start here, beside the card
    pool, refs = cpu_references((training_plan(), consensus_plan()))
    try:
        # 6. flat kernels vs plain
        flat = flat_kernels_vs_plain(dacc, fu, dispatch)
        lap('6 flat_kernel_vs_plain')

        # 6b. gossip and compression kernels vs plain
        gossip = gossip_kernels_vs_plain(km, core, comm)
        lap('6b gossip_kernel_vs_plain')

        # 7. the training path (slice 2)
        training = training_path(km, _build, rl, core, optim, comm, serve,
                                 card, refs)
        lap('7 training')

        # 7b. the consensus and compression path (slice 3)
        consensus = consensus_path(km, _build, rl, core, optim, comm, card,
                                   refs)
        lap('7b consensus')
    finally:
        pool.shutdown(cancel_futures=True)

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

    # 16. the async path (slice 11): the masked server step, async runs and
    # the delay / k axes on the card
    async_run = async_path(km, rl, core, sweep, card)
    lap('16 async')

    # 17. the task-generic FMARL driver (slice 12): the quickstart's
    # strategies and the full-width runs card vs CPU, the hierarchical step
    fmarl = fmarl_path(km, rl, core, optim, comm, dispatch, card)
    lap('17 fmarl')

    # 18. federated LM training (slice 13): the backward kernel and lse vs
    # plain, the full-width trainer on every strategy, the windowed step,
    # the mid config card vs CPU, times and a profiled window
    lmt = lm_train_phase(km, sw, swb, TC, TM, launch, card)
    lap('18 lm_train')

    # 19. head-256 serving (slice 15): the D = 256 kernel vs plain,
    # gemma-7b and recurrentgemma-9b at full width (7 / 14 layers),
    # phi4-mini-3.8b
    hd = head256_phase(sw, _build, TC, TM, launch, card)
    lap('19 head256')

    # 20. LM training for every family (slice 16): the D = 256 backward and
    # wkv6_bwd vs plain, gemma-7b, recurrentgemma-9b and rwkv6-1.6b trained
    # at their published width, the kernels' times
    tr = train_phase(km, sw, swb, wk, TC, TM, launch, card)
    lap('20 train')

    # 21. whisper-small serving (slice 18): the D = 64 kernel vs plain, the
    # encoder-decoder at full size through the serve steps, its times
    wh = whisper_phase(sw, _build, TC, TM, launch, card)
    lap('21 whisper')

    # 22. whisper-small training (slice 19): the D = 64 backward vs plain,
    # whisper-small and the lm-100m example trained at full size, times
    wt = whisper_train_phase(km, sw, swb, wk, _build, TC, TM, launch, card)
    lap('22 whisper_train')

    # 23. MoE serving (slice 20): kimi-k2-1t-a32b and arctic-480b at their
    # published widths, 2 layers each, through the D = 128 kernel
    mo = moe_phase(sw, _build, TC, TM, launch, card)
    lap('23 moe')

    # 24. the VLM prefix (slice 21): internvl2-26b served at its published
    # width and depth and trained at 2 layers, qwen2-72b served at 4 of 80
    # layers, the D = 128 forward and backward at GQA 48 / 8
    vl = vlm_phase(km, sw, swb, wk, _build, TC, TM, launch, card)
    lap('24 vlm')

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
    r = lmt["times"][f"swa_attention_bwd/{LMT_BATCH}x{LMT_SEQ}"]
    timed = [c for c in lmt["bwd_parity"]["cases"]
             if c["shape"] == [LMT_BATCH, LMT_SEQ, 32, 8, 120]
             and c["dtype"] == "bfloat16"][0]
    kernels.append({
        "name": "swa_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/swa_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:224",
        "launches": lmt["main"]["launches"]["swa_attention_bwd"],
        "max_abs_err": timed["err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "library": "autograd backward of scaled_dot_product_attention "
                   "(repeated K/V)",
        "shape": {"B": LMT_BATCH, "S": LMT_SEQ, "H": 32, "KV": 8, "D": 120,
                  "window": 4096, "dtype": "bfloat16"},
        "replaces_note": "_flash_bwd, the jnp backward of the JAX model's "
                         "flash_attention (no Pallas kernel)",
        "design": "bf16 (timed): swa_bwd_dq_hopper_kernel (128 query "
                  "rows a block, a consumer warpgroup per 64) then "
                  "swa_bwd_dkdv_hopper_kernel (64 keys a block, its two "
                  "consumer warpgroups take the streamed q tiles in turn "
                  "and add their sums in a fixed order); wgmma on 64-row "
                  "tiles a TMA producer streams through a 4-slot ring; p "
                  "and ds as bf16 hi + lo. fp32: the CUDA-core "
                  "swa_bwd_dq_kernel and swa_bwd_dkdv_kernel",
        "max_abs_err_all_cases": lmt["bwd_parity"]["worst"],
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
        if k["name"] in ("decay_accum", "row_mean"):
            k["async"] = {"launches": async_run["launches"][k["name"]]}
        # the main path's launches: the training path's and phase 17's
        k["fmarl"] = {"launches": fmarl["launches"][k["name"]]}
        k["launches"] += fmarl["launches"][k["name"]]
    for k in kernels:                  # and phase 18's (LM training)
        if k["name"] in LMT_KERNELS and k["name"] != "swa_attention_bwd":
            k["lm_train"] = {"launches": lmt["main"]["launches"][k["name"]]}
            k["launches"] += lmt["main"]["launches"][k["name"]]
        if k["name"] == "swa_attention":   # and phase 19's (head 256)
            r = hd["times"]["recurrentgemma-9b/1x8192"]
            k["head256"] = {
                "launches": hd["launches"],
                "launches_by_model": {
                    **{a: m["launches"] for a, m in hd["models"].items()},
                    PHI4_ARCH: hd["phi4"]["launches"]},
                "max_abs_err": hd["parity"]["worst"],
                "shape": {"B": 1, "S": 8192, "H": 16, "KV": 1, "D": 256,
                          "window": 2048, "dtype": "bfloat16"},
                **{key: r[key] for key in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms",
                                           "library_backend")},
                "times": {n: {key: t[key] for key in (
                    "ms", "cupti_ms", "warm_l2_ms", "plain_ms", "bound_ms",
                    "library_ms", "library_backend", "fp32_ms")
                    if key in t} for n, t in hd["times"].items()}}
            k["launches"] += hd["launches"]
    for k in kernels:                  # and phase 21's (whisper-small)
        if k["name"] == "swa_attention":
            r = wh["times"]["encoder"]
            k["whisper"] = {
                "launches": wh["launches"],
                "launches_per_prefill_call": WH_PER_PREFILL,
                "launches_per_decode_step": WH_PER_STEP,
                "max_abs_err": wh["parity"]["worst"],
                "mean_ratio_max": wh["parity"]["mean_ratio_max"],
                "control_ratio_min": wh["parity"]["control_ratio_min"],
                "hgmma_d64": n_hgmma[WH_KERNEL_SASS],
                "shape": {"B": 8, "Sq": WH_FRAMES, "Sk": WH_FRAMES, "H": 12,
                          "KV": 12, "D": 64, "causal": False,
                          "dtype": "bfloat16"},
                **{key: r[key] for key in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms",
                                           "library_backend")},
                "times": {n: {key: t[key] for key in (
                    "ms", "cupti_ms", "warm_l2_ms", "warm_l2_cupti_ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "library_backend") if key in t}
                    for n, t in wh["times"].items()}}
            k["launches"] += wh["launches"]
    for k in kernels:                  # and phase 20's (every family trains)
        if k["name"] in TR_KERNELS:
            k["train"] = {"launches": tr["launches"][k["name"]]}
            k["launches"] += tr["launches"][k["name"]]
        if k["name"] == "swa_attention_bwd":
            k["d256"] = {
                "max_abs_err": tr["bwd256_parity"]["worst"],
                "mean_ratio_max": tr["bwd256_parity"]["mean_ratio_max"],
                "control_ratio_min": tr["bwd256_parity"]["control_ratio_min"],
                "design": "bf16: swa_bwd_dq_hopper_d256_kernel (64 query "
                          "rows a block, its two consumer warpgroups take "
                          "the streamed k / v tiles in turn, fixed-order "
                          "sum) then swa_bwd_dkdv_hopper_d256_kernel (64 "
                          "keys a block, one warpgroup accumulates dv, the "
                          "other dk); a 2-slot TMA ring; fp32: the CUDA-core "
                          "kernels staging one streamed tile at a time",
                "times": {n: {key: t[key] for key in (
                    "ms", "cupti_ms", "warm_l2_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "library_backend")}
                    for n, t in tr["times"].items()
                    if n.startswith("swa_attention_bwd_d256/")}}
    r = tr["times"]["wkv6_bwd"]
    kernels.append({
        "name": "wkv6_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6_bwd.cu",
        "replaces": "src/repro/models/rwkv6.py:64",
        "launches": tr["launches"]["wkv6_bwd"],
        "max_abs_err": max(c[g]["err"] for c in tr["wkv6_bwd_parity"]["cases"]
                           for g in ("dr", "dk", "dv", "dw", "du", "ds0")),
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": None,
        "cupti_ms": r["cupti_ms"],
        "replaces_note": "autograd through wkv_scan's lax.scan (no Pallas "
                         "backward)",
        "shape": {"B": TR_BATCH, "T": TR_SEQ, "H": 32, "D": 64,
                  "dtype": "float32"},
        "max_rel_err": tr["wkv6_bwd_parity"]["worst_rel"],
    })
    for k in kernels:                  # and phase 22's (whisper-small, lm-100m)
        if k["name"] in TR_KERNELS:
            k["whisper_train"] = {"launches": wt["launches"][k["name"]]}
            k["launches"] += wt["launches"][k["name"]]
        if k["name"] == "swa_attention_bwd":
            k["d64"] = {
                "max_abs_err": wt["bwd64_parity"]["worst"],
                "mean_ratio_max": wt["bwd64_parity"]["mean_ratio_max"],
                "control_ratio_min": wt["bwd64_parity"]["control_ratio_min"],
                "lse_rel_err_max": wt["bwd64_parity"]["lse_rel_err_max"],
                "launches": wt["launches"]["swa_attention_bwd"],
                "design": "bf16: the D <= 128 kernels at one 64-column box: "
                          "4 k-steps a score product, m64n64k16 wgmmas into "
                          "32-register dq / dk / dv accumulators; fp32: one "
                          "column group",
                "times": {n: {key: t[key] for key in (
                    "ms", "cupti_ms", "warm_l2_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "library_backend")}
                    for n, t in wt["times"].items()}}
    for k in kernels:                  # and phase 23's (MoE serving)
        if k["name"] == "swa_attention":
            k["moe"] = {
                "launches": mo["launches"],
                "launches_by_model": {a: m["launches"]
                                      for a, m in mo["models"].items()},
                "launches_per_prefill_call": MOE_LAYERS,
                "launches_per_decode_step": 0,
                "times": {n: {**{key: t[key] for key in (
                    "ms", "cupti_ms", "warm_l2_ms", "warm_l2_cupti_ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "library_backend")}, "max_abs_err": t["check"]["err"]}
                    for n, t in mo["times"].items()}}
            k["launches"] += mo["launches"]
    for k in kernels:                  # and phase 24's (VLM, qwen2-72b)
        if k["name"] not in vl["launches"]:
            continue
        k["vlm"] = {"launches": vl["launches"][k["name"]]}
        k["launches"] += vl["launches"][k["name"]]
        pick = lambda t: {key: t[key] for key in (
            "ms", "cupti_ms", "warm_l2_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_backend") if key in t}
        if k["name"] == "swa_attention":
            k["vlm"].update({
                "launches_by_path": {
                    "serving": vl["serving"]["launches"],
                    QWEN_ARCH: vl["qwen"]["launches"],
                    "train": vl["train"]["launches"]["swa_attention"]},
                "launches_per_prefill_call": VLM_LAYERS,
                "launches_per_decode_step": 0,
                "times": {n: {**pick(t), "max_abs_err": t["check"]["err"]}
                          for n, t in vl["times"].items()}})
        if k["name"] == "swa_attention_bwd":
            k["vlm"].update({
                "shape": {"B": TR_BATCH, "S": VLM_TRAIN_SEQ, "H": 48, "KV": 8,
                          "D": 128, "window": None, "dtype": "bfloat16"},
                "max_abs_err": vl["bwd"]["max_abs_err"],
                "fp32_max_abs_err": vl["bwd"]["checks"]["float32"]["err"],
                "control_mean_ratio":
                    vl["bwd"]["checks"]["bfloat16"]["control_mean_ratio"],
                **pick(vl["bwd"])})
    if len(kernels) != 12 or any(k["launches"] < 1 for k in kernels):
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
                   "sweep_times": sweep_rows, "async": async_run,
                   "fmarl": fmarl, "lm_train": lmt, "head256": hd,
                   "train": tr, "whisper": wh, "whisper_train": wt,
                   "moe": mo, "vlm": vl,
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
