#!/usr/bin/env python3
"""Drive the PyTorch port's policy-serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the repository root on a machine with a CUDA card, PyTorch built
for CUDA and ``nvcc``; it imports ``repro_torch`` from ``src/`` and nothing of
JAX or the JAX package. Phases, each of which fails the run when it fails:

1. device — the card, its power limit, torch / CUDA / nvcc versions; TF32
   off for the plain reference's fp32 matmuls;
2. build — every kernel of ``src/repro_torch/kernels/csrc`` with ``nvcc``;
3. kernel vs plain — the hand-written ``policy_infer`` kernel against its
   plain PyTorch version on the card, over widths, batch sizes, modes, init
   scales and dtypes, and the in-place write into the noise buffer;
4. serving — a seeded 6-64-1 policy through ``save_for_serving`` ->
   ``ServeEngine.from_checkpoint(device="cuda")`` -> ``MicroBatchQueue`` ->
   ``ServeEngine.decide``: full-fleet backlogs at m in {64, 1024, 10000}
   (decisions/sec) and an open-loop Poisson schedule at half that rate on a
   virtual clock (p50/p99 ms), in both modes; every decision is checked
   against a ``device="cpu"`` engine replaying the same batches with the
   same seed; the kernel's launches must equal the engine calls, with no
   build and no device allocation on the hot path;
5. times — per bucket, the kernel's and the plain version's device time
   (median of per-launch CUDA-event times) beside the card's bound.

Its last lines are the kernel summary JSON, the card's name and power limit,
and ``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result. Details go to ``build/chip_smoke/result.json``.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

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
# Published H100 SXM peaks at 700 W (NVIDIA data sheet): HBM3 rate and fp32
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
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
    log(f"phase kernel_vs_plain: {n_cases} cases ok; max |kernel - plain| "
        f"fp32 {worst['float32']!r}, bf16 {worst['bfloat16']!r}; fp32 plain vs "
        f"fp64 up to {worst['plain_fp32_vs_fp64']!r}; tolerance vs fp64: "
        f"max({ATOL_F32}, 2x fp32 plain's error) (+ 2^-7 |ref| in bf16)")
    return {"cases": n_cases, "max_abs_err": worst}


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


def device_ms(fn, cycles_per_ms: float) -> tuple:
    """Median device time of one call, from per-call CUDA events.

    The calls are enqueued in chunks of CHUNK behind a spin kernel that holds
    the stream until the host has enqueued the whole chunk (a chunk stays
    well inside the card's queue of pending work), so host launch gaps do not
    enter the times. Also returns the idle gap between two calls of a
    chunk (median over the chunks' calls).
    """
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CHUNK):
        fn()
    torch.cuda.synchronize()
    hold_ms = 2.0 * (time.perf_counter() - t0) * 1e3 + 1.0
    times, gaps = [], []
    for _ in range(TIMED_LAUNCHES // CHUNK):
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(CHUNK)]
        torch.cuda._sleep(int(cycles_per_ms * hold_ms))
        for s, e in ev:
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
    for mode in ("mean", "sample"):
        sample = mode == "sample"
        calls = serving["modes"][mode]["bucket_calls"]
        for b in (8, 64, 256, 1024):
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
            b_ms, b_by, flops, nbytes = bound(b, sample)
            rows[f"{mode}/{b}"] = {
                "bucket": b, "mode": mode, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
                "bytes": nbytes, "launches_on_path": calls[str(b)],
                "idle_gap_ms": gap,
            }
            log(f"time policy_infer mode={mode} bucket={b} kernel_ms={ms!r} "
                f"plain_ms={plain_ms!r} bound_ms={b_ms!r} ({b_by}) "
                f"launches_on_path={calls[str(b)]} idle_gap_ms={gap!r} "
                f"card=\"{card}\"")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import serve
    from repro_torch.kernels import _build
    from repro_torch.kernels import policy_infer as pinf
    from repro_torch.rl import policy

    t_start = time.perf_counter()
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
        if "ptxas info" in line and ("Used" in line or "spill" in line):
            log(f"phase build: {line.strip()}")

    # 3. kernel vs plain
    parity = kernel_vs_plain(pinf)

    # 4. the serving path
    serving = serving_path(pinf, _build, serve, policy, card)

    # 5. times
    rows = times(pinf, serving, card)
    prof = profile_serving(serve, card)

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
    with open(os.path.join(ROOT, "build", "chip_smoke", "result.json"),
              "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "nvcc": nvcc_ver,
                   "build_seconds": build_s, "build": _build.build_info,
                   "parity": parity, "serving": serving, "times": rows,
                   "profile": prof,
                   "kernels": kernels,
                   "seconds": time.perf_counter() - t_start}, f, indent=1,
                  default=str)
    log(f"chip_smoke: all phases ok in {time.perf_counter() - t_start!r} s")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
