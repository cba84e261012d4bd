"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) into an object file,
one ``nvcc`` process per source, all started together; the objects are then
linked into one shared library with a plain C interface under
``build/repro_torch/`` at the repository root. The library's name carries a
hash of the sources and flags, so a changed source rebuilds and an unchanged
one is loaded as it is. The build happens at first use (:func:`load`), never
at import, and uses only the sources in the repository.

There is no fallback: a missing or failing ``nvcc`` raises with the
compiler's own output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# No --use_fast_math: it would turn '/' and tanhf into approximations. nvcc's
# default --fmad=true stays on (a*b+c contracts to one FMA).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

n_builds = 0          # nvcc builds run by this process
build_info: Dict[str, object] = {}
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.repro_policy_infer.argtypes = [
        _P, _P, _P,                      # obs, noise, out
        _P, _P,                          # norm_mean, norm_std
        _P, _P, _P, _P, _P, _P, _P,      # w1, b1, w2, b2, w3, b3, log_std
        ctypes.c_int64,                  # batch
        _I, _I, _I,                      # obs_dim, hidden, act_dim
        _I, _I, _I,                      # sample, obs_dtype, noise_dtype
        _I,                              # device
        _P,                              # stream
    ]
    lib.repro_policy_infer.restype = _I
    _L, _F = ctypes.c_int64, ctypes.c_float
    lib.repro_decay_accum.argtypes = [
        _P, _P, _P,                      # acc, g, out
        _P, _L, _F,                      # d, d_stride, d_value
        _L, _L, _I, _I,                  # m, n, dtype, device
        _P,                              # stream
    ]
    lib.repro_decay_accum.restype = _I
    lib.repro_row_mean.argtypes = [_P, _P, _L, _L, _L, _I, _P]  # runs, m, n
    lib.repro_row_mean.restype = _I
    lib.repro_momentum_update.argtypes = [
        _P, _P, _P,                      # p, g, mu
        _P, _P,                          # p_out, mu_out
        _P, _L, _F,                      # w, w_stride, w_value
        _P, _L,                          # lr_runs, run_rows
        _F, _F, _I,                      # lr, beta, nesterov
        _L, _L, _I, _I,                  # m, n, dtype, device
        _P,                              # stream
    ]
    lib.repro_momentum_update.restype = _I
    lib.repro_adam_update.argtypes = [
        _P, _P, _P, _P,                  # p, g, mu, nu
        _P, _P, _P,                      # p_out, mu_out, nu_out
        _P, _L, _F,                      # w, w_stride, w_value
        _P, _L,                          # lr_runs, run_rows
        _F, _F, _F, _F, _F,              # lr, b1, 1 - b1, b2, 1 - b2
        _F, _F, _F, _F,                  # eps, wd, bc1, bc2
        _L, _L, _I, _I,                  # m, n, dtype, device
        _P,                              # stream
    ]
    lib.repro_adam_update.restype = _I
    lib.repro_consensus_step.argtypes = [
        _P, _P, _P,                      # P, G, out
        _L, _L, _L, _L, _I,              # runs, m, n, p_stride, dtype
        _P,                              # stream
    ]
    lib.repro_consensus_step.restype = _I
    lib.repro_consensus_gather.argtypes = [
        _P, _P, _P, _P,                  # g, idx, w, out
        _L, _L, _I, _I,                  # m, n, k_max, dtype
        _I, _I, _I, _I,                  # rows, blocks, ring_bytes, device
        _P,                              # stream
    ]
    lib.repro_consensus_gather.restype = _I
    lib.repro_topk_scatter.argtypes = [
        _P, _P, _P, _P,                  # x, t, ssum, residual
        _L, _L, _L, _I,                  # runs, m, n, dtype
        _P,                              # stream
    ]
    lib.repro_topk_scatter.restype = _I
    lib.repro_wkv6.argtypes = [
        _P, _P, _P, _P, _P, _P,          # r, k, v, w, u, s0
        _P, _P,                          # y, sT
        _L, _L, _L, _L,                  # B, T, H, D
        _P,                              # stream
    ]
    lib.repro_wkv6.restype = _I
    lib.repro_wkv6_bwd.argtypes = [
        _P, _P, _P, _P, _P, _P,          # r, k, v, w, u, s0
        _P, _P,                          # dy, dsT (may be null)
        _P, _P, _P,                      # sck, gck, du_part (scratch)
        _P, _P, _P, _P, _P, _P,          # dr, dk, dv, dw, du, ds0
        _L, _L, _L, _L,                  # B, T, H, D
        _P,                              # stream
    ]
    lib.repro_wkv6_bwd.restype = _I
    lib.repro_swa_attention.argtypes = [
        _P, _P, _P, _P, _P,              # q, k, v, o, lse (may be null)
        _L, _L, _L, _L, _L, _L,          # B, Sq, Sk, H, KV, D
        _L, _I, _F,                      # window, causal, scale
        _I,                              # dtype
        _P,                              # stream
    ]
    lib.repro_swa_attention.restype = _I
    lib.repro_swa_attention_bwd.argtypes = [
        _P, _P, _P, _P, _P,              # q, k, v, o, do
        _P, _P,                          # lse, delta (scratch)
        _P, _P, _P,                      # dq, dk, dv
        _L, _L, _L, _L, _L, _L,          # B, Sq, Sk, H, KV, D
        _L, _I, _F,                      # window, causal, scale
        _I,                              # dtype
        _P,                              # stream
    ]
    lib.repro_swa_attention_bwd.restype = _I
    lib.repro_cuda_error_string.argtypes = [_I]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "repro_torch: nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Start every command at once, wait for all; raise on any failure."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for c in cmds
    ]
    logs, failed = [], []
    for cmd, p in zip(cmds, procs):
        out, err = p.communicate()
        logs.append(out + err)
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}{err}")
    if failed:
        raise RuntimeError("repro_torch: nvcc failed:\n" + "\n".join(failed))
    return logs


def load() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library, once per
    process."""
    global _lib, n_builds
    if _lib is not None:
        return _lib
    srcs = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"librepro_torch_kernels_{_digest(srcs)}.so"
    if not lib_path.exists():
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [Path(tmp) / f"{s.stem}.o" for s in srcs]
            logs = _run_all([
                [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                for s, o in zip(srcs, objs)
            ])
            tmp_lib = Path(tmp) / lib_path.name
            logs += _run_all([
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                 *map(str, objs), "-o", str(tmp_lib)]
            ])
            os.replace(tmp_lib, lib_path)    # atomic against a racing build
        n_builds += 1
        build_info.update(
            nvcc=nvcc, flags=" ".join(NVCC_FLAGS),
            seconds=time.perf_counter() - t0,
            sources=[s.name for s in srcs], log="".join(logs),
        )
    build_info["library"] = str(lib_path)
    _lib = _declare(ctypes.CDLL(str(lib_path)))
    return _lib
