"""The port's kernels on the card (marker ``cuda``; skipped without one).

This file imports no JAX, so it runs on a machine that has PyTorch for CUDA
and ``nvcc`` but no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the card, and the
serving engine on the card against the engine on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import policy_infer as pinf
from repro_torch.rl.policy import init_policy
from repro_torch.serve import MicroBatchQueue, ObsNorm, ServeEngine, simulate_clients

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dims, batch, seed, device):
    obs_dim, hidden, act_dim = dims
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32),
                                device=device)
    pi = {"w1": f(obs_dim, hidden) / obs_dim ** 0.5, "b1": 0.1 * f(hidden),
          "w2": f(hidden, hidden) / hidden ** 0.5, "b2": 0.1 * f(hidden),
          "w3": f(hidden, act_dim) / hidden ** 0.5, "b3": 0.1 * f(act_dim),
          "log_std": 0.3 * f(act_dim)}
    nm = 0.5 * f(obs_dim)
    ns = torch.tensor(rng.uniform(0.5, 2.0, obs_dim).astype(np.float32),
                      device=device)
    return pi, nm, ns, f(batch, obs_dim), f(batch, act_dim)


@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("batch", [1, 37, 1024])
@pytest.mark.parametrize("dims", [(6, 64, 1), (6, 16, 2), (11, 128, 3)])
def test_policy_infer_kernel_matches_plain(card, dims, batch, sample):
    """fp32 at variance-preserving scales: sums of <= 128 terms of size ~1,
    taken in another order (FMA chains vs cuBLAS) — atol 2e-6."""
    pi, nm, ns, obs, noise = _case(dims, batch, batch + len(dims), card)
    want = pinf.policy_infer_plain(obs, pi, nm, ns, noise, sample=sample)
    before = pinf.launches
    got = pinf.policy_infer_cuda(obs, pi, nm, ns, noise, sample=sample,
                                 out=noise)
    torch.cuda.synchronize()
    assert pinf.launches == before + 1
    assert got.data_ptr() == noise.data_ptr()
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


def test_policy_infer_kernel_refuses_what_it_does_not_take(card):
    pi, nm, ns, obs, noise = _case((6, 16, 2), 4, 0, card)
    with pytest.raises(TypeError):
        pinf.policy_infer_cuda(obs.double(), pi, nm, ns, noise)
    with pytest.raises(ValueError, match="contiguous"):
        pinf.policy_infer_cuda(obs, {**pi, "w2": pi["w2"].t().contiguous().t()},
                               nm, ns, noise)
    big = _case((6, pinf.MAX_HIDDEN + 1, 1), 4, 0, card)
    with pytest.raises(ValueError, match="hidden"):
        pinf.policy_infer_cuda(big[3], big[0], big[1], big[2], big[4])


@pytest.mark.parametrize("mode", ["mean", "sample"])
def test_engine_on_the_card_matches_the_cpu_engine(card, mode):
    params = init_policy(6, 64, 1, generator=torch.Generator().manual_seed(0),
                         device="cuda")
    norm = ObsNorm(np.linspace(-0.5, 0.5, 6).astype(np.float32),
                   np.full(6, 1.25, np.float32))
    gpu = ServeEngine(params, norm=norm, mode=mode, seed=3, device="cuda")
    cpu = ServeEngine(params, norm=norm, mode=mode, seed=3, device="cpu")
    q = MicroBatchQueue(max_batch=gpu.max_batch(), obs_dim=6)
    q.push_all(simulate_clients(2000, 1.0, 1.0, obs_dim=6, seed=5))
    before = pinf.launches
    n = 0
    while (nxt := q.next_batch()) is not None:
        obs, _ = nxt
        np.testing.assert_allclose(gpu.decide(obs), cpu.decide(obs), atol=2e-6,
                                   rtol=0)
        n += 1
    assert pinf.launches - before == n == sum(gpu.bucket_calls.values())
    assert gpu.n_builds == 1
