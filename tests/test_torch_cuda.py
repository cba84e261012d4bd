"""The port's kernels on the card (marker ``cuda``; skipped without one).

This file imports no JAX, so it runs on a machine that has PyTorch for CUDA
and ``nvcc`` but no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the card, the
serving engine on the card against the engine on the CPU, a short training
run on the card against the same run (same draws) on the CPU, and the
reduced RWKV6 and sliding-window attention language models on the card
against the port on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch import comm
from repro_torch import configs as TC
from repro_torch import models as TM
from repro_torch.core import (
    exponential_decay,
    knn_ring,
    make_strategy,
    mixing_matrix,
    neighbor_list,
    neighbor_weights,
    neighbor_weights_from_matrix,
    random_regularish,
    uniform_taus,
)
from repro_torch.kernels import consensus_gather as cg
from repro_torch.kernels import consensus_step as cs
from repro_torch.kernels import decay_accum as dacc
from repro_torch.kernels import dispatch
from repro_torch.kernels import flat_update as fu
from repro_torch.kernels import policy_infer as pinf
from repro_torch.kernels import swa_attention as sw
from repro_torch.kernels import topk_scatter as tks
from repro_torch.kernels import wkv6 as wk
from repro_torch.launch import Request, ServingLoop
from repro_torch.optim import flat_adam, flat_momentum
from repro_torch.rl import FIGURE_EIGHT, FedRLConfig, TorchDraws, replay_of, run_fedrl
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


def _at_offset_all(tensors, offset):
    return {k: _at_offset(v, offset) for k, v in tensors.items()}


# Every serving bucket and one row either side: one row a warp, 8 a block.
@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("batch", [7, 8, 9, 63, 64, 65, 255, 256, 257, 1023,
                                   1024, 1025])
def test_policy_infer_kernel_at_the_bucket_edges(card, batch, sample):
    pi, nm, ns, obs, noise = _case((6, 64, 1), batch, batch, card)
    want = pinf.policy_infer_plain(obs, pi, nm, ns, noise, sample=sample)
    got = pinf.policy_infer_cuda(obs, pi, nm, ns, noise, sample=sample)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


# The kernel stages each tensor at its own phase (4-byte copies for a
# misaligned head and tail, 16-byte ones for the body), which changes no
# arithmetic: views at element offsets 1-3 give the aligned run's bits.
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("dims", [(6, 64, 1), (128, 128, 32), (5, 33, 2)])
def test_policy_infer_kernel_takes_unaligned_views_bitwise(card, dims, offset):
    pi, nm, ns, obs, noise = _case(dims, 65, offset, card)
    want = pinf.policy_infer_cuda(obs, pi, nm, ns, noise, sample=True)
    got = pinf.policy_infer_cuda(
        _at_offset(obs, offset), _at_offset_all(pi, offset),
        _at_offset(nm, offset), _at_offset(ns, offset),
        _at_offset(noise, offset), sample=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    torch.testing.assert_close(
        got, pinf.policy_infer_plain(obs, pi, nm, ns, noise, sample=True),
        atol=2e-6, rtol=0)


# At the kernel's limits, bf16 actions written into the bf16 noise buffer:
# within one bf16 rounding (2^-7 relative) of the plain version.
@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("batch", [1, 64, 1024])
def test_policy_infer_kernel_at_its_limits_in_place_bf16(card, batch, sample):
    dims = (pinf.MAX_OBS_DIM, pinf.MAX_HIDDEN, pinf.MAX_ACT_DIM)
    pi, nm, ns, obs, noise = _case(dims, batch, 7, card)
    obs, noise = obs.bfloat16(), noise.bfloat16()
    want = pinf.policy_infer_plain(obs, pi, nm, ns, noise, sample=sample)
    got = pinf.policy_infer_cuda(obs, pi, nm, ns, noise, sample=sample,
                                 out=noise)
    torch.cuda.synchronize()
    assert got.data_ptr() == noise.data_ptr() and got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    assert bool((err <= 2e-6 + 2.0 ** -7 * want.float().abs()).all()), \
        err.max().item()


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


# --- the flat-carry kernels -------------------------------------------------------
#
# The kernels spell every operation with the IEEE round-to-nearest intrinsics,
# in the plain versions' order, so on fp32 / bf16 / fp16 buffers they agree
# with the plain versions on the card to the last bit except where torch's
# own CUDA ops round differently; the tolerance allows 2 ulp of the result's
# dtype (decay_accum: bitwise). row_mean sums in another order than torch: within 1e-6 of the mean
# absolute value of its column.

_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _buf(shape, dtype, seed, card):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(card, dtype)


def _ulps(dtype):
    return 2 * torch.finfo(dtype).eps


def _at_offset(t, offset):
    """A contiguous copy of ``t`` that starts ``offset`` elements into a
    larger allocation (a view whose address is not 16-byte aligned when the
    offset is not a multiple of 16 bytes)."""
    big = torch.zeros(t.numel() + 8, dtype=t.dtype, device=t.device)
    v = big[offset:offset + t.numel()].view(t.shape)
    return v.copy_(t)


# decay_accum is bitwise equal to its plain version, also where a 16-byte
# vector of the kernel straddles a row (odd n, n < 8), on views at element
# offsets (acc, g and out at different alignments), and in place.
@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 0), (1, 3, 2),
                                     (3, 2, 1)], ids=str)
@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(9347,), (7, 9347), (64, 4097), (3, 1),
                                   (5, 3), (4, 7), (3, 8), (2, 9347)])
def test_decay_accum_kernel_matches_plain(card, shape, dtype, offsets):
    o_acc, o_g, o_out = offsets
    acc = _at_offset(_buf(shape, dtype, 0, card), o_acc)
    g = _at_offset(_buf(shape, dtype, 1, card), o_g)
    coefs = [-0.37, torch.tensor(-0.61, device=card)]
    if len(shape) == 2:
        coefs.append(torch.linspace(-1.0, 1.0, shape[0], device=card))
    for d in coefs:
        want = dacc.decay_accum_plain(acc, g, d)
        before = dacc.launches
        buf = _at_offset(acc, o_acc)
        got = dacc.decay_accum_cuda(buf, g, d, out=buf)
        out = _at_offset(torch.full_like(acc, float("nan")), o_out)
        sep = dacc.decay_accum_cuda(acc, g, d, out=out)
        torch.cuda.synchronize()
        assert dacc.launches == before + 2 and got.data_ptr() == buf.data_ptr()
        assert sep.data_ptr() == out.data_ptr()
        assert torch.equal(got, want) and torch.equal(sep, want)


@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(7, 9347), (1024, 9347), (1, 4097)])
def test_row_mean_kernel_matches_plain(card, shape, dtype):
    g = _buf(shape, dtype, 2, card)
    want = fu.row_mean_plain(g).float()
    before = fu.launches["row_mean"]
    got = fu.row_mean_cuda(g).float()
    torch.cuda.synchronize()
    assert fu.launches["row_mean"] == before + 1
    scale = g.float().abs().mean(0)
    err = (got - want).abs()
    # + one rounding of the result to its dtype
    assert bool((err <= 1e-6 * scale + _ulps(dtype) * want.abs()).all()), \
        err.max().item()


# row_mean's 16-byte vectors start at each row's own phase: odd n, n below
# one vector, tile edges (72 fp32 / 16-bit columns at n = 9347), views at
# element offsets, block sizes from m = 1 to 10,000. Every case repeats
# bitwise on a second call.
@pytest.mark.parametrize("offset", [0, 1, 3, 6, 7])
@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(1, 3), (33, 9), (65, 10), (257, 11),
                                   (129, 249), (5, 9347), (10000, 9347)])
def test_row_mean_kernel_at_its_edges_repeats_bitwise(card, shape, dtype,
                                                      offset):
    g = _at_offset(_buf(shape, dtype, 7, card), offset)
    want = fu.row_mean_plain(g).float()
    out = _at_offset(torch.zeros(shape[1], dtype=dtype, device=card), offset)
    got = fu.row_mean_cuda(g, out=out)
    again = fu.row_mean_cuda(g)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr() and torch.equal(got, again)
    scale = g.float().abs().mean(0)
    err = (got.float() - want).abs()
    assert bool((err <= 1e-6 * scale + _ulps(dtype) * want.abs()).all()), \
        err.max().item()


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(9347,), (7, 9347), (64, 4097)])
def test_momentum_kernel_matches_plain(card, shape, dtype, nesterov):
    p, g = _buf(shape, dtype, 3, card), _buf(shape, dtype, 4, card)
    mu = _buf(shape, torch.float32, 5, card)
    w = (torch.rand(shape[0], device=card) if len(shape) == 2 else 0.8)
    want_p, want_mu = fu.momentum_update_plain(p, g, mu, w, 5e-3, 0.9,
                                               nesterov=nesterov)
    pb, mb = p.clone(), mu.clone()
    got_p, got_mu = fu.momentum_update_cuda(pb, g, mb, w, 5e-3, 0.9,
                                            nesterov=nesterov, p_out=pb,
                                            mu_out=mb)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_mu, want_mu, rtol=_ulps(torch.float32),
                               atol=0)
    torch.testing.assert_close(got_p.float(), want_p.float(),
                               rtol=_ulps(dtype), atol=0)


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(9347,), (7, 9347), (64, 4097)])
def test_adam_kernel_matches_plain(card, shape, dtype, wd):
    p, g = _buf(shape, dtype, 6, card), _buf(shape, dtype, 7, card)
    mu = 0.1 * _buf(shape, torch.float32, 8, card)
    nu = _buf(shape, torch.float32, 9, card).abs() * 0.01
    w = (torch.rand(shape[0], device=card) if len(shape) == 2 else 0.8)
    bc1, bc2 = dispatch.adam_bias_corrections(3, 0.9, 0.95)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=wd)
    want = fu.adam_update_plain(p, g, mu, nu, w, 5e-3, bc1, bc2, **kw)
    got = fu.adam_update_cuda(p, g, mu, nu, w, 5e-3, bc1, bc2, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=_ulps(a.dtype),
                                   atol=0)


def test_flat_kernels_refuse_what_they_do_not_take(card):
    p = _buf((4, 8), torch.float32, 0, card)
    with pytest.raises(TypeError):
        dacc.decay_accum_cuda(p.double(), p.double(), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        dacc.decay_accum_cuda(p.t(), p.t(), 1.0)
    with pytest.raises(TypeError):
        fu.momentum_update_cuda(p, p, p.half(), 1.0, 0.1, 0.9)
    with pytest.raises(ValueError):
        fu.row_mean_cuda(p[0])


# --- the training path --------------------------------------------------------------

@pytest.mark.parametrize("opt", [None, "momentum", "adam"])
def test_run_fedrl_on_the_card_matches_the_cpu_run(card, opt):
    """The same draws (made on the host) through a card run and a CPU run:
    per-epoch metrics within rtol 1e-4, the server rows within atol 1e-5."""
    optimizer = {None: None, "momentum": flat_momentum(0.9),
                 "adam": flat_adam()}[opt]
    strat = make_strategy("decay", tau=3, taus=uniform_taus(1, 3, 7),
                          decay=exponential_decay(0.95))
    cfg = FedRLConfig(env=FIGURE_EIGHT, strategy=strat, eta=5e-3, n_epochs=2,
                      epoch_len=40, minibatch=10, optimizer=optimizer)
    draws = replay_of(cfg, TorchDraws(0, "cpu"))
    before = dict(fu.launches, decay_accum=dacc.launches)
    gpu_p, gpu_m, _ = run_fedrl(cfg, draws, device="cuda")
    cpu_p, cpu_m, _ = run_fedrl(cfg, draws, device="cpu")
    for k in cpu_m:
        np.testing.assert_allclose(gpu_m[k], cpu_m[k], rtol=1e-4)
    for h in ("pi", "vf"):
        for k in cpu_p[h]:
            np.testing.assert_allclose(gpu_p[h][k].detach().cpu().numpy(),
                                       cpu_p[h][k].detach().numpy(), atol=1e-5)
    local = {None: "decay_accum", "momentum": "momentum_update",
             "adam": "adam_update"}[opt]
    after = dict(fu.launches, decay_accum=dacc.launches)
    assert after[local] - before[local] == 8        # one per local update
    syncs, moments = 8 // 3, {None: 0, "momentum": 1, "adam": 2}[opt]
    assert after["row_mean"] - before["row_mean"] == \
        syncs * (1 + moments) + cfg.n_epochs + 1


# --- the gossip and compression kernels ----------------------------------------------
#
# consensus_step sums in ascending l with separate fp32 roundings; torch's
# matmul (the plain version) sums in another order: |kernel - plain| <=
# m * 2^-23 * (|P| @ |G32|) + one ulp of the output dtype. It is bitwise
# equal to consensus_gather over the full neighbour list with P's entries as
# weights, and propagates NaN as torch's matmul does. consensus_gather and topk_scatter's residual are bitwise equal to
# their plain versions; topk_scatter's sum is within m * 2^-24 * sum_i
# |sent[i, j]| + one ulp of the dtype.


def _gossip_case(m, n, dtype, seed, card):
    """The mixing matrix of knn_ring(m, 4) (m >= 5) and a seeded G."""
    topo = knn_ring(m, 4)
    p = torch.tensor(mixing_matrix(topo, 0.5 / topo.max_degree),
                     dtype=torch.float32)
    return p.to(card), _buf((m, n), dtype, seed, card), topo


def _all_l(m, card):
    """The list idx[i] = 0..m-1: a gather over it with w = P is the dense
    product, term for term in ascending l."""
    return torch.arange(m, dtype=torch.int32, device=card).repeat(m, 1)


# The mixing matrices of k-NN rings (sparse P; bitwise against the gather
# over neighbor_list(k_max=m)) and, at the kernel's tile edges (m = 1, 7:
# the small-m kernel; 33, 129, 1025: one past a 32 / 64 / 128-row tile; n =
# 1, 127, 4097: one past a 96-column tile and short rows), dense random P
# (bitwise against the gather over 0..m-1 with P's entries).
@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("m, n, dense", [
    (7, 9347, False), (64, 4097, False), (5, 4097, False), (1, 1, True),
    *[(m, n, True) for m in (1, 7, 33, 129, 1025) for n in (1, 127, 4097)]])
def test_consensus_step_kernel_matches_plain(card, m, n, dense, dtype):
    if dense:
        gen = torch.Generator().manual_seed(m * 7919 + n)
        p = (torch.rand(m, m, generator=gen) / m).to(card)
        g = _buf((m, n), dtype, 11, card)
    else:
        p, g, topo = _gossip_case(m, n, dtype, 11, card)
    want = cs.consensus_step_plain(g, p)
    before = cs.launches
    got = cs.consensus_step_cuda(g, p)
    torch.cuda.synchronize()
    assert cs.launches == before + 1 and got.dtype == dtype
    bound = m * 2.0 ** -23 * (p.abs() @ g.float().abs())
    err = (got.float() - want.float()).abs()
    assert bool((err <= bound + torch.finfo(dtype).eps * want.float().abs()
                 ).all()), err.max().item()
    if dense:
        full = cg.consensus_gather_cuda(g, _all_l(m, card), p.contiguous())
    else:       # bitwise equal to the gather over the full neighbour list
        nl = neighbor_list(topo, k_max=m)
        w = torch.tensor(neighbor_weights_from_matrix(
            nl, mixing_matrix(topo, 0.5 / topo.max_degree)), device=card)
        full = cg.consensus_gather_cuda(g, torch.tensor(nl.idx, device=card), w)
    assert torch.equal(full, got)


# A NaN or Inf in a row of G whose column of P is 0 comes out as NaN, as in
# torch.matmul: no tile of P is skipped for being zero.
@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("m", [7, 129])
def test_consensus_step_kernel_propagates_nan_like_matmul(card, m, dtype):
    gen = torch.Generator().manual_seed(m)
    p = torch.rand(m, m, generator=gen)
    p[:, 2] = 0.0
    g = _buf((m, 300), dtype, 12, card)
    g[2, 5] = float("inf")
    g[2, 200] = float("nan")
    p = p.to(card)
    got = cs.consensus_step_cuda(g, p)
    want = torch.matmul(p, g.float()).to(dtype)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[:, [5, 200]]).all())
    keep = ~torch.isnan(want)
    bound = m * 2.0 ** -23 * (p.abs() @ g.float().abs().nan_to_num(0, 0, 0))
    err = (got.float() - want.float()).abs()
    assert bool((err <= bound + torch.finfo(dtype).eps * want.float().abs())
                [keep].all())


@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("case", ["knn_ring(64,4)", "padded rand(40)"])
def test_consensus_gather_kernel_matches_plain_bitwise(card, case, dtype):
    if case.startswith("knn"):
        nl = neighbor_list(knn_ring(64, 4))
        eps = 0.1
    else:
        nl = neighbor_list(random_regularish(40, 3, 5, 2), k_max=12)
        eps = 0.05
    idx = torch.tensor(nl.idx, device=card)
    w = torch.tensor(neighbor_weights(nl, eps), device=card)
    g = _buf((nl.m, 9347), dtype, 12, card)
    want = cg.consensus_gather_plain(g, idx, w)
    before = cg.launches
    out = torch.empty_like(g)
    got = cg.consensus_gather_cuda(g, idx, w, out=out)
    torch.cuda.synchronize()
    assert cg.launches == before + 1 and got.data_ptr() == out.data_ptr()
    assert torch.equal(got, want)


def _gather_edge_list(case):
    """(idx, w) on the CPU: the staged kernel's row groups (m = 1000 and
    257, not multiples of 16; every list's ring wraps at agents 0 and m - 1),
    rows that share almost no neighbour, a padded list, m either side of
    the switch between the staged and the row kernel (MIN_STAGED_ROWS), and
    k_max either side of the other (MAX_SLOTS), rows of MAX_SLOTS sources
    each (the staged kernel's one-stage ring); small lists take the row
    kernel."""
    k_sw = cg.MAX_SLOTS
    if case == "wide":       # 186 sources a row: a one-stage ring
        m = cg.MIN_STAGED_ROWS
        gen = torch.Generator().manual_seed(m)
        idx = (torch.arange(m)[:, None] + torch.arange(k_sw)[None, :]) % m
        return idx.to(torch.int32), torch.rand(m, k_sw, generator=gen) / k_sw
    if case.startswith("full"):
        k = k_sw + (case == "full past k switch")
        gen = torch.Generator().manual_seed(k)
        return (torch.arange(k, dtype=torch.int32).repeat(k, 1),
                torch.rand(k, k, generator=gen) / k)
    m_sw = cg.MIN_STAGED_ROWS
    nl = {"knn_ring(1000,8)": lambda: neighbor_list(knn_ring(1000, 8)),
          "knn_ring(257,4)": lambda: neighbor_list(knn_ring(257, 4)),
          "knn_ring(m switch - 1,4)": lambda: neighbor_list(knn_ring(m_sw - 1, 4)),
          "knn_ring(m switch,8)": lambda: neighbor_list(knn_ring(m_sw, 8)),
          "knn_ring(12,8)": lambda: neighbor_list(knn_ring(12, 8)),
          "rand3-5(256)": lambda: neighbor_list(random_regularish(256, 3, 5, 1)),
          "padded rand(300)": lambda: neighbor_list(
              random_regularish(300, 3, 5, 3), k_max=16),
          "knn padded to k switch": lambda: neighbor_list(knn_ring(m_sw, 4),
                                                          k_max=k_sw),
          "knn padded past k switch": lambda: neighbor_list(knn_ring(m_sw, 4),
                                                            k_max=k_sw + 1),
          }[case]()
    return (torch.tensor(nl.idx),
            torch.tensor(neighbor_weights(nl, 0.5 / nl.max_degree)))


# Bitwise against the plain version with n in every residue mod 8 and g at
# every element offset of a 16-byte vector, the output at another offset.
@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("case", [
    "knn_ring(1000,8)", "knn_ring(257,4)", "knn_ring(m switch - 1,4)",
    "knn_ring(m switch,8)", "knn_ring(12,8)", "rand3-5(256)",
    "padded rand(300)", "knn padded to k switch", "knn padded past k switch",
    "full at k switch", "full past k switch", "wide"])
def test_consensus_gather_kernel_at_its_edges_bitwise(card, case, dtype):
    idx, w = _gather_edge_list(case)
    idx, w = idx.to(card), w.to(card)
    m, k_max = idx.shape
    kernel = cg.gather_plan(m, 136, k_max, dtype.itemsize, 132).kernel
    staged = m >= cg.MIN_STAGED_ROWS and k_max <= cg.MAX_SLOTS
    assert kernel == ("staged" if staged else "rows")
    for r in range(8):
        g0 = _buf((m, 129 + r), dtype, 20 + r, card)
        want = cg.consensus_gather_plain(g0, idx, w)
        out = _at_offset(torch.full_like(g0, float("nan")), (r + 3) % 8)
        before = cg.launches
        got = cg.consensus_gather_cuda(_at_offset(g0, r), idx, w, out=out)
        torch.cuda.synchronize()
        assert cg.launches == before + 1 and got.data_ptr() == out.data_ptr()
        assert torch.equal(got, want), (r, (got.float() - want.float()).abs().max())


@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("case", ["plain", "ties", "zero row"])
@pytest.mark.parametrize("m", [7, 1024])
def test_topk_scatter_kernel_matches_plain(card, m, case, dtype):
    x = _buf((m, 9347), torch.float32, 13, card)
    if case == "ties":
        x = torch.round(x * 4) / 4
    if case == "zero row":
        x[3] = 0.0
    x = x.to(dtype)
    t = comm.topk_threshold(x.float(), 584)
    want_sum, want_res = tks.topk_scatter_plain(x, t)
    before = tks.launches
    got_sum, got_res = tks.topk_scatter_cuda(x, t)
    torch.cuda.synchronize()
    assert tks.launches == before + 1
    assert torch.equal(got_res, want_res)
    x32 = x.float()
    sent = torch.where(x32.abs() >= t[:, None], x32, 0.0)
    bound = m * 2.0 ** -24 * sent.abs().sum(0) + \
        torch.finfo(dtype).eps * want_sum.float().abs()
    assert bool(((got_sum.float() - want_sum.float()).abs() <= bound).all())


def test_gossip_kernels_refuse_what_they_do_not_take(card):
    p, g, _ = _gossip_case(7, 64, torch.float32, 0, card)
    with pytest.raises(ValueError, match="in place"):
        cs.consensus_step_cuda(g, p, out=g)
    with pytest.raises(TypeError):
        cs.consensus_step_cuda(g, p.double())
    nl = neighbor_list(knn_ring(7, 2))
    idx = torch.tensor(nl.idx, device=card)
    w = torch.tensor(neighbor_weights(nl, 0.1), device=card)
    with pytest.raises(TypeError):
        cg.consensus_gather_cuda(g, idx.long(), w)
    with pytest.raises(ValueError, match="in place"):
        cg.consensus_gather_cuda(g, idx, w, out=g)
    with pytest.raises(TypeError):
        tks.topk_scatter_cuda(g, torch.zeros(7, device=card).double())


@pytest.mark.parametrize("case", ["dense", "sparse-E2", "topk-gossip"])
def test_consensus_run_on_the_card_matches_the_cpu_run(card, case):
    topo = random_regularish(7, 3, 4, 0)
    kw = dict(tau=3, topo=topo, eps=0.9 / topo.max_degree)
    if case == "sparse-E2":
        kw.update(rounds=2, sparse=True)
    if case == "topk-gossip":
        kw.update(comm=comm.topk(584))
    strat = make_strategy("consensus", **kw)
    cfg = FedRLConfig(env=FIGURE_EIGHT, strategy=strat, eta=5e-3, n_epochs=2,
                      epoch_len=40, minibatch=10, optimizer=flat_adam())
    draws = replay_of(cfg, TorchDraws(0, "cpu"))
    before = (cs.launches, cg.launches, tks.launches)
    gpu_p, gpu_m, _ = run_fedrl(cfg, draws, device="cuda")
    cpu_p, cpu_m, _ = run_fedrl(cfg, draws, device="cpu")
    for k in cpu_m:
        np.testing.assert_allclose(gpu_m[k], cpu_m[k], rtol=1e-4)
    for h in ("pi", "vf"):
        for k in cpu_p[h]:
            np.testing.assert_allclose(gpu_p[h][k].detach().cpu().numpy(),
                                       cpu_p[h][k].detach().numpy(), atol=1e-4)
    got = tuple(a - b for a, b in zip((cs.launches, cg.launches, tks.launches),
                                      before))
    want = {"dense": (8, 0, 0), "sparse-E2": (0, 16, 0),
            "topk-gossip": (8, 0, 8 // 3)}[case]
    assert got == want


# --- the WKV6 recurrence and the RWKV6 model -------------------------------------
#
# The kernel and the plain loop sum the contraction over i in another order,
# so both are held against the plain loop evaluated in float64 on the same
# inputs: the kernel's error within max(1e-5, 2x the fp32 plain loop's own
# error).

WKV_ATOL = 1e-5


def _wkv_case(b, t, h, seed, card, state_scale=0.1):
    """r, k, v ~ 0.5 N(0, 1); the model's decay exp(-exp(N(0, 0.5)));
    u ~ 0.5 N(0, 1); a nonzero initial state."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.tensor((0.5 * rng.standard_normal(s)).astype(
        np.float32), device=card)
    r, k, v = f(b, t, h, 64), f(b, t, h, 64), f(b, t, h, 64)
    w = torch.exp(-torch.exp(f(b, t, h, 64)))
    u = f(h, 64)
    s0 = state_scale * f(b, h, 64, 64) / 0.5
    return r, k, v, w, u, s0


def _assert_near_f64(got, plain32, want64, what):
    err = float((got.double() - want64).abs().max())
    plain_err = float((plain32.double() - want64).abs().max())
    assert err <= max(WKV_ATOL, 2 * plain_err), (what, err, plain_err)


@pytest.mark.parametrize("b,t,h", [(8, 512, 32), (8, 1, 32), (1, 7, 1),
                                   (1, 1000, 2), (3, 33, 4), (1, 1, 1)])
def test_wkv6_kernel_matches_plain(card, b, t, h):
    args = _wkv_case(b, t, h, b * 1000 + t + h, card)
    want_y, want_s = wk.wkv6_plain(*[a.double() for a in args])
    y32, s32 = wk.wkv6_plain(*args)
    before = wk.launches
    y, s = wk.wkv6_cuda(*args)
    torch.cuda.synchronize()
    assert wk.launches == before + 1
    _assert_near_f64(y, y32, want_y, "y")
    _assert_near_f64(s, s32, want_s, "state")


def test_wkv6_kernel_in_place_state_and_chaining(card):
    """The final state written over the initial one; two halves chained
    through the state equal one run."""
    r, k, v, w, u, s0 = _wkv_case(2, 64, 3, 5, card)
    y_full, s_full = wk.wkv6_cuda(r, k, v, w, u, s0)
    st = s0.clone()
    y1, out = wk.wkv6_cuda(r[:, :29].contiguous(), k[:, :29].contiguous(),
                           v[:, :29].contiguous(), w[:, :29].contiguous(), u,
                           st, state_out=st)
    assert out is st
    y2, _ = wk.wkv6_cuda(r[:, 29:].contiguous(), k[:, 29:].contiguous(),
                         v[:, 29:].contiguous(), w[:, 29:].contiguous(), u,
                         st, state_out=st)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([y1, y2], 1), y_full)
    assert torch.equal(st, s_full)


# The kernel picks its block shape, its path (the one-stage tile, the ring
# of stages, the whole-column decode kernel) and its copy width by shape and
# alignment; none of them changes the arithmetic, so these hold bitwise.
@pytest.mark.parametrize("b,t,h", [(1, 9, 1), (1, 33, 3), (2, 65, 3),
                                   (4, 17, 32), (8, 40, 32), (1, 70, 32)])
def test_wkv6_kernel_matches_plain_past_its_stages(card, b, t, h):
    args = _wkv_case(b, t, h, 3 * b + t + h, card)
    want_y, want_s = wk.wkv6_plain(*[a.double() for a in args])
    y32, s32 = wk.wkv6_plain(*args)
    y, s = wk.wkv6_cuda(*args)
    torch.cuda.synchronize()
    _assert_near_f64(y, y32, want_y, "y")
    _assert_near_f64(s, s32, want_s, "state")


@pytest.mark.parametrize("b,t", [(8, 1), (8, 40), (4, 70), (3, 9)])
def test_wkv6_each_batch_row_alone_is_bitwise_the_batch(card, b, t):
    args = _wkv_case(b, t, 32, 11 * b + t, card)
    y, s = wk.wkv6_cuda(*args)
    for i in range(b):
        one = [a[i:i + 1].contiguous() if a.ndim == 4 else a for a in args]
        yi, si = wk.wkv6_cuda(*one)
        torch.cuda.synchronize()
        assert torch.equal(yi, y[i:i + 1]) and torch.equal(si, s[i:i + 1])


@pytest.mark.parametrize("cut", [1, 8, 9, 16, 32, 33, 64])
def test_wkv6_chained_at_any_cut_is_bitwise_one_run(card, cut):
    r, k, v, w, u, s0 = _wkv_case(1, 65, 3, 13, card)
    y_full, s_full = wk.wkv6_cuda(r, k, v, w, u, s0)
    st = s0.clone()
    ys = [wk.wkv6_cuda(*[a[:, sl].contiguous() for a in (r, k, v, w)], u, st,
                       state_out=st)[0]
          for sl in (slice(0, cut), slice(cut, 65))]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(ys, 1), y_full) and torch.equal(st, s_full)


@pytest.mark.parametrize("b", [1, 8])
def test_wkv6_decode_in_place_is_bitwise_a_separate_state(card, b):
    args = _wkv_case(b, 1, 32, 17 + b, card)
    y, s = wk.wkv6_cuda(*args)
    st = args[5].clone()
    y2, out = wk.wkv6_cuda(*args[:5], st, state_out=st)
    torch.cuda.synchronize()
    assert out is st and torch.equal(y2, y) and torch.equal(st, s)


@pytest.mark.parametrize("b,t,h", [(2, 19, 3), (8, 1, 32), (1, 70, 32)])
def test_wkv6_unaligned_views_are_bitwise_the_aligned_run(card, b, t, h):
    args = _wkv_case(b, t, h, 19 + t, card)
    y, s = wk.wkv6_cuda(*args)
    moved = [_at_offset(a, 1) for a in args]
    st = _at_offset(torch.zeros_like(args[5]), 1)
    y2, s2 = wk.wkv6_cuda(*moved, state_out=st)
    torch.cuda.synchronize()
    assert torch.equal(y2, y) and torch.equal(s2, s)


def test_wkv6_kernel_refuses_what_it_does_not_take(card):
    r, k, v, w, u, s0 = _wkv_case(1, 4, 2, 0, card)
    with pytest.raises(TypeError):
        wk.wkv6_cuda(r.double(), k, v, w, u, s0)
    with pytest.raises(ValueError, match="head size"):
        wk.wkv6_cuda(r[..., :32], k[..., :32], v[..., :32], w[..., :32],
                     u[:, :32], s0[:, :, :32, :32])
    with pytest.raises(ValueError, match="contiguous"):
        wk.wkv6_cuda(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w,
                     u, s0)
    with pytest.raises(ValueError, match="T >= 1"):
        wk.wkv6_cuda(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, s0)
    buf = torch.zeros(s0.numel() + 64, device=card)
    with pytest.raises(ValueError, match="overlaps"):
        wk.wkv6_cuda(r, k, v, w, u, buf[:s0.numel()].view(s0.shape),
                     state_out=buf[64:].view(s0.shape))


def _reduced_lm(card, scale=1.0):
    cfg = TC.get_arch("rwkv6-1.6b").reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    params = TM.transformer.tree_map(lambda t: t * scale, params)
    return cfg, params, TM.transformer.tree_map(lambda t: t.to(card), params)


def test_lm_on_the_card_matches_the_cpu_port(card):
    """Reduced RWKV6 in fp32: prefill and three decode steps on the card
    against the same on the CPU (atol 1e-4: fp32 in another summation
    order), one kernel launch per layer and call."""
    cfg, cpu_p, gpu_p = _reduced_lm(card)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 21)))
    lg_c, st_c = TM.prefill(cfg, cpu_p, toks[:, :18])
    before = wk.launches
    lg_g, st_g = TM.prefill(cfg, gpu_p, toks[:, :18].to(card))
    assert wk.launches - before == cfg.n_layers
    torch.testing.assert_close(lg_g.cpu(), lg_c, atol=1e-4, rtol=0)
    for i in range(3):
        tok = toks[:, 18 + i:19 + i]
        pos = torch.full((3,), 18 + i)
        lg_c, st_c = TM.decode_step(cfg, cpu_p, tok, st_c, pos)
        before = wk.launches
        lg_g, st_g = TM.decode_step(cfg, gpu_p, tok.to(card), st_g,
                                    pos.to(card))
        assert wk.launches - before == cfg.n_layers
        torch.testing.assert_close(lg_g.cpu(), lg_c, atol=1e-4, rtol=0)
    torch.testing.assert_close(st_g["tm"]["wkv"].cpu(), st_c["tm"]["wkv"],
                               atol=1e-4, rtol=0)


def test_serving_loop_on_the_card_matches_single_request_greedy(card):
    """fp32 weights scaled x6, so that the recurrent state decides the
    tokens; 2 slots, 5 requests (both slots recycled)."""
    cfg, _, gpu_p = _reduced_lm(card, scale=6.0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 3, 7, 1, 9)]
    done = ServingLoop(cfg, gpu_p, n_slots=2, max_seq=64).run(
        [Request(i, p, 4) for i, p in enumerate(prompts)])
    got = {c.rid: c.tokens for c in done}
    for i, p in enumerate(prompts):
        lg, st = TM.prefill(cfg, gpu_p, torch.as_tensor(p[None], device=card))
        tok = lg[:, -1:].argmax(-1)
        want = [int(tok)]
        for j in range(3):
            lg, st = TM.decode_step(cfg, gpu_p, tok, st,
                                    torch.tensor([len(p) + j], device=card))
            tok = lg[:, -1:].argmax(-1)
            want.append(int(tok))
        assert got[i] == want, i


# --- sliding-window attention ------------------------------------------------------

SWA_ATOL = 1e-5
BF16_REL = 2.0 ** -7
SWA_MEAN_RATIO = 1.1


def _swa_case(b, sq, sk, h, kv, d, dtype, seed, card):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32),
                                device=card).to(dtype)
    return f(b, sq, h, d), f(b, sk, kv, d), f(b, sk, kv, d)


def _swa_one_bf16_p(q, k, v, window, causal):
    """The control of the mean-error rule: the function with its softmax
    weights rounded once to bf16 for p @ v (fp32 otherwise), what the bf16
    kernel would compute without p_lo."""
    B, Sq, H, D = q.shape
    Sk, rep = k.shape[1], H // k.shape[2]
    kr, vr = (t.repeat_interleave(rep, dim=2).float() for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * D ** -0.5
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    s = s.masked_fill(~ok, sw.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), vr)
    return (o / p.sum(-1).transpose(1, 2)[..., None]).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,sq,sk,h,kv,d,window,causal", [
    (2, 512, 512, 8, 2, 120, 96, True),
    (1, 300, 300, 4, 1, 120, None, True),
    (1, 200, 200, 4, 4, 128, None, False),
    (2, 100, 100, 4, 2, 120, 1, True),
    (1, 77, 130, 6, 2, 128, 40, True),
    (1, 130, 77, 6, 3, 120, None, True),
    (3, 7, 7, 2, 1, 120, 5, False),
    # the bf16 kernel's 128-row tile edges
    (1, 129, 255, 4, 1, 120, None, True),
    (1, 255, 129, 4, 4, 120, None, True),
    (1, 255, 255, 4, 2, 120, 1, True),
    (1, 300, 300, 4, 2, 120, 100, True),
    (1, 129, 300, 4, 2, 128, None, False),
    (3, 200, 200, 8, 2, 120, 100, True),
    (3, 255, 255, 4, 4, 128, None, True),
])
def test_swa_attention_kernel_matches_plain(card, b, sq, sk, h, kv, d, window,
                                            causal, dtype):
    """Both against the plain version in float64 on the same inputs: the
    kernel within max(1e-5, 2x the fp32 plain version's error), bf16 outputs
    one bf16 ulp more. In bf16 also the mean error: the kernel's within 1.1x
    the plain version's, which the control (one bf16 p) exceeds wherever
    W > 1 (with W = 1, p = 1 is exact)."""
    q, k, v = _swa_case(b, sq, sk, h, kv, d, dtype, sq * 7 + h + d, card)
    kw = dict(window=window, causal=causal)
    want = sw.swa_attention_plain(q.double(), k.double(), v.double(), **kw)
    plain = sw.swa_attention_plain(q, k, v, **kw)
    before = sw.launches
    got = sw.swa_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert sw.launches == before + 1 and got.dtype == dtype
    tol = max(SWA_ATOL, 2 * float((plain.double() - want).abs().max()))
    if dtype == torch.bfloat16:
        tol = tol + BF16_REL * want.abs()
    assert bool(((got.double() - want).abs() <= tol).all())
    if dtype == torch.bfloat16:
        mean = lambda x: float((x.double() - want).abs().mean())
        lim = SWA_MEAN_RATIO * mean(plain)
        assert mean(got) <= lim
        if window != 1:
            assert mean(_swa_one_bf16_p(q, k, v, window, causal)) > lim


def test_swa_attention_kernel_refuses_what_it_does_not_take(card):
    q, k, v = _swa_case(1, 8, 8, 4, 2, 120, torch.float32, 0, card)
    with pytest.raises(ValueError, match=r"head sizes \(120, 128\)"):
        sw.swa_attention_cuda(q[..., :64].contiguous(),
                              k[..., :64].contiguous(),
                              v[..., :64].contiguous())
    with pytest.raises(TypeError):
        sw.swa_attention_cuda(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        sw.swa_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        sw.swa_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2),
                              k, v)
    with pytest.raises(ValueError, match="Sq >= 1"):
        sw.swa_attention_cuda(q[:, :0], k, v)
    with pytest.raises(ValueError, match="no key in their window"):
        sw.swa_attention_cuda(q, k[:, :2].contiguous(), v[:, :2].contiguous(),
                              window=4)


def _reduced_swa_lm(card, scale=1.0):
    """The reduced danube at head size 120 (the kernel's), fp32."""
    import dataclasses
    cfg = dataclasses.replace(TC.get_arch("h2o-danube-3-4b").reduced(),
                              head_dim=120, n_kv_heads=2)
    params = TM.init_params(cfg, seed=0, device="cpu")
    params = TM.transformer.tree_map(lambda t: t * scale, params)
    return cfg, params, TM.transformer.tree_map(lambda t: t.to(card), params)


def test_swa_lm_on_the_card_matches_the_cpu_port(card):
    """Prefill 40 tokens (window 16) and four decode steps (the ring wraps)
    on the card against the same on the CPU (atol 1e-4), one kernel launch
    per layer and prefill, none per decode step."""
    cfg, cpu_p, gpu_p = _reduced_swa_lm(card)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 44)))
    lg_c, st_c = TM.prefill(cfg, cpu_p, toks[:, :40], cache_len=48)
    before = sw.launches
    lg_g, st_g = TM.prefill(cfg, gpu_p, toks[:, :40].to(card), cache_len=48)
    assert sw.launches - before == cfg.n_layers
    torch.testing.assert_close(lg_g.cpu(), lg_c, atol=1e-4, rtol=0)
    for i in range(4):
        tok, pos = toks[:, 40 + i:41 + i], torch.full((2,), 40 + i)
        lg_c, st_c = TM.decode_step(cfg, cpu_p, tok, st_c, pos)
        before = sw.launches
        lg_g, st_g = TM.decode_step(cfg, gpu_p, tok.to(card), st_g,
                                    pos.to(card))
        assert sw.launches == before
        torch.testing.assert_close(lg_g.cpu(), lg_c, atol=1e-4, rtol=0)
    assert torch.equal(st_g["cache"]["pos"].cpu(), st_c["cache"]["pos"])


def test_swa_serving_loop_on_the_card_matches_single_request_greedy(card):
    """fp32 weights scaled x4; 2 slots, 5 requests, prompts past the
    window, a 1-token prompt in a recycled slot."""
    cfg, _, gpu_p = _reduced_swa_lm(card, scale=4.0)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 3, 27, 1, 9)]
    done = ServingLoop(cfg, gpu_p, n_slots=2, max_seq=64).run(
        [Request(i, p, 4) for i, p in enumerate(prompts)])
    got = {c.rid: c.tokens for c in done}
    for i, p in enumerate(prompts):
        lg, st = TM.prefill(cfg, gpu_p, torch.as_tensor(p[None], device=card),
                            cache_len=64)
        tok = lg[:, -1:].argmax(-1)
        want = [int(tok)]
        for j in range(3):
            lg, st = TM.decode_step(cfg, gpu_p, tok, st,
                                    torch.tensor([len(p) + j], device=card))
            tok = lg[:, -1:].argmax(-1)
            want.append(int(tok))
        assert got[i] == want, i


# --- the sweep slice: batched kernels and a batched run -----------------------------

def _sweep_inputs(S, m, n, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    return (rnd(S, m, n).to(dtype), rnd(S, m, n).to(dtype),
            torch.rand(S, m, generator=gen, device="cuda"),
            torch.rand(S, generator=gen, device="cuda") * 1e-2 + 1e-3)


@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("S, m, n", [(3, 7, 9347), (2, 65, 129), (5, 1, 33)])
def test_batched_flat_kernels_are_bitwise_s_launches(card, S, m, n, dtype):
    """One (S, m, n) launch of row_mean, decay_accum, momentum and Adam (a
    weight per row, a learning rate per run) is bitwise the S unbatched
    launches on the runs' slices."""
    p, g, w, lr = _sweep_inputs(S, m, n, dtype, 20)
    mu = torch.randn(S, m, n, device="cuda") * 0.1
    nu = mu.abs()
    row = fu.row_mean_cuda(g)
    assert torch.equal(row, torch.stack([fu.row_mean_cuda(g[s])
                                         for s in range(S)]))
    out = dacc.decay_accum_cuda(p, g, w)
    assert torch.equal(out, torch.stack([dacc.decay_accum_cuda(p[s], g[s], w[s])
                                         for s in range(S)]))
    bp, bm = fu.momentum_update_cuda(p, g, mu, w, lr, 0.9, nesterov=True)
    for s in range(S):
        lp, lm = fu.momentum_update_cuda(p[s], g[s], mu[s], w[s], float(lr[s]),
                                         0.9, nesterov=True)
        assert torch.equal(bp[s], lp) and torch.equal(bm[s], lm)
    bp, bm, bv = fu.adam_update_cuda(p, g, mu, nu, w, lr, 0.19, 0.0975,
                                     weight_decay=0.01)
    for s in range(S):
        lp, lm, lv = fu.adam_update_cuda(p[s], g[s], mu[s], nu[s], w[s],
                                         float(lr[s]), 0.19, 0.0975,
                                         weight_decay=0.01)
        assert torch.equal(bp[s], lp) and torch.equal(bv[s], lv)


@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("per_run", [False, True])
@pytest.mark.parametrize("S, m, n", [(3, 7, 9347), (2, 65, 129), (4, 33, 97)])
def test_batched_gossip_kernels_are_bitwise_s_launches(card, S, m, n, dtype,
                                                       per_run):
    """consensus_step with a shared or per-run P, consensus_gather folded
    through the dispatch, topk_scatter with per-run thresholds: one launch,
    bitwise the S unbatched launches."""
    _, g, _, _ = _sweep_inputs(S, m, n, dtype, 21)
    topo = knn_ring(m, 2)
    P = torch.tensor(mixing_matrix(topo, 0.2), dtype=torch.float32,
                     device="cuda")
    mix = P[None] * torch.linspace(0.5, 1.5, S, device="cuda")[:, None, None] \
        if per_run else P
    before = cs.launches
    got = cs.consensus_step_cuda(g, mix.contiguous())
    assert cs.launches == before + 1
    for s in range(S):
        assert torch.equal(got[s], cs.consensus_step_cuda(
            g[s], (mix[s] if per_run else mix).contiguous()))
    nl = neighbor_list(topo)
    wt = torch.tensor(neighbor_weights(nl, 0.2), device="cuda")
    wts = wt[None] * torch.linspace(0.5, 1.5, S, device="cuda")[:, None, None] \
        if per_run else wt
    got = dispatch.consensus_gather(g, nl.idx, wts)
    for s in range(S):
        assert torch.equal(got[s], dispatch.consensus_gather(
            g[s], nl.idx, wts[s] if per_run else wts))
    th = comm.topk_threshold(g.float(), max(1, n // 16))
    ssum, res = tks.topk_scatter_cuda(g, th)
    for s in range(S):
        ls, lr_ = tks.topk_scatter_cuda(g[s], th[s].contiguous())
        assert torch.equal(ssum[s], ls) and torch.equal(res[s], lr_)


def test_a_batched_sweep_on_the_card_matches_the_cpu_runs(card):
    """A 2-run lambda sweep batched on the card against the same runs (the
    card runs' own draws) batched on the CPU, at rtol / atol 1e-4."""
    from repro_torch.rl.fedrl import run_fedrl_batch
    from repro_torch.sweep.overrides import override_lam

    base = FedRLConfig(env=FIGURE_EIGHT, strategy=make_strategy(
        "decay", tau=3, taus=uniform_taus(1, 3, 7),
        decay=exponential_decay(0.95)), eta=5e-3, n_epochs=2, epoch_len=40,
        minibatch=10, optimizer=flat_momentum(0.9))
    cfgs = [override_lam(base, lam) for lam in (0.98, 0.9)]
    _, got, _ = run_fedrl_batch(cfgs, [0, 1], device="cuda")
    draws = [replay_of(c, TorchDraws(s, "cuda")) for c, s in zip(cfgs, (0, 1))]
    _, want, _ = run_fedrl_batch(cfgs, draws, device="cpu")
    for k in want:
        assert got[k].shape == (2, 2)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
