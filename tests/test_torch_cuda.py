"""The port's kernels on the card (marker ``cuda``; skipped without one).

This file imports no JAX, so it runs on a machine that has PyTorch for CUDA
and ``nvcc`` but no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the card, the
serving engine on the card against the engine on the CPU, a short training
run on the card against the same run (same draws) on the CPU, and the
reduced RWKV6 and sliding-window attention language models on the card
against the port on the CPU, and the attention backward kernel against its
plain version and one full-width federated LM step; the reduced whisper
encoder-decoder at head 64 on the card against the CPU.
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
from repro_torch.kernels import swa_attention_bwd as swb
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
    # D = 256 (gemma-7b, recurrentgemma-9b): the bf16 kernel's 64-key tiles
    (1, 65, 65, 16, 1, 256, None, True),
    (2, 129, 129, 16, 16, 256, 2048, True),
    (1, 200, 200, 8, 1, 256, 40, True),
    (1, 127, 255, 4, 2, 256, None, True),
    (1, 300, 129, 4, 4, 256, None, True),
    (1, 129, 300, 4, 1, 256, None, False),
    # D = 64 (whisper-small): the encoder's bidirectional attention, the
    # cross-attention of a decode step, of the 4- and 227-token prompts,
    # causal self-attention, the 128-row tile edges, H / KV = 4
    (8, 1500, 1500, 12, 12, 64, None, False),
    (8, 1, 1500, 12, 12, 64, None, False),
    (8, 4, 1500, 12, 12, 64, None, False),
    (1, 227, 1500, 12, 12, 64, None, False),
    (1, 227, 227, 12, 12, 64, None, True),
    (1, 129, 255, 12, 12, 64, None, False),
    (1, 255, 129, 12, 12, 64, None, True),
    (3, 255, 255, 12, 3, 64, None, True),
    # D = 128 at internvl2-26b's GQA, 48 query heads on 8 KV heads (a group
    # of 6): prefix + tokens on the 128-row tile (768) and off it (756)
    (2, 768, 768, 48, 8, 128, None, True),
    (1, 756, 756, 48, 8, 128, None, True),
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
    with pytest.raises(ValueError,
                       match=r"head sizes \(64, 120, 128, 256\)"):
        sw.swa_attention_cuda(q[..., :32].contiguous(),
                              k[..., :32].contiguous(),
                              v[..., :32].contiguous())
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_swa_attention_d256_repeats_bitwise_and_writes_the_lse(card, dtype):
    """At D = 256 a call repeats bitwise and its lse matches the plain
    version's (the backward slice reads it)."""
    q, k, v = _swa_case(1, 300, 300, 16, 1, 256, dtype, 5, card)
    o, lse = sw.swa_attention_cuda(q, k, v, window=100, with_lse=True)
    o2, lse2 = sw.swa_attention_cuda(q, k, v, window=100, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    _, plse = sw.swa_attention_plain(q, k, v, window=100, with_lse=True)
    assert float(((lse - plse).abs() / plse.abs().clamp(min=1.0)).max()) \
        <= 1e-5


def test_d256_training_launches_the_forward_and_the_backward_once(card):
    """Since slice 16 the backward takes D = 256 too: a training call on
    the card launches the forward and the backward kernel once each, and
    its gradients are the backward kernel's on the forward's residuals."""
    q, k, v = _swa_case(1, 64, 64, 4, 1, 256, torch.bfloat16, 6, card)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    do = torch.randn_like(q)
    before = (sw.launches, swb.launches)
    o = dispatch.swa_attention(*leaves)
    got = torch.autograd.grad(o, leaves, do)
    assert (sw.launches - before[0], swb.launches - before[1]) == (1, 1)
    o2, lse = sw.swa_attention_cuda(q, k, v, with_lse=True)
    want = swb.swa_attention_bwd_cuda(q, k, v, o2, do, lse)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("d", [64, 128, 256])
def test_attention_kernels_launch_from_a_new_host_thread(card, d):
    """The bf16 forward and backward kernels as the first CUDA work of a new
    host thread (as on autograd's device thread when the attention backward
    is a backward's first op): the thread has no current context until
    its first runtime call, which their tensor-map encode needs; the
    launches bind it themselves and give the main thread's results."""
    import threading
    q, k, v = _swa_case(1, 100, 100, 4, 2, d, torch.bfloat16, 8, card)
    do = torch.randn_like(q)
    o, lse = sw.swa_attention_cuda(q, k, v, with_lse=True)
    want = (o, *swb.swa_attention_bwd_cuda(q, k, v, o, do, lse))
    got, errors = [], []

    def first_cuda_work():
        try:
            o2, lse2 = sw.swa_attention_cuda(q, k, v, with_lse=True)
            got.append(o2)
            got.extend(swb.swa_attention_bwd_cuda(q, k, v, o2, do, lse2))
            torch.cuda.synchronize()
        except Exception as e:         # reported by the assert below
            errors.append(e)

    t = threading.Thread(target=first_cuda_work)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(got) == len(want)


def test_d64_training_launches_the_forward_and_the_backward_once(card):
    """Since slice 19 the backward takes D = 64 (whisper-small training): a
    non-causal training call on the card launches the forward and the
    backward kernel once each, and its gradients are the backward kernel's
    on the forward's residuals."""
    q, k, v = _swa_case(1, 64, 100, 4, 4, 64, torch.bfloat16, 7, card)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    do = torch.randn_like(q)
    before = (sw.launches, swb.launches)
    o = dispatch.swa_attention(*leaves, causal=False)
    got = torch.autograd.grad(o, leaves, do)
    assert (sw.launches - before[0], swb.launches - before[1]) == (1, 1)
    o2, lse = sw.swa_attention_cuda(q, k, v, causal=False, with_lse=True)
    want = swb.swa_attention_bwd_cuda(q, k, v, o2, do, lse, causal=False)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def _reduced_whisper(card):
    """The reduced whisper (2 + 2 layers, d 128, 8 frames) at head size 64
    (the kernel's), fp32: on the CPU and a copy on the card."""
    import dataclasses
    cfg = dataclasses.replace(TC.get_arch("whisper-small").reduced(),
                              head_dim=64)
    params = TM.init_params(cfg, seed=2, device="cpu")
    return cfg, params, TM.transformer.tree_map(lambda t: t.to(card), params)


def test_whisper_on_the_card_matches_the_cpu_port(card):
    """The serve steps at head 64 on the card against the CPU (atol 1e-4):
    a prefill of 12 tokens over 8 frames sized for 4 more, then four decode
    steps; 3 launches a layer a prefill (encoder, decoder self, cross) and
    one a layer a decode step (the cross-attention); the caches equal too."""
    from repro_torch.launch import make_prefill_step, make_serve_step
    cfg, cpu_p, gpu_p = _reduced_whisper(card)
    rng = np.random.default_rng(8)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)))
    frames = torch.as_tensor(
        0.1 * rng.standard_normal((2, cfg.n_frontend_tokens, cfg.d_model)),
        dtype=torch.float32)
    before = sw.launches
    lg_g, st_g = make_prefill_step(cfg)(gpu_p, {"tokens": toks[:, :12].to(
        card), "frames": frames.to(card)})
    assert sw.launches - before == 3 * cfg.n_layers
    lg_c, _ = make_prefill_step(cfg)(cpu_p, {"tokens": toks[:, :12],
                                             "frames": frames})
    torch.testing.assert_close(lg_g.cpu(), lg_c, atol=1e-4, rtol=0)
    states = []
    for p, dev in ((cpu_p, "cpu"), (gpu_p, card)):
        _, st = TM.encdec_forward(cfg, p, toks[:, :12].to(dev),
                                  frames.to(dev), mode="prefill",
                                  cache_len=16)
        state = TM.init_encdec_decode_state(cfg, 2, 16, frames.shape[1],
                                            device=dev)
        state.update(self=st["cache"], cross_k=st["cross"]["k"],
                     cross_v=st["cross"]["v"])
        states.append(state)
    step = make_serve_step(cfg)
    for i in range(4):
        tok, pos = toks[:, 12 + i:13 + i], torch.full((2,), 12 + i)
        lg_c, states[0] = step(cpu_p, tok, states[0], pos)
        before = sw.launches
        lg_g, states[1] = step(gpu_p, tok.to(card), states[1], pos.to(card))
        assert sw.launches - before == cfg.n_layers
        torch.testing.assert_close(lg_g.cpu(), lg_c, atol=1e-4, rtol=0)
    for a, b in zip(TM.transformer.tree_leaves(states[1]),
                    TM.transformer.tree_leaves(states[0])):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)


def _reduced_head256(arch, card, scale=1.0):
    """A reduced model at head size 256, fp32: gemma (2 global layers, 2
    heads) or recurrentgemma (5 layers of (rglru, rglru, local), 4 query
    heads on 1 KV head, window 8)."""
    import dataclasses
    kw = {"gemma-7b": dict(n_layers=2, n_heads=2, n_kv_heads=2),
          "recurrentgemma-9b": dict(n_layers=5, n_heads=4, n_kv_heads=1,
                                    lru_width=128, sliding_window=8)}[arch]
    cfg = dataclasses.replace(TC.get_arch(arch), d_model=128, head_dim=256,
                              d_ff=256, vocab_size=512, param_dtype="float32",
                              compute_dtype="float32", remat=False, **kw)
    params = TM.init_params(cfg, seed=1, device="cpu")
    params = TM.transformer.tree_map(lambda t: t * scale, params)
    return cfg, params, TM.transformer.tree_map(lambda t: t.to(card), params)


@pytest.mark.parametrize("arch", ["gemma-7b", "recurrentgemma-9b"])
def test_head256_lm_on_the_card_matches_the_cpu_port(card, arch):
    """Prefill 20 tokens and four decode steps at head 256 on the card
    against the same on the CPU (atol 1e-4; for recurrentgemma the ring of
    8 wraps), one kernel launch per attention layer and prefill, none per
    decode step, the recurrent states equal too."""
    cfg, cpu_p, gpu_p = _reduced_head256(arch, card)
    n_attn = sum(cfg.block_kind(i) != "rglru" for i in range(cfg.n_layers))
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 24)))
    lg_c, st_c = TM.prefill(cfg, cpu_p, toks[:, :20], cache_len=24)
    before = sw.launches
    lg_g, st_g = TM.prefill(cfg, gpu_p, toks[:, :20].to(card), cache_len=24)
    assert sw.launches - before == n_attn
    torch.testing.assert_close(lg_g.cpu(), lg_c, atol=1e-4, rtol=0)
    for i in range(4):
        tok, pos = toks[:, 20 + i:21 + i], torch.full((2,), 20 + i)
        lg_c, st_c = TM.decode_step(cfg, cpu_p, tok, st_c, pos)
        before = sw.launches
        lg_g, st_g = TM.decode_step(cfg, gpu_p, tok.to(card), st_g,
                                    pos.to(card))
        assert sw.launches == before
        torch.testing.assert_close(lg_g.cpu(), lg_c, atol=1e-4, rtol=0)
    for a, b in zip(TM.transformer.tree_leaves(st_g),
                    TM.transformer.tree_leaves(st_c)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)


def test_head256_serving_loop_on_the_card_matches_single_request_greedy(card):
    """recurrentgemma reduced, weights x4: 2 slots, 5 requests, prompts
    past the window, a 1-token prompt in a recycled slot."""
    cfg, _, gpu_p = _reduced_head256("recurrentgemma-9b", card, scale=4.0)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (14, 3, 21, 1, 9)]
    done = ServingLoop(cfg, gpu_p, n_slots=2, max_seq=48).run(
        [Request(i, p, 4) for i, p in enumerate(prompts)])
    got = {c.rid: c.tokens for c in done}
    for i, p in enumerate(prompts):
        lg, st = TM.prefill(cfg, gpu_p, torch.as_tensor(p[None], device=card),
                            cache_len=48)
        tok = lg[:, -1:].argmax(-1)
        want = [int(tok)]
        for j in range(3):
            lg, st = TM.decode_step(cfg, gpu_p, tok, st,
                                    torch.tensor([len(p) + j], device=card))
            tok = lg[:, -1:].argmax(-1)
            want.append(int(tok))
        assert got[i] == want, i


# apply_moe, card vs CPU: (arch, B, S, config fields, x offset); the offset
# gives the tokens a shared direction so that the capacity binds
MOE_CARD_CASES = [
    ("kimi-k2-1t-a32b", 2, 24, {"capacity_factor": 1.25}, 1.0),
    ("arctic-480b", 2, 24, {"capacity_factor": 1.25}, 1.0),
    ("kimi-k2-1t-a32b", 3, 7, {"capacity_factor": 1.25,
                               "moe_group_size": 4}, 1.0),
    ("arctic-480b", 3, 7, {"moe_group_size": 4}, 0.0),
]


@pytest.mark.parametrize("arch,b,s,fields,offset", MOE_CARD_CASES)
def test_apply_moe_on_the_card_matches_the_cpu(card, arch, b, s, fields,
                                               offset):
    """The MoE FFN at a small width (d 128, 8 experts of 64, top 2), fp32,
    with drops (factor 1.25) and padded groups that span sequences: the
    same routing (experts in order, positions, kept slots) on the card as
    on the CPU, the output within 1e-5 and aux within 1e-6, and a second
    call on the card bitwise equal to the first."""
    import dataclasses
    from repro_torch.models import moe
    cfg = dataclasses.replace(TC.get_arch(arch).reduced(), n_experts=8,
                              expert_d_ff=64, **fields)
    p = moe.init_moe(torch.Generator().manual_seed(2), cfg)
    p["router"] = p["router"] * 10.0
    gp = TM.transformer.tree_map(lambda t: t.to(card), p)
    x = offset + torch.randn(b, s, cfg.d_model,
                             generator=torch.Generator().manual_seed(4))
    out_c, aux_c = moe.apply_moe(p, x, cfg)
    out_g, aux_g = moe.apply_moe(gp, x.to(card), cfg)
    again, aux_again = moe.apply_moe(gp, x.to(card), cfg)
    assert torch.equal(out_g, again) and torch.equal(aux_g, aux_again)
    torch.testing.assert_close(out_g.cpu(), out_c, atol=1e-5, rtol=0)
    torch.testing.assert_close(aux_g.cpu(), aux_c, atol=1e-6, rtol=0)
    xg, _ = moe.group_tokens(x, moe.group_size_for(cfg, s))
    r_c = moe.route(p["router"], xg, cfg)
    r_g = moe.route(gp["router"], xg.to(card), cfg)
    for name in ("experts", "pos", "keep"):
        assert torch.equal(getattr(r_g, name).cpu(), getattr(r_c, name)), name
    if fields.get("capacity_factor") == 1.25:
        assert not bool(r_c.keep.all())                 # assignments drop
    if "moe_group_size" in fields:
        assert xg.shape[:2] == (6, 4)                   # 21 tokens, 3 padded


def test_moe_prefill_step_at_kimi_gqa_launches_the_kernel_once_a_layer(card):
    """The reduced kimi (a dense layer, then an MoE layer) at kimi's
    attention geometry, 64 query heads on 8 KV heads of 128, fp32: the
    prefill step launches swa_attention once a layer and the decode step
    never, and both agree with the CPU (atol 1e-4)."""
    import dataclasses
    from repro_torch.launch import make_prefill_step, make_serve_step
    cfg = dataclasses.replace(TC.get_arch("kimi-k2-1t-a32b").reduced(),
                              n_heads=64, n_kv_heads=8, head_dim=128)
    cpu_p = TM.init_params(cfg, seed=1, device="cpu")
    gpu_p = TM.transformer.tree_map(lambda t: t.to(card), cpu_p)
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 40)))
    lg_c, st_c = make_prefill_step(cfg)(cpu_p, {"tokens": toks})
    before = sw.launches
    lg_g, st_g = make_prefill_step(cfg)(gpu_p, {"tokens": toks.to(card)})
    assert sw.launches - before == cfg.n_layers == 2
    torch.testing.assert_close(lg_g.cpu(), lg_c, atol=1e-4, rtol=0)
    # decode steps after a prefill whose caches have room for them
    _, st_c = TM.prefill(cfg, cpu_p, toks, cache_len=43)
    _, st_g = TM.prefill(cfg, gpu_p, toks.to(card), cache_len=43)
    step, tok = make_serve_step(cfg), lg_c.argmax(-1)
    before = sw.launches
    for i in range(3):
        pos = torch.full((2,), 40 + i)
        lg_c, st_c = step(cpu_p, tok, st_c, pos)
        lg_g, st_g = step(gpu_p, tok.to(card), st_g, pos.to(card))
        torch.testing.assert_close(lg_g.cpu(), lg_c, atol=1e-4, rtol=0)
        tok = lg_c.argmax(-1)
    assert sw.launches == before


def test_vlm_on_the_card_matches_the_cpu_port(card):
    """The reduced internvl2-26b at the kernel's head size 128 and its GQA
    group of 6 (12 query heads on 2 KV heads), fp32, 8 patch-embedding rows
    a request: the prefill step with ``patch_embeds`` launches swa_attention
    once a layer and the decode steps from position F + S never, both
    within 1e-4 of the CPU; the loss with the prefix and its gradients (the
    projector's among them) within 1e-4 of the CPU's, the backward kernel
    launched once a layer."""
    import dataclasses
    from repro_torch.launch import make_prefill_step, make_serve_step
    cfg = dataclasses.replace(TC.get_arch("internvl2-26b").reduced(),
                              n_heads=12, n_kv_heads=2, head_dim=128)
    F = cfg.n_frontend_tokens
    cpu_p = TM.init_params(cfg, seed=2, device="cpu")
    gpu_p = TM.transformer.tree_map(lambda t: t.to(card), cpu_p)
    rng = np.random.default_rng(8)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 41)))
    emb = torch.as_tensor(rng.standard_normal((2, F, cfg.d_model)),
                          dtype=torch.float32)
    batch = {"tokens": toks[:, :40], "patch_embeds": emb}
    lg_c, st_c = make_prefill_step(cfg)(cpu_p, batch)
    before = sw.launches
    lg_g, st_g = make_prefill_step(cfg)(gpu_p, {k: v.to(card)
                                                for k, v in batch.items()})
    assert sw.launches - before == cfg.n_layers == 2
    assert st_g["cache"]["k"].shape[2] == F + 40
    torch.testing.assert_close(lg_g.cpu(), lg_c, atol=1e-4, rtol=0)
    step, tok = make_serve_step(cfg), lg_c.argmax(-1)
    before = sw.launches
    for i in range(3):
        pos = torch.full((2,), F + 40 + i)
        lg_c, st_c = step(cpu_p, tok, st_c, pos)
        lg_g, st_g = step(gpu_p, tok.to(card), st_g, pos.to(card))
        torch.testing.assert_close(lg_g.cpu(), lg_c, atol=1e-4, rtol=0)
        tok = lg_c.argmax(-1)
    assert sw.launches == before
    grads = []
    for p, dev in ((cpu_p, "cpu"), (gpu_p, card)):
        leaves = TM.transformer.tree_map(
            lambda t: t.detach().clone().requires_grad_(), p)
        loss = TM.lm_loss(cfg, leaves, {"tokens": toks.to(dev),
                                        "patch_embeds": emb.to(dev)})
        before = swb.launches
        loss.backward()
        if dev == card:
            assert swb.launches - before == cfg.n_layers
        grads.append([float(loss.detach())] + [t.grad.cpu() for t in
                                      TM.transformer.tree_leaves(leaves)])
    assert abs(grads[0][0] - grads[1][0]) <= 1e-4
    for c, g in zip(grads[0][1:], grads[1][1:]):
        torch.testing.assert_close(g, c, atol=1e-4, rtol=0)


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


# --- the async slice (repro_torch.core.async_fed) ----------------------------------

@pytest.mark.parametrize("kind", ["all", "none", "part", "frac"])
@pytest.mark.parametrize("shape", [(7, 9347), (65, 129), (12, 7, 9347),
                                   (4, 4, 33)])
def test_masked_server_step_on_the_card_matches_the_cpu(card, shape, kind):
    """The card's scale_rows (decay_accum: g + (w - 1) g) then row_mean,
    against the plain scaling with the card's row_mean (bitwise, weights in
    {0, 1}) and the CPU (row_mean's 1e-6 of the column's mean |g| plus
    2^-21 of its max |g|); ``denom`` stays on the card; a run with no
    arrival has no finite row."""
    from repro_torch.core import async_fed

    gen = torch.Generator().manual_seed(sum(shape) + len(kind))
    g = torch.randn(shape, generator=gen)
    w = {"all": torch.ones(shape[:-1]), "none": torch.zeros(shape[:-1]),
         "part": (torch.rand(shape[:-1], generator=gen) < 0.5).float(),
         "frac": torch.rand(shape[:-1], generator=gen)}[kind]
    if kind == "part":
        w[..., 0] = 1.0
    row, denom = async_fed.masked_server_step(g.cuda(), w.cuda())
    assert row.is_cuda and denom.is_cuda
    cpu_row, cpu_denom = async_fed.masked_server_step(g, w)
    if kind == "none":
        assert not torch.isfinite(row).any() and not (denom != 0).any()
        return
    m = shape[-2]
    if kind != "frac":
        mine = fu.row_mean_cuda((g.cuda() * w.cuda()[..., None]).contiguous())
        assert torch.equal(row, mine * (m / w.cuda().sum(-1))[..., None])
        assert torch.equal(denom.cpu(), cpu_denom)
    scale = (m / cpu_denom)[..., None]
    tol = 1e-6 * g.abs().mean(-2) * scale + 2.0 ** -21 * g.abs().amax(-2) * scale
    assert ((row.cpu() - cpu_row).abs() <= tol).all()


def _async_cfg(strategy, **kw):
    return FedRLConfig(env=FIGURE_EIGHT, strategy=strategy, eta=5e-3,
                       n_epochs=2, epoch_len=40, minibatch=10, **kw)


def test_zero_delay_async_on_the_card_is_bitwise_periodic(card):
    from repro_torch.core import make_schedule

    per = _async_cfg(make_strategy("periodic", tau=3, m=7))
    zero = _async_cfg(make_strategy("async", tau=3, schedule=make_schedule(
        "deterministic", 0.0, 7, 2, seed=1234)))
    sp, mp, _ = run_fedrl(per, 0, device="cuda")
    sa, ma, _ = run_fedrl(zero, 0, device="cuda")
    for k in mp:
        np.testing.assert_array_equal(ma[k], mp[k], err_msg=k)
    for h in ("pi", "vf"):
        for k in sp[h]:
            assert torch.equal(sa[h][k], sp[h][k]), f"{h}/{k}"


@pytest.mark.parametrize("axis", ["delay", "k"])
def test_async_sweep_on_the_card_matches_its_loop_and_the_cpu(card, axis):
    """A delay (or k) axis batched on the card: bitwise its loop of one-run
    calls, and the card runs' own draws on the CPU within rtol / atol
    1e-4."""
    from repro_torch import sweep
    from repro_torch.core import kofm_schedule, make_schedule
    from repro_torch.rl.fedrl import run_fedrl_batch
    from repro_torch.sweep.runner import _grid_arrays, _run_configs

    if axis == "delay":
        base = make_strategy("async", tau=3, schedule=make_schedule(
            "deterministic", 0.0, 7, 2, seed=1234),
            stale_decay=exponential_decay(0.8))
        points = ((0.0, 1.0), (1.0, 0.5), (2.0, 1.5))
    else:
        base = make_strategy("async", tau=3, schedule=kofm_schedule(
            7, 2, 3, seed=1234))
        points = (1.0, 4.0, 7.0)
    spec = sweep.SweepSpec(name=axis, base=_async_cfg(base), seeds=(0, 1),
                           vmapped=(sweep.SweepAxis(axis, points),))
    res = sweep.run_sweep(spec, device="cuda", warmup=False)
    loop = sweep.run_sweep_loop(spec, device="cuda", warmup=False)
    for k, v in res.metrics["base"].items():
        np.testing.assert_array_equal(v, loop.metrics["base"][k], err_msg=k)
    axis_vals, seeds = _grid_arrays(spec)
    cfgs = _run_configs(spec, spec.base, axis_vals, range(spec.n_runs))
    draws = [replay_of(c, TorchDraws(int(s), "cuda")) for c, s in
             zip(cfgs, seeds)]
    _, want, _ = run_fedrl_batch(cfgs, draws, device="cpu")
    for k, v in want.items():
        np.testing.assert_allclose(res.metrics["base"][k].reshape(v.shape), v,
                                   rtol=1e-4, atol=1e-4, err_msg=k)


# --- slice 12: the task-generic FMARL driver and the hierarchical step -------------

def _ac_tree(m=None, gen=None, device="cpu"):
    """The 6-64-64 actor-critic's layout (n = 9,347): its seeded parameters,
    or with ``m`` an ``(m, ...)`` tree of normal draws from ``gen``."""
    from repro_torch.rl.env import OBS_DIM

    pol = init_policy(OBS_DIM, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    tree = {h: {k: v.detach().clone() for k, v in pol[h].items()}
            for h in ("pi", "vf")}
    if m is None:
        return tree
    return {h: {k: torch.randn((m,) + tuple(v.shape), generator=gen,
                               device=device) for k, v in tree[h].items()}
            for h in tree}


@pytest.mark.parametrize("period", [0, 1])
def test_hierarchical_server_average_on_the_card(card, period):
    """(1024, 9347): the cluster mean (clusters of 32) is one
    consensus_step launch, the global mean one row_mean launch, each within
    rtol 1e-6 of float64 (of max |x|; row_mean: of the column's mean |x|)
    and of the same call on the CPU."""
    from repro_torch.core import HierarchicalStrategy

    m = 1024
    hs = HierarchicalStrategy(tau=2, clusters=[range(c, c + 32) for c in
                                               range(0, m, 32)],
                              global_every=2)
    tree = _ac_tree(m, torch.Generator(device="cuda").manual_seed(5), "cuda")
    flat, spec = dispatch.stacked_ravel_spec(tree)
    before = (cs.launches, fu.launches["row_mean"])
    got = spec.ravel(hs.server_average(tree, period_idx=period))
    after = (cs.launches, fu.launches["row_mean"])
    assert (after[0] - before[0], after[1] - before[1]) == \
        ((1, 0) if period == 0 else (0, 1))
    cpu_tree = {h: {k: v.cpu() for k, v in tree[h].items()} for h in tree}
    cpu = spec.ravel(hs.server_average(cpu_tree, period_idx=period))
    if period == 0:
        p = torch.tensor(hs.cluster_mean_matrix(), dtype=torch.float64)
        want = p @ flat.cpu().double()
        tol = 1e-6 * float(flat.abs().max())
    else:
        want = flat.cpu().double().mean(0).expand(m, -1)
        tol = (1e-6 * flat.abs().mean(0).cpu().double()
               + 2.0 ** -23 * want[0].abs())
    for x in (got.cpu(), cpu):
        assert ((x.double() - want).abs() <= tol).all()


def test_full_width_run_fmarl_card_matches_cpu(card):
    """run_fmarl at m = 1024 on the actor-critic's layout, decay (tau_i in
    {1, 2}) with momentum, 2 periods of tau = 2, on replayed host draws: the
    card's per-period metrics within rtol 1e-4 of the CPU's, the server
    parameters within atol 1e-4, the ledgers equal."""
    from repro_torch.core import FmarlConfig, run_fmarl

    m = 1024
    tree = _ac_tree()
    pool = {"cpu": _ac_tree(m, torch.Generator().manual_seed(7))}
    pool["cuda"] = {h: {k: v.cuda() for k, v in pool["cpu"][h].items()}
                    for h in pool["cpu"]}

    def grad_fn_on(dev):
        def grad_fn(params_m, agent_ids, step, gen):
            z = pool[dev]
            g = {h: {k: v + 0.05 * (1.0 + step) * z[h][k]
                     for k, v in params_m[h].items()} for h in params_m}
            loss = sum(torch.sum(v * v, dim=tuple(range(1, v.ndim)))
                       for h in params_m for v in params_m[h].values())
            return g, {"loss": loss}
        return grad_fn

    cfg = FmarlConfig(strategy=make_strategy(
        "decay", tau=2, taus=uniform_taus(1, 2, m),
        decay=exponential_decay(0.9)), eta=0.05, n_periods=2,
        optimizer=flat_momentum(0.9))
    runs = {dev: run_fmarl(cfg, tree, grad_fn_on(dev), 0, lambda p, g: p,
                           device=dev) for dev in ("cuda", "cpu")}
    (gs, gm, gl), (cs_, cm, cl) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(gm["server_grad_sq_norm"],
                               cm["server_grad_sq_norm"], rtol=1e-4)
    np.testing.assert_allclose(gm["mean_aux"]["loss"], cm["mean_aux"]["loss"],
                               rtol=1e-4)
    for h in ("pi", "vf"):
        for k in cs_.server_params[h]:
            np.testing.assert_allclose(gs.server_params[h][k].cpu().numpy(),
                                       cs_.server_params[h][k].numpy(),
                                       rtol=0, atol=1e-4)
    assert gl.table_row() == cl.table_row()


# --- the attention backward (slice 13) -------------------------------------------

BWD_REL = 1e-5                 # fp32: within BWD_REL x the largest |grad|
BWD_MAX_RATIO, BWD_MEAN_RATIO, BWD_FLOOR = 2.0, 1.1, 1e-6


def _bwd_case(b, s, h, kv, d, dtype, seed, device, sk=None):
    """q and do ``(b, s, h, d)``, k and v ``(b, sk, kv, d)`` (sk default
    s), standard normal."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *sh: torch.randn(sh, generator=gen, device=device).to(dtype)
    sk = s if sk is None else sk
    return rnd(b, s, h, d), rnd(b, sk, kv, d), rnd(b, sk, kv, d), \
        rnd(b, s, h, d)


def _check_bwd_kernel(b, s, h, kv, d, window, dtype, seed, card, sk=None,
                      causal=True):
    """The forward's lse within 1e-5 (relative, at least 1) of the plain
    version's; the backward on the kernel forward's o and lse: fp32 within
    1e-5 of the largest |gradient| of the plain backward, bf16 against the
    float64 gradient within 2x / 1.1x the plain bf16 backward's largest /
    mean error (+ 1e-6 of the largest |gradient|: with W = 1, dq and dk are
    0 up to rounding); one launch a call, and a second call the same bits.
    ``sk`` keys (default s) against the s query rows, masked or not by
    ``causal``."""
    q, k, v, do = _bwd_case(b, s, h, kv, d, dtype, seed, card, sk)
    kw = dict(window=window, causal=causal)
    o, lse = sw.swa_attention_cuda(q, k, v, with_lse=True, **kw)
    assert torch.equal(o, sw.swa_attention_cuda(q, k, v, **kw))
    _, plse = sw.swa_attention_plain(q, k, v, with_lse=True, **kw)
    assert float(((lse - plse).abs() / plse.abs().clamp(min=1.0)).max()) <= 1e-5
    before = swb.launches
    got = swb.swa_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    again = swb.swa_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert swb.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert [t.dtype for t in got] == [dtype] * 3
    plain = swb.swa_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    if dtype == torch.float32:
        G = max(float(p.abs().max()) for p in plain)
        for x, p in zip(got, plain):
            assert float((x - p).abs().max()) <= BWD_REL * G
        return
    x64 = [t.double() for t in (q, k, v, do)]
    o64, lse64 = sw.swa_attention_plain(*x64[:3], with_lse=True, **kw)
    want = swb.swa_attention_bwd_plain(*x64[:3], o64, x64[3], lse64, **kw)
    G = max(float(w.abs().max()) for w in want)
    for x, p, w in zip(got, plain, want):
        ex, ep = (x.double() - w).abs(), (p.double() - w).abs()
        assert float(ex.max()) <= BWD_MAX_RATIO * float(ep.max()) + BWD_FLOOR * G
        assert float(ex.mean()) <= BWD_MEAN_RATIO * float(ep.mean()) + \
            BWD_FLOOR * G


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("window", [None, 1, 64, 4096])
@pytest.mark.parametrize("b,s,h,kv,d", [
    (1, 1, 32, 8, 120), (1, 127, 32, 8, 120), (1, 1024, 24, 8, 128),
    (2, 300, 24, 8, 128), (2, 1024, 32, 8, 120)])
def test_swa_attention_bwd_kernel_matches_plain(card, b, s, h, kv, d, window,
                                                dtype):
    """See ``_check_bwd_kernel``."""
    _check_bwd_kernel(b, s, h, kv, d, window, dtype, s + h + (window or 0),
                      card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,s,h,kv,d,window", [
    (1, 129, 8, 8, 120, 100), (1, 255, 8, 8, 128, 200),
    (1, 129, 24, 8, 128, 200), (1, 255, 32, 8, 120, 100),
    (2, 200, 12, 4, 120, 100), (1, 65, 4, 4, 128, None)])
def test_swa_attention_bwd_kernel_at_tile_edges(card, b, s, h, kv, d, window,
                                                dtype):
    """``_check_bwd_kernel`` where the 64- and 128-row tiles of the bf16
    kernels end ragged (S 65, 129, 200, 255), a window crosses a tile (W
    100, 200), and H = KV, for both head sizes."""
    _check_bwd_kernel(b, s, h, kv, d, window, dtype, 7 * s + h, card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,s", [(2, 768), (1, 756), (2, 1024)])
def test_swa_attention_bwd_kernel_at_vlm_gqa(card, b, s, dtype):
    """``_check_bwd_kernel`` at D = 128 with internvl2-26b's 48 query heads
    on 8 KV heads (a group of 6), causal, no window: prefix + tokens on the
    128-row tile (768), off it (756), and the training step's (2, 1024)."""
    _check_bwd_kernel(b, s, 48, 8, 128, None, dtype, 13 * s + b, card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kv", [1, 16])
@pytest.mark.parametrize("window", [None, 2048, 40])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 200])
def test_swa_attention_bwd_kernel_matches_plain_at_d256(card, s, window, kv,
                                                        dtype):
    """``_check_bwd_kernel`` at D = 256 on phase 20's grid: 16 query heads
    on 1 (recurrentgemma-9b) or 16 (gemma-7b) KV heads, the 64-row tile
    edges, no window, recurrentgemma's 2048 and one that crosses tiles."""
    _check_bwd_kernel(1, s, 16, kv, 256, window, dtype, 11 * s + kv, card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kv,window", [(16, None), (1, 2048)],
                         ids=["gemma-7b", "recurrentgemma-9b"])
def test_swa_attention_bwd_kernel_matches_plain_at_d256_training_shapes(
        card, kv, window, dtype):
    """``_check_bwd_kernel`` at D = 256 at the training steps' shapes of
    phase 20 (B 2, S 1024: 16 q / k tiles, a second batch row): gemma-7b's
    16 / 16 heads, recurrentgemma-9b's 16 / 1 with W 2048."""
    _check_bwd_kernel(2, 1024, 16, kv, 256, window, dtype, 1024 + kv, card)


# (B, Sq, Sk, H, KV, causal) at D = 64: whisper-small's training shapes
# (the encoder's 1500 x 1500 and the cross-attention's 448 x 1500, non-causal;
# the decoder's 448 x 448, causal), lengths at the 64- and 128-row tile
# edges both ways round, one row or one key, GQA 8 / 4 beside 12 / 12
D64_BWD_CASES = [
    (2, 1500, 1500, 12, 12, False), (2, 448, 1500, 12, 12, False),
    (2, 448, 448, 12, 12, True), (1, 1, 1500, 12, 12, False),
    (1, 1500, 1, 12, 12, False), (1, 63, 65, 12, 12, False),
    (1, 65, 63, 12, 12, False), (1, 129, 448, 8, 4, False),
    (1, 448, 129, 8, 4, False), (1, 1500, 448, 12, 12, False),
    (1, 65, 129, 8, 4, True), (1, 129, 65, 8, 4, True),
    (1, 63, 63, 8, 4, True), (1, 1, 1, 12, 12, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,sq,sk,h,kv,causal", D64_BWD_CASES)
def test_swa_attention_bwd_kernel_matches_plain_at_d64(card, b, sq, sk, h, kv,
                                                       causal, dtype):
    """``_check_bwd_kernel`` at D = 64 (the one 64-column box, m64n64
    accumulators), causal on and off, Sq and Sk apart and ragged."""
    _check_bwd_kernel(b, sq, h, kv, 64, None, dtype, 13 * sq + sk + kv, card,
                      sk=sk, causal=causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,sq,sk,h,kv,d", [
    (1, 129, 300, 8, 4, 120), (2, 300, 129, 8, 8, 128),
    (1, 200, 65, 16, 1, 256)])
def test_swa_attention_bwd_kernel_non_causal_with_sq_ne_sk(card, b, sq, sk, h,
                                                           kv, d, dtype):
    """``_check_bwd_kernel`` with the mask off and Sq != Sk at the other
    head sizes: every key tile of every query tile, both walks ragged."""
    _check_bwd_kernel(b, sq, h, kv, d, None, dtype, 17 * sq + sk, card, sk=sk,
                      causal=False)


# (B, T, H, nonzero s0, nonzero dL/dS_T): phase 20's shapes
@pytest.mark.parametrize("b,t,h,s_on,g_on", [
    (1, 37, 2, True, True), (2, 16, 3, False, True), (1, 1, 4, True, False),
    (3, 100, 1, True, True), (2, 1024, 32, True, True),
    (1, 31, 2, True, True), (2, 32, 2, True, True), (1, 33, 3, True, True),
    (1, 20, 1, True, True), (1, 1, 1, True, True), (2, 131, 2, True, True),
    (1, 200, 2, False, True)])
def test_wkv6_bwd_kernel_matches_plain(card, b, t, h, s_on, g_on):
    """wkv6_bwd against wkv6_bwd_plain: each gradient within 1e-5 of its
    largest |plain value| (fp32, summation order), one count a call, a
    second call the same bits; T on and off the kernel's 32-step chunks
    and 4-step sub-chunks (31, 32, 33), one block (B H = 1) under one chunk
    and at one step, ragged last chunks (131, 200)."""
    gen = torch.Generator(device=card).manual_seed(31 * t + h)
    rnd = lambda *sh: torch.randn(sh, generator=gen, device=card)
    r, k, v, dy = (rnd(b, t, h, 64) for _ in range(4))
    w = torch.exp(-torch.exp(0.5 * rnd(b, t, h, 64)))
    u = 0.5 * rnd(h, 64)
    s0 = 0.1 * rnd(b, h, 64, 64) if s_on else torch.zeros(b, h, 64, 64,
                                                           device=card)
    dsT = 0.1 * rnd(b, h, 64, 64) if g_on else None
    before = wk.bwd_launches
    got = wk.wkv6_bwd_cuda(r, k, v, w, u, s0, dy, dsT)
    again = wk.wkv6_bwd_cuda(r, k, v, w, u, s0, dy, dsT)
    torch.cuda.synchronize()
    assert wk.bwd_launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    plain = wk.wkv6_bwd_plain(r, k, v, w, u, s0, dy, dsT)
    for x, p in zip(got, plain):
        assert x.shape == p.shape and x.dtype == torch.float32
        assert float((x - p).abs().max()) <= 1e-5 * float(p.abs().max())


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-1.6b"])
def test_recurrent_lm_trains_on_the_card_as_on_the_cpu(card, arch):
    """Reduced recurrentgemma-9b (head 256, window 8) and rwkv6-1.6b in
    fp32, remat on: the loss and every gradient on the card (the
    swa_attention / wkv6 forward and backward kernels) against the CPU
    port's (plain versions): loss atol 1e-4, each gradient within 1e-4 of
    its leaf's largest |value| (fp32 in other summation orders)."""
    import dataclasses
    kw = dict(param_dtype="float32", compute_dtype="float32", remat=True)
    if arch == "recurrentgemma-9b":
        kw.update(n_layers=5, n_heads=4, n_kv_heads=1, head_dim=256,
                  sliding_window=8)
    cfg = dataclasses.replace(TC.get_arch(arch).reduced(), **kw)
    params = TM.init_params(cfg, seed=2, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40)))
    out = {}
    for dev in ("cpu", card):
        leaves = TM.transformer.tree_map(
            lambda t: t.detach().to(dev, copy=True).requires_grad_(), params)
        before = (swb.launches, wk.bwd_launches)
        loss = TM.lm_loss(cfg, leaves, {"tokens": toks.to(dev)})
        loss.backward()
        out[str(dev)] = (float(loss.detach()), [t.grad.cpu() for t in
                                       TM.transformer.tree_leaves(leaves)])
        launched = (swb.launches - before[0], wk.bwd_launches - before[1])
    n = sum(cfg.block_kind(i) in ("attn", "local", "wkv")
            for i in range(cfg.n_layers))
    assert sum(launched) == n
    (lc, gc), (lg, gg) = out["cpu"], out[str(card)]
    assert abs(lc - lg) <= 1e-4
    for x, y in zip(gg, gc):
        assert float((x - y).abs().max()) <= 1e-4 * max(float(y.abs().max()),
                                                        1e-30)


def test_swa_attention_bwd_kernel_refuses_what_it_does_not_take(card):
    q, k, v, do = _bwd_case(1, 8, 4, 2, 120, torch.float32, 0, card)
    o, lse = sw.swa_attention_cuda(q, k, v, with_lse=True)
    with pytest.raises(ValueError,
                       match=r"head sizes \(64, 120, 128, 256\), got 32"):
        swb.swa_attention_bwd_cuda(*(t[..., :32].contiguous()
                                     for t in (q, k, v, o, do)), lse)
    with pytest.raises(TypeError):
        swb.swa_attention_bwd_cuda(q, k, v, o, do, lse.double())
    with pytest.raises(ValueError, match="contiguous"):
        swb.swa_attention_bwd_cuda(q, k, v, o, do.transpose(1, 2).contiguous()
                                   .transpose(1, 2), lse)
    with pytest.raises(ValueError, match="lse must be"):
        swb.swa_attention_bwd_cuda(q, k, v, o, do, lse[:, :, :4])


def test_full_width_lm_step_leaves_the_agent_rows_equal_after_sync(card):
    """h2o-danube-3-4b at its published width cut to 2 layers, 2 agents
    (their data differ), bf16: one local step and a periodic sync through
    the kernels (2 agents x 2 layers x 2 forwards under remat, x 1
    backward; one adam_update, one row_mean), then the rows bitwise
    equal."""
    import dataclasses
    from repro_torch.launch import (FedTrainConfig, init_train_state,
                                    make_local_step, make_sync_step)
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(TC.get_arch("h2o-danube-3-4b"), n_layers=2)
    fed = FedTrainConfig(strategy="periodic", tau=1)
    opt = adamw(weight_decay=0.01)
    st = init_train_state(cfg, 0, 2, opt, fed, device=card)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 1, 129)), device=card)
    f0, b0, a0, r0 = sw.launches, swb.launches, fu.launches["adam_update"], \
        fu.launches["row_mean"]
    st, m = make_local_step(cfg, opt, fed, n_agents=2)(st, {"tokens": toks})
    assert not torch.equal(st.params[0], st.params[1])
    st = make_sync_step(cfg, fed, n_agents=2)(st)
    torch.cuda.synchronize()
    assert (sw.launches - f0, swb.launches - b0) == (8, 4)
    assert (fu.launches["adam_update"] - a0, fu.launches["row_mean"] - r0) \
        == (1, 1)
    assert bool(torch.isfinite(m["loss"])) and torch.equal(st.params[0],
                                                           st.params[1])
