"""Port parity: consensus gossip, its tables and its strategy on the CPU.

The same numpy inputs go through the JAX package (``backend="jnp"``, and
``backend="interpret"``: the Pallas kernel bodies on the CPU) and through
the port on CPU tensors, which runs the plain PyTorch versions of the
``consensus_step`` and ``consensus_gather`` kernels. Tolerances:

* ``consensus_mix`` (a matmul; the two frameworks sum in different orders):
  ``|port - jax| <= m * 2^-23 * (|P| @ |G32|)`` elementwise, plus one ulp
  of the output dtype at the output's magnitude;
* ``consensus_gather``: against eager ``jnp`` bitwise (the same separately
  rounded fp32 products and sums in ascending k); against ``interpret`` 4
  ulp of the output's dtype at its largest magnitude (the Pallas body may
  contract ``acc + w*g`` into an FMA);
* inside the port, bitwise: the sparse transform equals mask + E full-list
  gathers, padding slots contribute exactly nothing, and the gather over
  the full list 0..m-1 is a numpy fp32 ascending-l chain; dense against
  sparse within atol 1e-5 (as ``tests/test_sparse_consensus.py`` holds it);
* tables (``p``, ``p_e``, ``p_e_masked``, ``p_masked``, the neighbour list,
  ``nl_w``) identical; ledgers and bytes curves equal at rtol 0;
* the strategy's local step (every form x SGD / momentum / Adam) after
  each of several period offsets: rtol 1e-6, atol 1e-7 (the dense mix sums
  in another order; Adam divides by sqrt(nu)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consensus as jcons
from repro.core import strategies as jstrat
from repro.core import topology as J
from repro.core.accounting import CostLedger as JLedger
from repro.kernels import dispatch as jd
from repro.optim.flat import flat_adam as jadam
from repro.optim.flat import flat_momentum as jmom
from repro.rl import FIGURE_EIGHT as JF8
from repro.rl import fedrl as jfed
from repro_torch.core import accounting as tacc
from repro_torch.core import consensus as tcons
from repro_torch.core import strategies as tstrat
from repro_torch.core import topology as T
from repro_torch.kernels import consensus_gather as tcg
from repro_torch.kernels import dispatch as td
from repro_torch.optim import flat_adam, flat_momentum
from repro_torch.rl import FIGURE_EIGHT as TF8
from repro_torch.rl import fedrl as tfed

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _arr(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _mix_case(m, n, seed):
    topo = J.random_regularish(m, 3, 4, seed)
    p = np.linalg.matrix_power(J.mixing_matrix(topo, 0.9 / topo.max_degree),
                               2).astype(np.float32)
    return p, _arr((m, n), seed + 1)


# --- primitives -------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["jnp", "interpret"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m, n", [(7, 257), (16, 33), (1, 5)])
def test_consensus_mix_matches_jax(m, n, dtype, backend):
    jdt, tdt = DTYPES[dtype]
    p, g = _mix_case(max(m, 3), n, m)
    p, g = p[:m, :m], g[:m]
    gj = jnp.asarray(g).astype(jdt)
    want = jd.consensus_mix(gj, jnp.asarray(p), backend=backend, block_n=128)
    got = td.consensus_mix(torch.tensor(g).to(tdt), torch.tensor(p))
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    g32 = _np(gj)
    bound = m * 2.0 ** -23 * (np.abs(p) @ np.abs(g32))
    eps = float(jnp.finfo(jdt).eps)
    err = np.abs(_np(got) - _np(want))
    assert np.all(err <= bound + eps * np.abs(_np(want)) + 1e-30), err.max()


def _nl_case(m, n, seed, k_max=None):
    topo = J.knn_ring(m, 4)
    nl = J.neighbor_list(topo, k_max)
    w = J.neighbor_weights(nl, 0.5 / topo.max_degree)
    return nl, np.array(w), _arr((m, n), seed)


@pytest.mark.parametrize("backend", ["jnp", "interpret"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k_max", [None, 9])
def test_consensus_gather_matches_jax(dtype, backend, k_max):
    jdt, tdt = DTYPES[dtype]
    nl, w, g = _nl_case(16, 257, 3, k_max)
    gj = jnp.asarray(g).astype(jdt)
    with jax.disable_jit(backend == "jnp"):
        want = jd.consensus_gather(gj, nl.idx, w, backend=backend, block_n=128)
    got = td.consensus_gather(torch.tensor(g).to(tdt), torch.tensor(nl.idx),
                              torch.tensor(w))
    assert got.dtype == tdt and tuple(got.shape) == g.shape
    if backend == "jnp":
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        eps = float(jnp.finfo(jdt).eps)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=4 * eps * np.abs(_np(want)).max())


def _raises_both(match, jfn, tfn):
    with pytest.raises(ValueError, match=match):
        jfn()
    with pytest.raises(ValueError, match=match):
        tfn()


def test_same_validation_errors():
    p, g = _mix_case(5, 8, 0)
    jg, tg = jnp.asarray(g), torch.tensor(g)
    _raises_both(r"consensus_mix: g must be \(m, n\), got \(8,\)",
                 lambda: jd.consensus_mix(jg[0], p, backend="jnp"),
                 lambda: td.consensus_mix(tg[0], torch.tensor(p)))
    _raises_both(r"consensus_mix: mixing must be \(5, 5\) for g \(5, 8\), "
                 r"got \(4, 4\)",
                 lambda: jd.consensus_mix(jg, p[:4, :4], backend="jnp"),
                 lambda: td.consensus_mix(tg, torch.tensor(p[:4, :4])))
    nl, w, _ = _nl_case(5, 8, 0)
    _raises_both(r"consensus_gather: idx must be an \(m, k_max\) integer array",
                 lambda: jd.consensus_gather(jg, w, w, backend="jnp"),
                 lambda: td.consensus_gather(tg, torch.tensor(w),
                                             torch.tensor(w)))
    _raises_both(r"consensus_gather: idx must be \(5, k_max\) for g \(5, 8\)",
                 lambda: jd.consensus_gather(jg, nl.idx[:4], w[:4],
                                             backend="jnp"),
                 lambda: td.consensus_gather(tg, nl.idx[:4], w[:4]))
    _raises_both(r"consensus_gather: w must match idx \(5, 5\), got \(5, 4\)",
                 lambda: jd.consensus_gather(jg, nl.idx, w[:, :4],
                                             backend="jnp"),
                 lambda: td.consensus_gather(tg, nl.idx, w[:, :4]))
    with pytest.raises(ValueError, match=r"rows must lie in \[0, 5\)"):
        td.consensus_gather(tg, nl.idx + 1, w)
    for fn in (lambda: td.consensus_mix(tg[None], torch.tensor(p)),
               lambda: td.consensus_gather(tg[None], nl.idx, w)):
        with pytest.raises(NotImplementedError, match="sweep"):
            fn()


# --- bitwise contracts inside the port ---------------------------------------------

def _mix(strat, g, offset):
    """The strategy's masked gossip of ``g`` at ``offset``, in new buffers."""
    return strat._transform(g, offset, (torch.empty_like(g), torch.empty_like(g)))


def _tpair(topo, *, tau=3, rounds=1, taus=None):
    eps = 0.5 / topo.max_degree
    kw = dict(tau=tau, topo=topo, eps=eps, rounds=rounds, taus=taus)
    return (tstrat.ConsensusStrategy(sparse=False, **kw),
            tstrat.ConsensusStrategy(sparse=True, **kw))


@pytest.mark.parametrize("rounds", [1, 2, 3])
def test_sparse_transform_is_mask_then_full_list_gathers_bitwise(rounds):
    topo = T.knn_ring(16, 4)
    dense, sp = _tpair(topo, rounds=rounds, taus=np.repeat([3, 2, 1], [6, 5, 5]))
    full = T.neighbor_list(topo, k_max=topo.m)
    p64, _, _ = tstrat.mixing_powers(topo, sp.eps, rounds, need_power=False)
    w_full = torch.tensor(T.neighbor_weights_from_matrix(full, p64))
    g = torch.tensor(_arr((16, 37), rounds))
    for offset in range(3):
        got = _mix(sp, g, offset)
        ref = td.scale_rows(g, sp.weight(offset))
        for _ in range(rounds):
            ref = td.consensus_gather(ref, full.idx, w_full)
        assert torch.equal(got, ref)
        # dense against sparse
        np.testing.assert_allclose(_mix(dense, g, offset).numpy(),
                                   got.numpy(), atol=1e-5)


def test_padding_contributes_exactly_zero():
    nl_tight, w, g = _nl_case(16, 37, 5)
    nl_pad, w_pad, _ = _nl_case(16, 37, 5, k_max=12)
    g = torch.tensor(g)
    a = td.consensus_gather(g, nl_tight.idx, w)
    b = td.consensus_gather(g, nl_pad.idx, w_pad)
    assert torch.equal(a, b)
    assert np.all(w_pad[~nl_pad.valid] == 0.0)


@pytest.mark.parametrize("m", [1, 7, 33, 129])
def test_full_list_gather_is_the_ascending_l_chain_bitwise(m):
    """The chain the dense consensus_step kernel must reproduce on the card
    (every output one fp32 chain acc = -0.0, acc = acc + P[i, l] * G[l, j] in
    ascending l, each product and sum rounded once) is, bit for bit, the
    plain gather over the full list 0..m-1 with P's entries as weights. P
    holds exact zeros, which add a signed zero and so change nothing."""
    rng = np.random.default_rng(m)
    p = rng.uniform(0.0, 2.0 / m, (m, m)).astype(np.float32)
    p[rng.uniform(size=(m, m)) < 0.3] = 0.0
    g = _arr((m, 37), m + 1)
    acc = np.full((m, 37), -0.0, dtype=np.float32)
    for l in range(m):
        acc = acc + p[:, l:l + 1] * g[l:l + 1, :]
    assert acc.dtype == np.float32
    idx = torch.arange(m, dtype=torch.int32).repeat(m, 1)
    got = tcg.consensus_gather_plain(torch.tensor(g), idx, torch.tensor(p))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  acc.view(np.uint32))


# --- the staged gather kernel's host plan and de-duplication -------------------------
#
# consensus_gather_cuda picks its kernel, row group, grid and shared memory
# by shape alone (gather_plan, which mirrors csrc/consensus_gather.cu); the
# staged kernel de-duplicates each group's slots on the device. Both are
# held here on the CPU: the plan at the consensus path's shapes and at the
# switch between the kernels, and a numpy model of the de-duplication, whose
# gather must be the plain version bit for bit (only where an operand is read
# from changes, never the arithmetic).

H100_SMS = 132
H100_SMEM_PER_SM = 228 * 1024     # shared memory an SM holds
BLOCK_RESERVED_SMEM = 1024        # what the runtime keeps of it per block


@pytest.mark.parametrize("m, n, k_max, itemsize, want", [
    # the consensus path: knn_ring(1024, 8) (64 groups, 4 blocks a group),
    # the 10k ring (625 groups: one wave of runs), knn_ring(64, 4) (below
    # MIN_STAGED_ROWS: the row kernel)
    (1024, 9347, 9, 4, ("staged", 16, 128, 256, 98304)),
    (1024, 9347, 9, 2, ("staged", 16, 256, 256, 98304)),
    (10000, 9347, 9, 4, ("staged", 16, 128, 264, 98304)),
    (64, 9347, 5, 4, ("rows", 0, 1024, 640, 0)),
    (64, 9347, 5, 2, ("rows", 0, 1024, 640, 0)),
    # the switch in m: 16 groups of 16 rows, 16 blocks a group
    (255, 9347, 9, 4, ("rows", 0, 1024, 2550, 0)),
    (256, 9347, 9, 4, ("staged", 16, 128, 256, 98304)),
    # the switch in k_max (one row a group, one stage of 186 rows fits)
    (256, 9347, 186, 4, ("staged", 1, 128, 256, 98304)),
    (256, 9347, 186, 2, ("staged", 1, 256, 256, 98304)),
    (256, 9347, 187, 4, ("rows", 0, 1024, 2560, 0)),
    # the full list at m = 1025
    (1025, 9347, 1025, 4, ("rows", 0, 1024, 1025 * 10, 0)),
    # a group of 256 rows only where k_max = 1: a ring of 8 stages of them
    (300, 9347, 1, 4, ("staged", 16, 128, 19 * 13, 8 * 16 * 528)),
])
def test_gather_plan_picks_the_kernel_and_its_shared_memory(m, n, k_max,
                                                            itemsize, want):
    plan = tcg.gather_plan(m, n, k_max, itemsize, H100_SMS)
    assert (plan.kernel, plan.rows, plan.tile_cols, plan.blocks,
            plan.ring_bytes) == want
    if plan.kernel == "rows":
        assert m < tcg.MIN_STAGED_ROWS or k_max > tcg.MAX_SLOTS
        assert plan.smem_bytes == 2048
        return
    assert plan.rows * k_max <= tcg.MAX_SLOTS and plan.tile_cols * itemsize == 512
    u_max = min(plan.rows * k_max, m)          # source rows a group can need
    assert u_max * tcg.ROW_BYTES <= plan.ring_bytes <= tcg.RING_CAP
    assert plan.smem_bytes == plan.ring_bytes + tcg.STATIC_SMEM
    # BLOCKS_PER_SM blocks of the largest ring fit an SM of the card
    assert tcg.BLOCKS_PER_SM * (tcg.RING_CAP + tcg.STATIC_SMEM
                                + BLOCK_RESERVED_SMEM) <= H100_SMEM_PER_SM
    assert plan.blocks <= tcg.BLOCKS_PER_SM * H100_SMS


def _dedup(slots: np.ndarray):
    """The staged kernel's de-duplication of a group's slots: each slot
    finds its first occurrence, a prefix sum numbers the first occurrences,
    and every slot maps to its first occurrence's number. Returns the unique
    source rows (in the order they first appear) and each slot's place."""
    first = np.array([int(np.flatnonzero(slots[:s + 1] == v)[0])
                      for s, v in enumerate(slots)])
    is_first = first == np.arange(slots.size)
    pos = np.cumsum(is_first) - 1
    return slots[is_first], pos[first]


def _staged_gather_model(g32: np.ndarray, idx: np.ndarray, w: np.ndarray,
                         rows: int) -> np.ndarray:
    """The plain gather read through ``_dedup``: each group of ``rows``
    output rows stages its unique source rows once and reads every slot's
    operand from there, in the plain version's fp32 chain."""
    m, k_max = idx.shape
    out = np.empty_like(g32)
    for i0 in range(0, m, rows):
        grp = idx[i0:i0 + rows]
        unique, place = _dedup(grp.ravel())
        staged = g32[unique]
        place = place.reshape(grp.shape)
        acc = np.full((grp.shape[0], g32.shape[1]), -0.0, np.float32)
        for k in range(k_max):
            acc = acc + w[i0:i0 + rows, k:k + 1] * staged[place[:, k]]
        out[i0:i0 + rows] = acc
    return out


def _gather_lists():
    """(neighbour list idx, weights) the staged kernel is held at on the
    card: a k-NN ring, a random list, a padded one, the full list."""
    ring = T.neighbor_list(T.knn_ring(64, 4))
    rand = T.neighbor_list(T.random_regularish(40, 3, 5, 2))
    pad = T.neighbor_list(T.random_regularish(40, 3, 5, 2),
                          k_max=rand.k_max + 3)
    full = np.tile(np.arange(33, dtype=np.int32), (33, 1))
    p = np.random.default_rng(33).uniform(0, 2 / 33, (33, 33))
    return {"knn_ring(64,4)": (ring.idx, T.neighbor_weights(ring, 0.1)),
            "rand3-5(40)": (rand.idx, T.neighbor_weights(rand, 0.08)),
            "rand3-5(40) padded": (pad.idx, T.neighbor_weights(pad, 0.08)),
            "full(33)": (full, p.astype(np.float32))}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(_gather_lists()))
def test_staged_gather_model_is_the_plain_gather_bitwise(case, dtype):
    idx, w = _gather_lists()[case]
    m, k_max = idx.shape
    tdt = DTYPES[dtype][1]
    rows = tcg.staged_plan(m, 37, k_max, tdt.itemsize, H100_SMS).rows
    g = torch.tensor(_arr((m, 37), m)).to(tdt)
    want = tcg.consensus_gather_plain(g, torch.tensor(idx), torch.tensor(w))
    got = _staged_gather_model(g.float().numpy(), idx, w, rows)
    assert torch.equal(torch.tensor(got).to(tdt), want)
    # each group stages every source row once: a k-NN ring's interior group
    # needs rows + k_max - 1 of them, the full list m
    unique, place = _dedup(idx[rows:2 * rows].ravel())
    assert np.array_equal(unique[place], idx[rows:2 * rows].ravel())
    assert len(set(unique.tolist())) == unique.size
    if case == "knn_ring(64,4)":
        assert unique.size == rows + k_max - 1
    if case == "full(33)":
        assert unique.size == m


# --- tables, the power cache, auto-selection ---------------------------------------

@pytest.mark.parametrize("form", ["dense", "unfused", "sparse"])
def test_tables_are_identical_to_jax(form):
    kw = {"dense": dict(rounds=2), "unfused": dict(rounds=3, fused=False),
          "sparse": dict(rounds=2, sparse=True)}[form]
    taus = np.array([4, 4, 3, 3, 3, 2, 2, 1, 1])
    jt, tt = J.random_regularish(9, 3, 4, 1), T.random_regularish(9, 3, 4, 1)
    js = jstrat.make_strategy("consensus", tau=4, topo=jt, eps=0.12, taus=taus,
                              **kw)
    ts = tstrat.make_strategy("consensus", tau=4, topo=tt, eps=0.12, taus=taus,
                              **kw)
    assert ts.name == js.name and ts.sparse == js.sparse
    for f in ("mask", "p", "p_e", "p_e_masked", "p_masked", "nl_w"):
        a, b = getattr(ts, f), getattr(js, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    if ts.sparse:
        np.testing.assert_array_equal(ts.nl.idx, js.nl.idx)
    for off in range(4):
        np.testing.assert_array_equal(ts.weight(off).numpy(),
                                      np.asarray(js.weight(off)))
        assert ts.comm_events_partial_period(off) == \
            js.comm_events_partial_period(off)
    assert ts.comm_events_per_period() == js.comm_events_per_period()


def test_power_cache_hits_are_the_same_objects_lazy_and_bounded():
    tstrat.clear_power_cache()
    topo = T.knn_ring(12, 4)
    p64, p, pe = tstrat.mixing_powers(topo, 0.1, 3, need_power=False)
    assert pe is None                                     # lazy P^E
    again = tstrat.mixing_powers(topo, 0.1, 3)
    assert again[0] is p64 and again[1] is p and again[2] is not None
    assert tstrat.mixing_powers(topo, 0.1, 3)[2] is again[2]
    sp = tstrat.ConsensusStrategy(tau=2, topo=topo, eps=0.1, rounds=3,
                                  sparse=True)
    assert sp.p is p and sp.p_e is again[2]
    for i in range(tstrat._POWER_CACHE_MAXSIZE + 5):
        tstrat.mixing_powers(topo, 0.01 + i * 1e-3, 1, need_power=False)
    assert len(tstrat._POWER_CACHE) == tstrat._POWER_CACHE_MAXSIZE
    assert tstrat._topology_digest(topo) == jstrat._topology_digest(
        J.knn_ring(12, 4))
    tstrat.clear_power_cache()
    assert not tstrat._POWER_CACHE


@pytest.mark.parametrize("topo_fn, m", [
    (lambda M, m: M.knn_ring(m, 4), 64), (lambda M, m: M.knn_ring(m, 4), 63),
    (lambda M, m: M.fully_connected(m), 64), (lambda M, m: M.ring(m), 128),
    (lambda M, m: M.erdos_renyi(m, 0.3, 0), 64)])
def test_sparse_auto_selection(topo_fn, m):
    ts = tstrat.ConsensusStrategy(tau=2, topo=topo_fn(T, m), eps=0.01)
    js = jstrat.ConsensusStrategy(tau=2, topo=topo_fn(J, m), eps=0.01)
    assert ts.sparse == js.sparse
    assert ts.sparse == (T.density(ts.topo) <= tstrat.SPARSE_DENSITY_THRESHOLD
                         and m >= tstrat.SPARSE_MIN_AGENTS)


# --- the strategy's local step against JAX's ---------------------------------------

FORMS = {"dense": dict(), "dense-E2": dict(rounds=2),
         "unfused-E2": dict(rounds=2, fused=False),
         "sparse-E2": dict(rounds=2, sparse=True)}


@pytest.mark.parametrize("opt", [None, "momentum", "adam"])
@pytest.mark.parametrize("form", list(FORMS))
def test_flat_local_step_matches_jax(form, opt):
    m, n, tau = 8, 65, 3
    taus = np.array([3, 3, 3, 3, 2, 2, 1, 1])
    jt, tt = J.random_regularish(m, 3, 4, 2), T.random_regularish(m, 3, 4, 2)
    eps = 0.9 / tt.max_degree
    js = jstrat.make_strategy("consensus", tau=tau, topo=jt, eps=eps,
                              taus=taus, **FORMS[form])
    ts = tstrat.make_strategy("consensus", tau=tau, topo=tt, eps=eps,
                              taus=taus, **FORMS[form])
    jo = {None: None, "momentum": jmom(0.9), "adam": jadam()}[opt]
    to = {None: None, "momentum": flat_momentum(0.9), "adam": flat_adam()}[opt]
    p0 = _arr((m, n), 0)
    jp, tp = jnp.asarray(p0), torch.tensor(p0)
    js_, ts_ = (jo.init(jp) if jo else {}), (to.init(tp) if to else {})
    jc, tc = js.init_comm_state(jp), ts.init_comm_state(tp)
    assert jc == {} and tc == {}
    for step in range(2 * tau):
        g = _arr((m, n), 10 + step)
        jp, js_, jc = js.flat_local_step(jp, jnp.asarray(g), step % tau, 5e-3,
                                         jo, js_, jc, backend="jnp")
        out, ts_, tc = ts.flat_local_step(tp, torch.tensor(g), step % tau,
                                          5e-3, to, ts_, tc)
        assert out is tp
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-7, err_msg=f"step {step}")


# --- the ledger --------------------------------------------------------------------

@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("n_updates", [12, 13, 17])
def test_consensus_ledger_and_bytes_curve_equal(rounds, n_updates):
    jt, tt = J.random_regularish(7, 3, 4, 0), T.random_regularish(7, 3, 4, 0)
    eps = 0.9 / tt.max_degree
    js = jstrat.make_strategy("consensus", tau=5, topo=jt, eps=eps,
                              rounds=rounds)
    ts = tstrat.make_strategy("consensus", tau=5, topo=tt, eps=eps,
                              rounds=rounds)
    jl, tl = JLedger(), tacc.CostLedger()
    full, rem = divmod(n_updates, 5)
    for led, s in ((jl, js), (tl, ts)):
        led.add_periods(s, full, 9347)
        led.add_partial_period(s, rem, 9347)
    assert tl.table_row() == jl.table_row()
    kw = dict(n_epochs=4, epoch_len=150, minibatch=25)
    jc = jfed.FedRLConfig(env=JF8, strategy=js, **kw)
    tc = tfed.FedRLConfig(env=TF8, strategy=ts, **kw)
    assert tfed.fedrl_ledger(tc).table_row() == jfed.fedrl_ledger(jc).table_row()
    np.testing.assert_array_equal(tfed.fedrl_bytes_curve(tc),
                                  jfed.fedrl_bytes_curve(jc))


# --- core/consensus.py ---------------------------------------------------------------

def test_consensus_operators_match_jax():
    jt, tt = J.random_regularish(7, 3, 4, 0), T.random_regularish(7, 3, 4, 0)
    eps = 0.9 / tt.max_degree
    tree = {"a": _arr((7, 3, 4), 1), "b": {"c": _arr((7, 5), 2)}}
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = {"a": torch.tensor(tree["a"]), "b": {"c": torch.tensor(tree["b"]["c"])}}
    for rounds in (0, 1, 3):
        for jf, tf in ((jcons.consensus_rounds_dense, tcons.consensus_rounds_dense),
                       (jcons.consensus_rounds_matrix,
                        tcons.consensus_rounds_matrix)):
            want, got = jf(jtree, jt, eps, rounds), tf(ttree, tt, eps, rounds)
            for path in (("a",), ("b", "c")):
                w, t = want, got
                for k in path:
                    w, t = w[k], t[k]
                np.testing.assert_allclose(t.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-6)
        d_j = float(jcons.disagreement(jcons.consensus_rounds_dense(
            jtree, jt, eps, rounds)))
        d_t = float(tcons.disagreement(tcons.consensus_rounds_dense(
            ttree, tt, eps, rounds)))
        np.testing.assert_allclose(d_t, d_j, rtol=1e-5)
    # the E-round oracle: the strategy's fused dense transform with every
    # agent active is P^E applied once
    ts = tstrat.make_strategy("consensus", tau=2, topo=tt, eps=eps, rounds=3)
    g = torch.tensor(_arr((7, 11), 4))
    np.testing.assert_allclose(_mix(ts, g, 0).numpy(),
                               tcons.consensus_rounds_dense(g, tt, eps, 3).numpy(),
                               rtol=1e-5, atol=1e-6)
