"""Port parity: variation schedules, decay tables, strategies and the ledger.

The host-side pieces are numpy (or fp32 torch on the CPU) on both sides:
``tau_schedule`` / ``uniform_taus`` / masks come out identical, the decay
tables within 1 fp32 ulp of the table's scale D(0) = 1 (atol 2^-23: the
transcendental functions of XLA and torch may round differently, and the
cosine family's 1 + cos(pi j / tau) cancels), the per-step weights identical given the same tables, and
``CostLedger`` / ``fedrl_ledger`` / ``fedrl_bytes_curve`` equal at rtol 0.
The strategies' flat seams are checked against the JAX strategies' on the
same ``(m, n)`` buffers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.core import decay as jdecay
from repro.core import topology as jtop
from repro.core import strategies as jstrat
from repro.core import variation as jvar
from repro.core.accounting import CostLedger as JLedger
from repro.rl import FIGURE_EIGHT as JF8
from repro.rl import fedrl as jfed
from repro.optim.flat import flat_adam as jadam
from repro_torch import comm as tcomm
from repro_torch.core import accounting as tacc
from repro_torch.core import decay as tdecay
from repro_torch.core import strategies as tstrat
from repro_torch.core import topology as ttop
from repro_torch.core import variation as tvar
from repro_torch.optim import flat_adam, server_average_state
from repro_torch.rl import FIGURE_EIGHT as TF8
from repro_torch.rl import fedrl as tfed

ULP = float(np.finfo(np.float32).eps)


def test_schedules_are_identical():
    times = np.array([0.1, 0.1, 0.13, 0.2, 0.7])
    np.testing.assert_array_equal(tvar.tau_schedule(7, times),
                                  jvar.tau_schedule(7, times))
    for seed in range(3):
        np.testing.assert_array_equal(tvar.uniform_taus(1, 15, 64, seed),
                                      jvar.uniform_taus(1, 15, 64, seed))
    taus = jvar.uniform_taus(2, 6, 9)
    assert tvar.tau_stats(taus) == jvar.tau_stats(taus)
    np.testing.assert_array_equal(tvar.mask_from_taus(taus, 6),
                                  np.asarray(jvar.mask_from_taus(taus, 6)))
    np.testing.assert_array_equal(tvar.masked_update_counts(taus, 4),
                                  jvar.masked_update_counts(taus, 4))
    for bad in ([0, 1], [2, 3], [1, 1]):
        with pytest.raises(ValueError) as je:
            jvar.validate_a2(np.array(bad), 2)
        with pytest.raises(ValueError) as te:
            tvar.validate_a2(np.array(bad), 2)
        assert str(je.value) == str(te.value)


FAMILIES = {
    "exp": (lambda: jdecay.exponential_decay(0.95),
            lambda: tdecay.exponential_decay(0.95)),
    "exp_half": (lambda: jdecay.exponential_decay(0.5),
                 lambda: tdecay.exponential_decay(0.5)),
    "linear": (lambda: jdecay.linear_decay(15, 0.2),
               lambda: tdecay.linear_decay(15, 0.2)),
    "cosine": (lambda: jdecay.cosine_decay(15, 0.1),
               lambda: tdecay.cosine_decay(15, 0.1)),
    "step": (lambda: jdecay.step_decay(5, 0.3),
             lambda: tdecay.step_decay(5, 0.3)),
    "none": (jdecay.no_decay, tdecay.no_decay),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_decay_tables_within_one_ulp(family):
    jf, tf = (f() for f in FAMILIES[family])
    want = np.asarray(jf(jnp.arange(15)), np.float32)
    got = tf(torch.arange(15)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ULP)
    np.testing.assert_allclose(tdecay.decay_sq_prefix_sum(tf, 11),
                               jdecay.decay_sq_prefix_sum(jf, 11), rtol=4 * ULP)
    js = jstrat.DecayStrategy(tau=15, m=4, decay=jf)
    ts = tstrat.DecayStrategy(tau=15, m=4, decay=tf)
    np.testing.assert_allclose(ts.decay_weights, js.decay_weights, rtol=0,
                               atol=ULP)


def test_decay_a3_check_is_kept():
    bad = lambda j: torch.where(j == 2, torch.tensor(1.5), torch.tensor(1.0))
    with pytest.raises(ValueError, match="A3"):
        tstrat.DecayStrategy(tau=4, m=2, decay=tdecay._Named(bad, "bad"))
    for ctor in (lambda: tdecay.exponential_decay(0.0),
                 lambda: tdecay.linear_decay(0), lambda: tdecay.step_decay(2, 2)):
        with pytest.raises(ValueError):
            ctor()


def _pairs():
    taus = jvar.uniform_taus(1, 6, 5, seed=1)
    jt, tt = jtop.random_regularish(5, 2, 3, 1), ttop.random_regularish(5, 2, 3, 1)
    return {
        "consensus": (jstrat.make_strategy("consensus", tau=6, taus=taus,
                                           topo=jt, eps=0.15, rounds=2),
                      tstrat.make_strategy("consensus", tau=6, taus=taus,
                                           topo=tt, eps=0.15, rounds=2)),
        "consensus-topk": (
            jstrat.make_strategy("consensus", tau=6, taus=taus, topo=jt,
                                 eps=0.15, comm=jcomm.topk(100)),
            tstrat.make_strategy("consensus", tau=6, taus=taus, topo=tt,
                                 eps=0.15, comm=tcomm.topk(100))),
        "periodic-int8": (
            jstrat.make_strategy("periodic", tau=6, taus=taus,
                                 comm=jcomm.qint8()),
            tstrat.make_strategy("periodic", tau=6, taus=taus,
                                 comm=tcomm.qint8())),
        "decay-bf16": (
            jstrat.make_strategy("decay", tau=6, taus=taus,
                                 decay=jdecay.exponential_decay(0.9),
                                 comm=jcomm.qbf16()),
            tstrat.make_strategy("decay", tau=6, taus=taus,
                                 decay=tdecay.exponential_decay(0.9),
                                 comm=tcomm.qbf16())),
        "sync": (jstrat.make_strategy("sync", m=5),
                 tstrat.make_strategy("sync", m=5)),
        "periodic": (jstrat.make_strategy("periodic", tau=6, taus=taus),
                     tstrat.make_strategy("periodic", tau=6, taus=taus)),
        "decay": (jstrat.make_strategy("decay", tau=6, taus=taus,
                                       decay=jdecay.exponential_decay(0.9)),
                  tstrat.make_strategy("decay", tau=6, taus=taus,
                                       decay=tdecay.exponential_decay(0.9))),
    }


@pytest.mark.parametrize("kind", ["sync", "periodic", "decay"])
def test_strategy_weights_and_flat_seams_match_jax(kind):
    js, ts = _pairs()[kind]
    assert ts.name == js.name and ts.tau == js.tau and ts.m == js.m
    np.testing.assert_array_equal(ts.mask, js.mask)
    if kind == "decay":   # the JAX and port decay tables as built, in the weights
        object.__setattr__(ts, "decay_weights", js.decay_weights)
    rng = np.random.default_rng(0)
    p, g = rng.standard_normal((2, 5, 33)).astype(np.float32)
    for off in range(ts.tau):
        np.testing.assert_array_equal(ts.weight(off).numpy(),
                                      np.asarray(js.weight(off)))
        np.testing.assert_array_equal(
            ts.flat_update(torch.tensor(p), torch.tensor(g), off, 5e-3).numpy(),
            np.asarray(js.flat_update(jnp.asarray(p), jnp.asarray(g), off, 5e-3)))
        assert ts.comm_events_partial_period(off) == \
            js.comm_events_partial_period(off)
    assert ts.comm_events_per_period() == js.comm_events_per_period()
    # the sync is a copy of the row mean into every row of the carry
    flat = torch.tensor(p)
    out, state = ts.flat_sync(flat, {})
    assert out is flat and state == {}
    assert flat.is_contiguous() and flat.stride() == (33, 1)
    want, _ = js.flat_sync(jnp.asarray(p), {})
    np.testing.assert_allclose(flat.numpy(), np.asarray(want), rtol=ULP)
    flat[0, 0] = 7.0                     # rows are separate storage
    assert flat[1, 0] != 7.0


def test_local_step_and_moment_sync_in_place():
    ts = tstrat.make_strategy("periodic", tau=3, m=4)
    opt = flat_adam()
    flat = torch.randn(4, 10)
    state = opt.init(flat)
    mu = state["mu"]
    g = torch.randn(4, 10)
    comm_state = ts.init_comm_state(flat)
    out, state, cs = ts.flat_local_step(flat, g, 0, 1e-2, opt, state,
                                        comm_state)
    assert out is flat and state["mu"] is mu and state["t"] == 1
    assert cs is comm_state == {}
    server_average_state(ts, state)
    assert state["mu"] is mu and torch.allclose(mu, mu.mean(0).expand(4, 10))
    before = flat.clone()
    ts.flat_local_step(flat, g, 1, 1e-2, None, {}, {})
    assert not torch.equal(before, flat)


def test_make_strategy_names_the_slices_still_to_come():
    # consensus and compression are ported: a consensus strategy needs its
    # topology and step size, and any kind takes a payload transform
    with pytest.raises(TypeError, match="needs topo and eps"):
        tstrat.make_strategy("consensus", tau=2, m=4)
    topo = ttop.ring(4)
    s = tstrat.make_strategy("consensus", tau=2, topo=topo, eps=0.1,
                             comm=tcomm.qint8())
    assert isinstance(s, tstrat.ConsensusStrategy) and s.comm.kind == "int8"
    # async is ported too: it needs its delay schedule
    with pytest.raises(TypeError, match="'async' needs a schedule"):
        tstrat.make_strategy("async", tau=2, m=4)
    with pytest.raises(TypeError, match="'periodic' takes no schedule"):
        tstrat.make_strategy("periodic", tau=2, m=4, schedule=object())
    with pytest.raises(ValueError, match="unknown strategy"):
        tstrat.make_strategy("gossip")
    with pytest.raises(ValueError, match="need taus or m"):
        tstrat.make_strategy("periodic", tau=2)


@pytest.mark.parametrize("kind, kw", [
    ("periodic", dict(tau=2, m=4, decay=None, tuas=3)),
    ("periodic", dict(tau=2, m=4, decay=tdecay.exponential_decay(0.9))),
    ("sync", dict(tau=3, m=4)),
    ("decay", dict(m=4)),
    ("decay", dict(tau=2, m=4, backend="jnp")),
    ("periodic", dict(tau=2, m=4, topo="ring")),
    ("decay", dict(tau=2, m=4, eps=0.1)),
    ("sync", dict(m=4, rounds=2)),
    ("periodic", dict(tau=2, m=4, sparse=True)),
    ("consensus", dict(tau=2, topo="ring", eps=0.1, decay=None, fused=False,
                       schedule=None)),
    ("consensus", dict(tau=2, topo="ring", eps=0.1,
                       decay=tdecay.exponential_decay(0.9))),
    ("consensus", dict(topo="ring", eps=0.1)),
])
def test_make_strategy_refuses_keywords_the_kind_does_not_take(kind, kw):
    if kw.get("topo") == "ring":
        kw = dict(kw, topo=ttop.ring(4))
    with pytest.raises(TypeError):
        tstrat.make_strategy(kind, **kw)


@pytest.mark.parametrize("kind", ["sync", "periodic", "decay", "consensus",
                                  "consensus-topk", "periodic-int8",
                                  "decay-bf16"])
@pytest.mark.parametrize("n_updates", [12, 13, 17])
def test_ledgers_equal_at_rtol_0(kind, n_updates):
    js, ts = _pairs()[kind]
    jl, tl = JLedger(), tacc.CostLedger()
    full, rem = divmod(n_updates, ts.tau)
    jl.add_periods(js, full, 9347)
    jl.add_partial_period(js, rem, 9347)
    tl.add_periods(ts, full, 9347)
    tl.add_partial_period(ts, rem, 9347)
    assert tl.table_row() == jl.table_row()
    assert tl.psi0(1.0, 0.25, 0.5, 0.5) == jl.psi0(1.0, 0.25, 0.5, 0.5)
    assert tl.periods_billed == jl.periods_billed


@pytest.mark.parametrize("kind", ["periodic", "decay"])
def test_fedrl_ledger_and_bytes_curve_equal(kind):
    taus = jvar.uniform_taus(1, 6, 7, seed=2)
    js = jstrat.make_strategy(kind, tau=6, taus=taus)
    ts = tstrat.make_strategy(kind, tau=6, taus=taus)
    kw = dict(n_epochs=5, epoch_len=150, minibatch=25)
    jc = jfed.FedRLConfig(env=JF8, strategy=js, optimizer=jadam(), **kw)
    tc = tfed.FedRLConfig(env=TF8, strategy=ts, optimizer=flat_adam(), **kw)
    assert tfed.policy_payload_elems() == jfed.policy_payload_elems() == 9347
    assert tfed.fedrl_ledger(tc).table_row() == jfed.fedrl_ledger(jc).table_row()
    np.testing.assert_array_equal(tfed.fedrl_bytes_curve(tc),
                                  jfed.fedrl_bytes_curve(jc))
    assert tfed.expected_gradient_norm({"server_grad_sq_norm": [1.0, 2.0]}) == 1.5
