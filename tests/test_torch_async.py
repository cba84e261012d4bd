"""Port parity of the async federation slice (``repro_torch.core.async_fed``)
against the JAX package's ``repro.core.async_fed``, on the CPU.

The test names follow ``tests/test_async_fed.py``. The JAX package's delay
process draws its uniforms from ``delay_axis_key(seed)`` (threefry, which
the port cannot reproduce), so every schedule here is built in the port on
JAX's uniforms (``uniforms=``), and must then equal JAX's bitwise: the
fp32 ``log1p`` / ``pow`` / ``floor`` of ``delay_draws``, the renewal scan,
the K-of-m selection. Whole runs replay JAX's training draws
(``test_torch_fedrl.jax_draws``) on one small geometry (m = 7, tau = 3, 2
epochs of 5 updates: 3 boundaries and a partial period) and hold the
metrics within rtol 1e-4 and the ledgers exactly; the module fixture runs
JAX's three compiles (a delayed ``run_fedrl``, a ``delay`` sweep, a ``k``
sweep) once.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import async_fed as jaf
from repro.core import make_strategy as jmake
from repro.core.accounting import CostLedger as JLedger
from repro.core.decay import exponential_decay as jexp
from repro.kernels import dispatch as jdispatch
from repro.rl import FIGURE_EIGHT as JF8
from repro.rl import FedRLConfig as JConfig
from repro.rl import fedrl as jfedrl
from repro.sweep import SweepAxis as JAxis
from repro.sweep import SweepSpec as JSpec
from repro.sweep import run_sweep as jrun_sweep
from repro_torch import comm as tcomm
from repro_torch import sweep as tsweep
from repro_torch.core import async_fed as taf
from repro_torch.core import make_strategy as tmake
from repro_torch.core.accounting import CostLedger
from repro_torch.core.decay import exponential_decay as texp
from repro_torch.core.strategies import PeriodicStrategy, stack_runs
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.rl import FIGURE_EIGHT as TF8
from repro_torch.rl import FedRLConfig as TConfig
from repro_torch.rl import ReplayDraws
from repro_torch.rl import fedrl as tfedrl
from repro_torch.sweep import overrides as tov
from test_torch_fedrl import jax_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, TAU, SEEDS = 7, 3, (0, 1)
COMMON = dict(n_epochs=2, epoch_len=20, minibatch=4, eta=5e-3)
N_PERIODS = COMMON["n_epochs"] * (COMMON["epoch_len"]
                                  // COMMON["minibatch"]) // TAU   # 3
FAMILIES = (("deterministic", 0.0), ("deterministic", 1.0),
            ("deterministic", 2.4), ("geometric", 0.5),
            ("geometric", 0.05), ("heavytail", 1.5), ("heavytail", 0.7))


def jax_uniforms(seed, m, n_periods):
    """JAX's delay-process uniforms (``async_fed.py:92-94``)."""
    return np.asarray(jax.random.uniform(
        jaf.delay_axis_key(seed), (m, n_periods), jnp.float32,
        minval=1e-6, maxval=1.0 - 1e-6))


def _cfgs(jsched, tsched, **kw):
    return (JConfig(env=JF8, strategy=jaf.AsyncStrategy(
                tau=TAU, schedule=jsched, backend="jnp", **kw), **COMMON),
            TConfig(env=TF8, strategy=taf.AsyncStrategy(
                tau=TAU, schedule=tsched, **kw), **COMMON))


def _pair(dist, param, seed=1234, **kw):
    js = jaf.make_schedule(dist, param, M, N_PERIODS, seed=seed)
    ts = taf.make_schedule(dist, param, M, N_PERIODS,
                           uniforms=jax_uniforms(seed, M, N_PERIODS))
    return _cfgs(js, ts, **kw)


def _kofm_pair(k, seed=1234):
    js = jaf.kofm_schedule(M, N_PERIODS, k, dist="geometric", param=0.5,
                           seed=seed)
    ts = taf.kofm_schedule(M, N_PERIODS, k, dist="geometric", param=0.5,
                           uniforms=jax_uniforms(seed, M, N_PERIODS))
    return _cfgs(js, ts)


DELAY_POINTS = ((0.0, 1.0), (1.0, 0.5), (2.0, 1.5))
K_POINTS = (1.0, 3.0, 7.0)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's three compiles and the runs' draws, once per module."""
    draws = {s: jax_draws(_pair("geometric", 0.5)[0], jax.random.key(s))
             for s in SEEDS}
    jcfg, tcfg = _pair("geometric", 0.5, stale_decay=None)
    jcfg = dataclasses.replace(jcfg, strategy=jaf.AsyncStrategy(
        tau=TAU, schedule=jcfg.strategy.schedule, backend="jnp",
        stale_decay=jexp(0.8)))
    tcfg = dataclasses.replace(tcfg, strategy=taf.AsyncStrategy(
        tau=TAU, schedule=tcfg.strategy.schedule, stale_decay=texp(0.8)))
    delayed = (jcfg, tcfg, jfedrl.run_fedrl(jcfg, jax.random.key(0)))
    jd, td = _pair("deterministic", 0.0)
    delay = (td, jrun_sweep(JSpec(name="delay", base=jd, seeds=SEEDS,
                                  vmapped=(JAxis("delay", DELAY_POINTS),))))
    jk, tk = _kofm_pair(3)
    k = (tk, jrun_sweep(JSpec(name="k", base=jk, seeds=SEEDS,
                              vmapped=(JAxis("k", K_POINTS),))))
    return {"draws": draws, "delayed": delayed, "delay": delay, "k": k}


def _replaying(draws):
    def run(cfgs, seeds):
        return tfedrl.run_fedrl_batch(
            cfgs, [ReplayDraws(*draws[s]) for s in seeds], device="cpu")[1]
    return run


# --- delay schedules -----------------------------------------------------------

def test_zero_delay_schedule_is_synchronous():
    s = taf.make_schedule("deterministic", 0.0, 5, 7, seed=3)
    np.testing.assert_array_equal(s.arrive, np.ones((5, 7), np.float32))
    np.testing.assert_array_equal(s.age, np.zeros((5, 7), np.float32))
    assert s.total_arrivals() == 35


def test_deterministic_lag_skips_exactly_d_boundaries():
    s = taf.make_schedule("deterministic", 2.0, 3, 9, seed=0)
    expect = np.zeros((3, 9), np.float32)
    expect[:, 2::3] = 1.0
    np.testing.assert_array_equal(s.arrive, expect)
    assert np.all(s.age[:, 2::3] == 2.0)


def test_renewal_arrivals_age_counts_boundaries_since_last_sync():
    delays = np.array([[0.0, 2.0, 0.0, 0.0], [1.0, 0.0, 3.0, 0.0]],
                      np.float32)
    arrive, age = taf.renewal_arrivals(delays)
    np.testing.assert_array_equal(arrive[0], [1.0, 0.0, 1.0, 1.0])
    np.testing.assert_array_equal(age[0], [0.0, 0.0, 1.0, 0.0])
    ja, jg = jaf.renewal_arrivals(delays)
    np.testing.assert_array_equal(arrive, np.asarray(ja))
    np.testing.assert_array_equal(age, np.asarray(jg))


def test_delay_draws_distributions_differ_and_clip():
    u = jax_uniforms(0, 4, 6)
    for name, dist_id in taf.DELAY_DISTRIBUTIONS.items():
        d = taf.delay_draws(dist_id, 1.5, 6, u)
        assert d.shape == (4, 6) and d.dtype == np.float32
        assert np.all(d >= 0) and np.all(d <= 6), name
    assert np.all(taf.delay_draws(0, 1.5, 6, u) == 2.0)
    with pytest.raises(ValueError, match="unknown delay distribution id"):
        taf.delay_draws(3, 1.0, 6, u)


def test_make_schedule_unknown_distribution():
    with pytest.raises(KeyError, match="unknown delay distribution"):
        taf.make_schedule("poisson", 1.0, 3, 4)
    with pytest.raises(ValueError, match=r"uniforms must be \(3, 4\)"):
        taf.make_schedule("geometric", 0.5, 3, 4, uniforms=np.zeros((4, 3)))


@pytest.mark.parametrize("dist,param", FAMILIES)
def test_schedule_matches_delay_axis_stream(dist, param):
    """On JAX's uniforms the port's draws and renewal schedules are JAX's,
    bitwise: the draws of a (64, 48) key (3,072 of them) and the
    schedules of two (16, 12) keys."""
    dist_id = taf.DELAY_DISTRIBUTIONS[dist]
    np.testing.assert_array_equal(
        taf.delay_draws(dist_id, param, 48, jax_uniforms(99, 64, 48)),
        np.asarray(jaf.delay_draws(dist_id, param, 64, 48,
                                   jaf.delay_axis_key(99))))
    for seed in (0, 7):
        js = jaf.make_schedule(dist, param, 16, 12, seed=seed)
        ts = taf.make_schedule(dist, param, 16, 12,
                               uniforms=jax_uniforms(seed, 16, 12))
        np.testing.assert_array_equal(ts.arrive, js.arrive)
        np.testing.assert_array_equal(ts.age, js.age)
        assert (ts.label, ts.dist, ts.param) == (js.label, js.dist, js.param)


def test_delay_uniforms_are_seeded_and_in_range():
    a = taf.delay_uniforms(1234, 7, 5)
    assert a.shape == (7, 5) and a.dtype == np.float32
    assert np.all(a >= 1e-6) and np.all(a <= 1.0 - 1e-6)
    np.testing.assert_array_equal(a, taf.delay_uniforms(1234, 7, 5))
    assert not np.array_equal(a, taf.delay_uniforms(1235, 7, 5))
    # the default stream of a schedule is delay_uniforms(seed)
    s = taf.make_schedule("geometric", 0.5, 7, 5, seed=1234)
    np.testing.assert_array_equal(
        s.arrive, taf.make_schedule("geometric", 0.5, 7, 5, uniforms=a).arrive)
    assert s.uniforms is None


def test_committed_delay_uniforms_equal_jax_draw():
    """``experiments/bench/ref_fig_async_delay_uniforms.npy`` is JAX's draw
    for the async bench (eval_seed 1234, m = 7, its --quick n_periods), in
    the threefry mode the committed ``fig_async`` artifacts were drawn in;
    on it the port's schedules bill the committed arrivals."""
    u = np.load(os.path.join(ROOT, "experiments", "bench",
                             "ref_fig_async_delay_uniforms.npy"))
    assert u.dtype == np.float32 and u.shape == (7, 3)
    with jax.threefry_partitionable(False):
        np.testing.assert_array_equal(u, jax_uniforms(1234, 7, 3))
    arrivals = {"geometric": 12, "heavytail": 14}   # fig_async.json
    for dist, param in (("geometric", 0.5), ("heavytail", 1.5)):
        s = taf.make_schedule(dist, param, 7, 3, uniforms=u)
        assert s.total_arrivals() == arrivals[dist]


def test_kofm_schedule_exact_k_arrivals():
    s = taf.kofm_schedule(6, 8, 4, seed=2)
    assert s.k == 4
    np.testing.assert_array_equal(s.arrivals_per_period(), np.full(8, 4, int))
    with pytest.raises(ValueError, match="1 <= k <= m"):
        taf.kofm_schedule(6, 8, 7)


@pytest.mark.parametrize("dist,param,m,T,k,seed", [
    ("geometric", 0.5, 7, 9, 3, 0), ("heavytail", 1.5, 11, 6, 5, 42),
    ("deterministic", 2.0, 5, 8, 2, 7), ("deterministic", 0.0, 4, 5, 4, 0),
])
def test_kofm_arrivals_matches_host_schedule_bitwise(dist, param, m, T, k,
                                                     seed):
    """One host selection equals JAX's host constructor and its traced
    twin, arrivals and ages, index tie-breaks included."""
    ts = taf.kofm_schedule(m, T, k, dist=dist, param=param,
                           uniforms=jax_uniforms(seed, m, T))
    js = jaf.kofm_schedule(m, T, k, dist=dist, param=param, seed=seed)
    np.testing.assert_array_equal(ts.arrive, js.arrive)
    np.testing.assert_array_equal(ts.age, js.age)
    assert ts.label == js.label
    lag = jaf.delay_draws(jaf.DELAY_DISTRIBUTIONS[dist], param, m, T,
                          jaf.delay_axis_key(seed))
    ja, jg = jax.jit(jaf.kofm_arrivals)(lag, float(k))
    np.testing.assert_array_equal(ts.arrive, np.asarray(ja))
    np.testing.assert_array_equal(ts.age, np.asarray(jg))


# --- weights -------------------------------------------------------------------

def test_stale_weight_table_validates_a3_over_ages():
    t = taf.stale_weight_table(texp(0.9), 4)
    assert t.shape == (5,) and t.dtype == np.float32
    np.testing.assert_array_equal(t, jaf.stale_weight_table(jexp(0.9), 4))
    np.testing.assert_array_equal(taf.stale_weight_table(None, 3),
                                  np.ones(4, np.float32))
    for bad in (lambda j: j + 2.0, lambda j: j * 0.1,
                lambda j: 1.0 - 0.6 * j):
        with pytest.raises(ValueError, match="staleness decay"):
            taf.stale_weight_table(bad, 4)


def test_sync_weight_table_zero_delay_is_exactly_one():
    s = taf.make_schedule("deterministic", 0.0, 4, 5, seed=0)
    t = taf.stale_weight_table(texp(0.7), 5)
    np.testing.assert_array_equal(taf.sync_weight_table(s.arrive, s.age, t),
                                  np.ones((4, 5), np.float32))


def test_sync_weight_table_decays_with_age():
    u = jax_uniforms(5, 6, 7)
    ts = taf.make_schedule("heavytail", 1.5, 6, 7, uniforms=u)
    t = taf.stale_weight_table(texp(0.81), 7)
    w = taf.sync_weight_table(ts.arrive, ts.age, t)
    js = jaf.make_schedule("heavytail", 1.5, 6, 7, seed=5)
    jw = jaf.sync_weight_table(js.arrive, js.age,
                               jaf.stale_weight_table(jexp(0.81), 7))
    np.testing.assert_array_equal(w, np.asarray(jw))
    assert np.any((w > 0) & (w < 1))


# --- masked server step --------------------------------------------------------

def _weights(kind, shape, rng):
    if kind == "ones":
        return np.ones(shape, np.float32)
    if kind == "none":
        return np.zeros(shape, np.float32)
    if kind == "part":
        w = (rng.random(shape) < 0.5).astype(np.float32)
        w[..., 0] = 1.0
        return w
    return np.where(rng.random(shape) < 0.3, 0.0,
                    rng.random(shape)).astype(np.float32)   # fractional


@pytest.mark.parametrize("shape", [(7, 129), (3, 7, 65), (5, 5, 33)])
@pytest.mark.parametrize("kind", ["ones", "none", "part", "frac"])
def test_masked_server_step_is_the_weighted_mean(shape, kind):
    """Against JAX's jnp path (vmapped over the runs of a stack) within 4
    ulp (the two packages' fp32 sums add in their own orders); with weights
    in {0, 1} bitwise equal to the port's own ``row_mean`` of ``w * g``
    times ``m / sum(w)``; ``denom`` on the carry's device, per run, equal to
    JAX's (fractional weights: to 1 ulp)."""
    rng = np.random.default_rng([*shape, ["ones", "none", "part",
                                          "frac"].index(kind)])
    flat = rng.standard_normal(shape).astype(np.float32)
    w = _weights(kind, shape[:-1], rng)
    row, denom = taf.masked_server_step(torch.tensor(flat), torch.tensor(w))
    jstep = lambda f, ww: jaf.masked_server_step(f, ww, backend="jnp")
    if flat.ndim == 3:
        jstep = jax.vmap(jstep)
    jrow, jden = jstep(jnp.asarray(flat), jnp.asarray(w))
    assert isinstance(denom, torch.Tensor) and denom.shape == shape[:-2]
    if kind == "frac":   # a sum of fractions: each package's own order
        np.testing.assert_allclose(denom.numpy(), np.asarray(jden),
                                   rtol=2 ** -22)
    else:
        np.testing.assert_array_equal(denom.numpy(), np.asarray(jden))
    got, want = row.numpy(), np.asarray(jrow)
    if kind == "none":
        assert not np.any(np.isfinite(got)) and not np.any(np.isfinite(want))
        return
    np.testing.assert_allclose(got, want, rtol=2 ** -21, atol=1e-7)
    ref = (flat * w[..., None]).sum(-2) / w.sum(-1)[..., None]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    if kind != "frac":
        scaled = torch.tensor(flat * w[..., None])
        mine = tdispatch.row_mean(scaled) * (shape[-2] / torch.tensor(
            w).sum(-1)).unsqueeze(-1)
        assert torch.equal(row, mine)


def test_masked_server_step_all_ones_bitwise_row_mean():
    flat = torch.tensor(np.random.default_rng(1).standard_normal(
        (7, 129)).astype(np.float32))
    row, denom = taf.masked_server_step(flat, torch.ones(7))
    assert torch.equal(row, tdispatch.row_mean(flat)) and float(denom) == 7.0
    np.testing.assert_allclose(
        row.numpy(), np.asarray(jdispatch.row_mean(jnp.asarray(flat.numpy()),
                                                   backend="jnp")),
        rtol=2 ** -22, atol=1e-7)


def test_masked_server_step_refuses_shared_weights_on_a_stack():
    """S == m: (S, m, n) takes (S, m) weights only, never a 1-D vector."""
    flat = torch.zeros(4, 4, 8)
    with pytest.raises(ValueError, match=r"w must be \(4, 4\)"):
        taf.masked_server_step(flat, torch.ones(4))


def test_flat_sync_no_arrivals_keeps_reference_and_replicas():
    sched = taf.DelaySchedule(arrive=np.zeros((3, 2), np.float32),
                              age=np.zeros((3, 2), np.float32), n_periods=2,
                              label="none")
    strat = taf.AsyncStrategy(tau=2, schedule=sched)
    flat = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))
    before = flat.clone()
    cs = strat.init_comm_state(flat)
    out, cs2 = strat.flat_sync(flat, cs, period=0)
    assert out is flat and torch.equal(out, before)
    assert torch.equal(cs2["ref"], cs["ref"])
    assert torch.equal(strat.server_row(out, cs2), before[0])


def test_flat_sync_rebases_only_arrivals():
    arrive = np.array([[1.0], [0.0]], np.float32)
    sched = taf.DelaySchedule(arrive=arrive, age=np.zeros((2, 1), np.float32),
                              n_periods=1, label="half")
    strat = taf.AsyncStrategy(tau=1, schedule=sched)
    flat = torch.tensor([[2.0, 4.0], [10.0, 20.0]])
    out, cs2 = strat.flat_sync(flat, strat.init_comm_state(flat), period=0)
    np.testing.assert_array_equal(cs2["ref"].numpy(), [2.0, 4.0])
    np.testing.assert_array_equal(out.numpy(), [[2.0, 4.0], [10.0, 20.0]])
    np.testing.assert_array_equal(strat.server_row(out, cs2).numpy(),
                                  [2.0, 4.0])
    # against JAX's flat_sync on a partial schedule with staleness weights
    u = jax_uniforms(9, 7, 4)
    js = jaf.AsyncStrategy(tau=2, schedule=jaf.make_schedule(
        "geometric", 0.5, 7, 4, seed=9), backend="jnp",
        stale_decay=jexp(0.8))
    ts = taf.AsyncStrategy(tau=2, schedule=taf.make_schedule(
        "geometric", 0.5, 7, 4, uniforms=u), stale_decay=texp(0.8))
    x = np.random.default_rng(2).standard_normal((7, 33)).astype(np.float32)
    jf, jcs = jnp.asarray(x), js.init_comm_state(jnp.asarray(x))
    tf, tcs = torch.tensor(x), ts.init_comm_state(torch.tensor(x))
    for period in range(4):
        jf, jcs = js.flat_sync(jf + 0.1 * period, jcs, period=period)
        tf, tcs = ts.flat_sync(tf + 0.1 * period, tcs, period=period)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=2e-7,
                                   atol=1e-7)
        np.testing.assert_allclose(tcs["ref"].numpy(), np.asarray(jcs["ref"]),
                                   rtol=2e-7, atol=1e-7)


def test_flat_sync_of_a_stack_selects_the_reference_per_run():
    """A stacked sync where one run has no arrival: that run keeps its
    reference and replicas (no NaN from m / 0 leaks), the others equal
    their own one-run syncs bitwise."""
    rng = np.random.default_rng(3)
    scheds = [taf.DelaySchedule(arrive=a, age=np.zeros((4, 1), np.float32),
                                n_periods=1, label=str(i))
              for i, a in enumerate((np.zeros((4, 1), np.float32),
                                     np.array([[1], [0], [1], [0]],
                                              np.float32),
                                     np.ones((4, 1), np.float32)))]
    strats = [taf.AsyncStrategy(tau=1, schedule=s) for s in scheds]
    x = rng.standard_normal((3, 4, 17)).astype(np.float32)
    stacked = stack_runs(strats)
    assert stacked.sync_weights.shape == (3, 4, 1)
    flat = torch.tensor(x)
    out, cs = stacked.flat_sync(flat, stacked.init_comm_state(flat), period=0)
    assert torch.isfinite(out).all() and torch.isfinite(cs["ref"]).all()
    for s, st in enumerate(strats):
        one = torch.tensor(x[s])
        o1, c1 = st.flat_sync(one, st.init_comm_state(one), period=0)
        assert torch.equal(out[s], o1) and torch.equal(cs["ref"][s], c1["ref"])
    assert torch.equal(out[0], torch.tensor(x[0]))


def test_flat_sync_requires_period_index():
    sched = taf.make_schedule("deterministic", 0.0, 3, 2, seed=0)
    strat = taf.AsyncStrategy(tau=2, schedule=sched)
    flat = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="period index"):
        strat.flat_sync(flat, strat.init_comm_state(flat))


# --- strategy construction / validation ----------------------------------------

def test_async_strategy_validation():
    sched = taf.make_schedule("geometric", 0.5, 4, 3, seed=0)
    with pytest.raises(TypeError, match="DelaySchedule"):
        taf.AsyncStrategy(tau=2, schedule="nope")
    with pytest.raises(ValueError, match="m=7"):
        taf.AsyncStrategy(tau=2, schedule=sched, m=7)
    with pytest.raises(ValueError, match="taus carries"):
        taf.AsyncStrategy(tau=2, schedule=sched, taus=np.ones(3, int))
    strat = taf.AsyncStrategy(tau=2, schedule=sched)
    assert strat.is_async and not strat.uniform_sync and strat.m == 4
    assert not PeriodicStrategy(tau=2, m=4).is_async
    with pytest.raises(NotImplementedError, match="per_period|span"):
        strat.comm_events_per_period()
    with pytest.raises(ValueError, match="schedule covers"):
        strat.validate_horizon(4)
    other = taf.AsyncStrategy(tau=2, schedule=taf.make_schedule(
        "geometric", 0.5, 4, 5, seed=0))
    with pytest.raises(ValueError, match="schedule horizon"):
        stack_runs([strat, other])


def test_async_strategy_rejects_compressed_comm():
    sched = taf.make_schedule("deterministic", 0.0, 3, 2, seed=0)
    strat = taf.AsyncStrategy(tau=2, schedule=sched)
    strat.with_comm(tcomm.identity())
    with pytest.raises(NotImplementedError, match="compressed"):
        strat.with_comm(tcomm.topk(4))
    with pytest.raises(NotImplementedError, match="compressed"):
        tmake("async", tau=2, schedule=sched, comm=tcomm.qint8())


def test_make_strategy_async_kind():
    u = jax_uniforms(0, 5, 4)
    ts = tmake("async", tau=3, schedule=taf.make_schedule(
        "heavytail", 1.5, 5, 4, uniforms=u), stale_decay=texp(0.9))
    js = jmake("async", tau=3, schedule=jaf.make_schedule(
        "heavytail", 1.5, 5, 4, seed=0), stale_decay=jexp(0.9),
        backend="jnp")
    assert isinstance(ts, taf.AsyncStrategy) and ts.name == js.name
    assert ts.name.startswith("async(heavytail(1.5)")
    np.testing.assert_array_equal(ts.sync_weights, np.asarray(js.sync_weights))
    np.testing.assert_array_equal(ts.stale_table, js.stale_table)
    np.testing.assert_array_equal(ts.mask, np.asarray(js.mask))
    with pytest.raises(TypeError, match="'async' takes no topo"):
        tmake("async", tau=3, schedule=ts.schedule, topo=object())


# --- ledger accounting ---------------------------------------------------------

def _payload(n=10):
    return n


def test_async_ledger_bills_exact_arrivals():
    sched = taf.make_schedule("geometric", 0.5, 5, 6, seed=11)
    strat = taf.AsyncStrategy(tau=3, schedule=sched)
    ledger = CostLedger()
    ledger.add_periods(strat, 6, _payload())
    assert ledger.c1_events == sched.total_arrivals() < 30
    assert ledger.c1_bytes == sched.total_arrivals() * 10 * 4
    assert ledger.c2_events == 5 * 3 * 6


def test_async_ledger_sequential_spans_are_disjoint():
    sched = taf.make_schedule("heavytail", 1.5, 4, 8, seed=5)
    strat = taf.AsyncStrategy(tau=2, schedule=sched)
    split = CostLedger()
    split.add_periods(strat, 3, _payload())
    split.add_periods(strat, 5, _payload())
    whole = CostLedger()
    whole.add_periods(strat, 8, _payload())
    assert split.c1_events == whole.c1_events == sched.total_arrivals()
    assert split.c1_bytes == whole.c1_bytes and split.periods_billed == 8


def test_async_partial_period_bills_no_uplinks():
    sched = taf.make_schedule("geometric", 0.5, 5, 4, seed=7)
    strat = taf.AsyncStrategy(tau=3, schedule=sched)
    ledger = CostLedger()
    ledger.add_periods(strat, 4, _payload())
    before = ledger.c1_events
    ledger.add_partial_period(strat, 2, _payload())
    assert ledger.c1_events == before
    assert ledger.c2_events == 5 * 3 * 4 + 5 * 2
    assert ledger.total_bytes() == sched.total_arrivals() * 10 * 4


def test_async_span_outside_schedule_raises():
    sched = taf.make_schedule("deterministic", 1.0, 3, 4, seed=0)
    strat = taf.AsyncStrategy(tau=2, schedule=sched)
    ledger = CostLedger()
    ledger.add_periods(strat, 4, _payload())
    with pytest.raises(ValueError, match="outside the schedule"):
        ledger.add_periods(strat, 1, _payload())


def test_uniform_strategy_accounting_unchanged():
    strat = PeriodicStrategy(tau=4, m=6)
    ledger = CostLedger()
    ledger.add_periods(strat, 3, _payload())
    ledger.add_periods(strat, 2, _payload())
    assert ledger.c1_events == 6 * 5 and ledger.c2_events == 6 * 4 * 5
    assert ledger.periods_billed == 5
    ledger.add_partial_period(strat, 2, _payload())
    assert ledger.c1_events == 6 * 6


@pytest.mark.parametrize("dist,param", FAMILIES)
def test_fedrl_ledger_async_end_to_end(dist, param):
    """``fedrl_ledger`` and the bytes curve of an async run, against JAX's
    on the same schedule: exact (3 boundaries and a partial period)."""
    jcfg, tcfg = _pair(dist, param)
    tl, jl = tfedrl.fedrl_ledger(tcfg), jfedrl.fedrl_ledger(jcfg)
    assert tl.table_row() == jl.table_row()
    assert tl.c1_events == tcfg.strategy.schedule.total_arrivals()
    assert tl.total_bytes() == tl.c1_events * \
        tfedrl.policy_payload_elems() * 4
    np.testing.assert_array_equal(tfedrl.fedrl_bytes_curve(tcfg),
                                  jfedrl.fedrl_bytes_curve(jcfg))
    # JAX's own ledger on a JAX-made ledger object agrees too
    jl2 = JLedger()
    jl2.add_periods(jcfg.strategy, N_PERIODS, 10)
    tl2 = CostLedger()
    tl2.add_periods(tcfg.strategy, N_PERIODS, 10)
    assert dataclasses.asdict(tl2) == dataclasses.asdict(jl2)


# --- whole runs ------------------------------------------------------------------

def test_fedrl_async_zero_delay_bitwise_vs_sync_eager():
    """Zero delay is the synchronous run, bit for bit, on the CPU."""
    _, tcfg = _pair("deterministic", 0.0)
    tper = dataclasses.replace(tcfg, strategy=tmake("periodic", tau=TAU, m=M))
    for seed in SEEDS:
        sa, ma, la = tfedrl.run_fedrl(tcfg, seed, device="cpu")
        sp, mp, lp = tfedrl.run_fedrl(tper, seed, device="cpu")
        for k in mp:
            np.testing.assert_array_equal(ma[k], mp[k], err_msg=k)
        for h in ("pi", "vf"):
            for k, v in sp[h].items():
                assert torch.equal(sa[h][k], v), f"{h}/{k}"
        # every boundary arrives, but the trailing partial period bills no
        # uplinks on the async path (the uniform path polls every replica)
        assert la.c1_events == M * N_PERIODS == lp.c1_events - M


def test_fedrl_async_delayed_matches_jax(jax_runs):
    """A geometric(0.5) schedule with exponential(0.8) staleness weights:
    the port on JAX's replayed draws within rtol 1e-4; ledgers exact."""
    jcfg, tcfg, (jserver, jm, jledger) = jax_runs["delayed"]
    draws = ReplayDraws(*jax_runs["draws"][0])
    tserver, tm, tledger = tfedrl.run_fedrl(tcfg, draws, device="cpu")
    assert 0 < jledger.c1_events < M * N_PERIODS
    assert np.any((tcfg.strategy.sync_weights > 0)
                  & (tcfg.strategy.sync_weights < 1))
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)
    for h in ("pi", "vf"):
        for k, v in jserver[h].items():
            np.testing.assert_allclose(tserver[h][k].detach().numpy(),
                                       np.asarray(v), rtol=0, atol=1e-4,
                                       err_msg=f"{h}/{k}")
    assert tledger.table_row() == jledger.table_row()


def test_fedrl_async_horizon_guard():
    sched = taf.make_schedule("deterministic", 0.0, M, 2, seed=0)
    cfg = TConfig(env=TF8, strategy=taf.AsyncStrategy(tau=TAU, schedule=sched),
                  **COMMON)
    with pytest.raises(ValueError, match="schedule covers 2"):
        tfedrl.run_fedrl(cfg, 0, device="cpu")


def test_fedrl_async_keeps_moments_local(monkeypatch):
    """An async boundary does not average the optimizer state; a periodic
    one does (JAX ``fedrl.py:449``)."""
    from repro_torch.optim import flat_momentum

    calls = []
    monkeypatch.setattr(tfedrl, "server_average_state",
                        lambda strat, state: calls.append(strat.name))
    _, tcfg = _pair("geometric", 0.5)
    tcfg = dataclasses.replace(tcfg, optimizer=flat_momentum(0.9))
    _, m, _ = tfedrl.run_fedrl(tcfg, 0, device="cpu")
    assert calls == [] and np.all(np.isfinite(m["server_grad_sq_norm"]))
    tper = dataclasses.replace(tcfg, strategy=tmake("periodic", tau=TAU, m=M))
    tfedrl.run_fedrl(tper, 0, device="cpu")
    assert len(calls) == N_PERIODS


# --- sweep axes ----------------------------------------------------------------

def test_delay_axis_requires_async_strategy():
    cfg = TConfig(env=TF8, strategy=PeriodicStrategy(tau=2, m=7),
                  n_epochs=1, epoch_len=4, minibatch=2)
    with pytest.raises(TypeError, match="AsyncStrategy"):
        tov.override_delay(cfg, np.asarray([0.0, 1.0]))
    sched = taf.make_schedule("deterministic", 0.0, 7, 1, seed=0)
    acfg = dataclasses.replace(cfg, strategy=taf.AsyncStrategy(
        tau=2, schedule=sched))
    with pytest.raises(ValueError, match="2-vector"):
        tov.override_delay(acfg, np.asarray(1.0))
    with pytest.raises(ValueError, match="unknown distribution id"):
        tov.override_delay(acfg, np.asarray([5.0, 1.0]))


def test_delay_override_defaults_to_the_eval_seed_stream():
    """Without recorded or given uniforms a point draws
    ``delay_uniforms(cfg.eval_seed)``, as JAX draws
    ``delay_axis_key(cfg.eval_seed)``; the point's run carries its own
    concrete schedule and ledger."""
    _, tcfg = _pair("deterministic", 0.0)
    base = dataclasses.replace(tcfg, strategy=taf.AsyncStrategy(
        tau=TAU, schedule=taf.make_schedule("deterministic", 0.0, M,
                                            N_PERIODS, seed=1234)))
    got = tov.override_delay(base, np.asarray([1.0, 0.5], np.float32))
    want = taf.make_schedule("geometric", 0.5, M, N_PERIODS,
                             seed=base.eval_seed)
    np.testing.assert_array_equal(got.strategy.schedule.arrive, want.arrive)
    assert got.strategy.schedule.label == want.label
    assert tfedrl.fedrl_ledger(got).c1_events == want.total_arrivals()
    u = jax_uniforms(3, M, N_PERIODS)
    got = tov.override_delay(base, np.asarray([1.0, 0.5]), uniforms=u)
    np.testing.assert_array_equal(
        got.strategy.schedule.arrive,
        taf.make_schedule("geometric", 0.5, M, N_PERIODS, uniforms=u).arrive)


def _check_sweep(jax_runs, axis, points):
    tbase, jres = jax_runs[axis]
    spec = tsweep.SweepSpec(name=axis, base=tbase, seeds=SEEDS,
                            vmapped=(tsweep.SweepAxis(axis, points),),
                            run_fn=_replaying(jax_runs["draws"]))
    tres = tsweep.run_sweep(spec, device="cpu", warmup=False)
    jm, tm = jres.metrics["base"], tres.metrics["base"]
    assert set(tm) == set(jm)
    for k in jm:
        assert tm[k].shape == jm[k].shape == (3, 2, 2), k
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)
    return tbase


def test_delay_axis_matches_jax_sweep(jax_runs):
    """The ``delay`` axis against JAX's ``run_sweep`` on replayed draws
    (the base schedule carries JAX's ``delay_axis_key(eval_seed)``
    uniforms); each point's ledger equals JAX's concrete schedule's."""
    tbase = _check_sweep(jax_runs, "delay", DELAY_POINTS)
    names = {0: "deterministic", 1: "geometric", 2: "heavytail"}
    for dist_id, param in DELAY_POINTS:
        tc = tov.override_delay(tbase, np.asarray([dist_id, param]))
        js = jaf.make_schedule(names[int(dist_id)], param, M, N_PERIODS,
                               seed=tbase.eval_seed)
        np.testing.assert_array_equal(tc.strategy.schedule.arrive, js.arrive)
        jc, _ = _cfgs(js, tc.strategy.schedule)
        assert tfedrl.fedrl_ledger(tc).table_row() == \
            jfedrl.fedrl_ledger(jc).table_row()


def test_k_axis_requires_kofm_base():
    cfg = TConfig(env=TF8, strategy=PeriodicStrategy(tau=2, m=7),
                  n_epochs=1, epoch_len=4, minibatch=2)
    with pytest.raises(TypeError, match="AsyncStrategy"):
        tov.override_k(cfg, np.asarray(3.0))
    sched = taf.make_schedule("geometric", 0.5, 7, 1, seed=0)
    acfg = dataclasses.replace(cfg, strategy=taf.AsyncStrategy(
        tau=2, schedule=sched))
    with pytest.raises(ValueError, match="K-of-m"):
        tov.override_k(acfg, np.asarray(3.0))


def test_k_axis_matches_jax_sweep(jax_runs):
    """The ``k`` axis against JAX's ``run_sweep`` on replayed draws; each
    point's schedule equals JAX's ``kofm_schedule`` of that size."""
    tbase = _check_sweep(jax_runs, "k", K_POINTS)
    for k in K_POINTS:
        tc = tov.override_k(tbase, np.float32(k))
        js = jaf.kofm_schedule(M, N_PERIODS, int(k), dist="geometric",
                               param=0.5, seed=tbase.eval_seed)
        np.testing.assert_array_equal(tc.strategy.schedule.arrive, js.arrive)
        np.testing.assert_array_equal(tc.strategy.schedule.age, js.age)
        assert tc.strategy.schedule.k == int(k)


@pytest.mark.parametrize("axis", ["delay", "k"])
def test_async_sweeps_equal_their_loop_bitwise(axis):
    """Batched == loop on the CPU with TorchDraws seeds, over both async
    axes (the delay axis with staleness weights)."""
    if axis == "delay":
        u = taf.delay_uniforms(1234, M, N_PERIODS)
        base = taf.AsyncStrategy(tau=TAU, schedule=taf.make_schedule(
            "deterministic", 0.0, M, N_PERIODS, uniforms=u),
            stale_decay=texp(0.8))
        points = DELAY_POINTS + ((1.0, 0.2),)
    else:
        base = taf.AsyncStrategy(tau=TAU, schedule=taf.kofm_schedule(
            M, N_PERIODS, 3, seed=1234))
        points = K_POINTS
    spec = tsweep.SweepSpec(name=axis, base=TConfig(env=TF8, strategy=base,
                                                    **COMMON),
                            seeds=(5, 6), vmapped=(tsweep.SweepAxis(axis,
                                                                    points),))
    batched = tsweep.run_sweep(spec, device="cpu", warmup=False)
    loop = tsweep.run_sweep_loop(spec, device="cpu", warmup=False)
    for k, v in batched.metrics["base"].items():
        np.testing.assert_array_equal(v, loop.metrics["base"][k], err_msg=k)
        assert np.all(np.isfinite(v)) and v.shape == (len(points), 2, 2)


# --- the committed artifacts ----------------------------------------------------

def _read(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("jax_name,port_name", [
    ("fig_async", "torch_fig_async"),
    *((f"ref_{fig}.streams", f"torch_{fig}.streams") for fig in (
        "fig4_variation", "fig5_decay", "fig6_consensus", "fig_async")),
])
def test_committed_async_and_stream_csvs_keep_jax_schema(jax_name,
                                                         port_name):
    """The port's async figure against the committed JAX one, and each
    one-stream-per-run CSV against its JAX counterpart: the same columns,
    (config, epoch) rows and seed counts, every ``bytes`` entry equal,
    finite values."""
    bench = os.path.join(ROOT, "experiments", "bench")
    jrows = _read(os.path.join(bench, f"{jax_name}.csv"))
    trows = _read(os.path.join(bench, f"{port_name}.csv"))
    assert list(trows[0]) == list(jrows[0])
    key = lambda r: (r["config"], int(r["epoch"]))
    assert sorted(map(key, trows)) == sorted(map(key, jrows))
    jby = {key(r): r for r in jrows}
    for r in trows:
        assert r["n_seeds"] == jby[key(r)]["n_seeds"] == "4"
        if "bytes" in r:
            assert float(r["bytes"]) == float(jby[key(r)]["bytes"])
        for col in ("nas", "nas_ci_hw", "grad_norm", "grad_norm_ci_hw"):
            assert np.isfinite(float(r[col])), (port_name, key(r), col)
