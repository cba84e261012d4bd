"""Port parity: the task-generic FMARL driver (``run_fmarl``) against the JAX
package's, on replayed JAX draws.

The JAX driver draws each local step's noise from ``key, sub =
split(key); keys = split(sub, m)`` and one more ``split`` per period for
the evaluation (``src/repro/core/fmarl.py:152-154``, ``:204-206``, ``:172``,
``:235``); :func:`jax_noise` walks the same sequence and precomputes each
step's per-agent noise ``0.05 * normal(k_i, shape)`` (the closure of
``tests/test_system.py``), and the port's closure reads it by ``step``. A
batched run's closure tells its runs apart by ``gen.initial_seed()``.

Tolerances. The port has one carry, the flat one. Against JAX's flat carry
(the same ops: a fused ``p + (-eta * w) * g`` step, ``row_mean``; here on
the jnp backend with ``flat_sgd()``, or any run with an optimizer, a bf16
carry, a top-k uplink or an async strategy) the per-period metrics agree
within rtol 1e-5 and the final parameters within atol 1e-6 (2^-7, one
bf16 ulp at 1, with bf16 buffers); against JAX's tree-space jnp
reference (``p - eta * (w * g)``, a per-leaf mean) within rtol 1e-4 and
atol 1e-5, the figure ``tests/test_flat_loop.py:62`` allows between JAX's
own two paths. The ledgers are equal. A batched run equals its loop of
one-run calls bitwise on the CPU. The tree-space strategy methods and
``consensus_step_tree`` are held against JAX's jnp tree path at rtol 1e-6
(atol 1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.core import async_fed as jaf
from repro.core.accounting import CostLedger as JLedger
from repro.core import make_strategy as jmake
from repro.core import topology as jtop
from repro.core.decay import exponential_decay as jexp
from repro.core.fmarl import FmarlConfig as JConfig
from repro.core.fmarl import run_fmarl_core as jcore
from repro.kernels.ops import consensus_step_tree as jconsensus_tree
from repro.optim.flat import flat_adam as jadam
from repro.optim.flat import flat_momentum as jmom
from repro.optim.flat import flat_sgd as jsgd
from repro_torch import comm as tcomm
from repro_torch.core import async_fed as taf
from repro_torch.core import make_strategy as tmake
from repro_torch.core import topology as ttop
from repro_torch.core.decay import exponential_decay as texp
from repro_torch.core.fmarl import FmarlConfig as TConfig
from repro_torch.core.fmarl import (
    expected_gradient_norm,
    run_fmarl,
    run_fmarl_batch,
    run_fmarl_core,
)
from repro_torch.kernels.ops import consensus_step_tree
from repro_torch.optim import flat_adam, flat_momentum
from repro_torch.sweep import SweepAxis, SweepSpec, run_sweep, run_sweep_loop

M, TAU, N_PERIODS, ETA, SIGMA = 6, 4, 4, 0.05, 0.05
TAUS = np.array([4, 4, 3, 2, 2, 1])           # A2: non-increasing
# n = 8 * 9 + 7 = 79: no multiple of a kernel's vector width
SHAPES = {"b": (7,), "w": (8, 9)}
INIT = {k: np.ones(s, np.float32) for k, s in SHAPES.items()}
FLAT_RTOL, FLAT_ATOL = 1e-5, 1e-6
TREE_RTOL, TREE_ATOL = 1e-4, 1e-5


def jax_noise(seed, n_periods, tau, m=M, with_eval=True):
    """Each local step's ``{leaf: (m, ...)}`` noise as the JAX driver's
    closure draws it, in the driver's key order."""
    key = jax.random.key(seed)
    draw = jax.vmap(lambda k: {name: SIGMA * jax.random.normal(k, shape)
                               for name, shape in SHAPES.items()})
    steps = []
    for _ in range(n_periods):
        for _ in range(tau):
            key, sub = jax.random.split(key)
            steps.append({k: torch.tensor(np.asarray(v))
                          for k, v in draw(jax.random.split(sub, m)).items()})
        if with_eval:
            key, _ = jax.random.split(key)
    return steps


def jax_grad(p, k, i, step):
    g = jax.tree.map(lambda x: x + SIGMA * jax.random.normal(k, x.shape), p)
    return g, {"loss": sum(jnp.sum(x ** 2) for x in jax.tree.leaves(p))}


def jax_eval(p, k):
    return p


def replaying(noise_by_seed):
    """The port's closure over replayed draws: run seed -> step -> noise."""
    def grad_fn(params_m, agent_ids, step, gen):
        nz = noise_by_seed[gen.initial_seed()][step]
        g = {k: v + nz[k] for k, v in params_m.items()}
        loss = sum(torch.sum(v ** 2, dim=tuple(range(1, v.ndim)))
                   for v in params_m.values())
        return g, {"loss": loss}
    return grad_fn


def seeded(params_m, agent_ids, step, gen):
    """A closure that draws its own noise from the run's generator."""
    g = {k: v + SIGMA * torch.randn(v.shape, generator=gen)
         for k, v in params_m.items()}
    return g, {"loss": sum(torch.sum(v ** 2, dim=tuple(range(1, v.ndim)))
                           for v in params_m.values())}


def t_eval(p, gen):
    return p


def _strategies(jax_backend="jnp"):
    """name -> (JAX strategy, port strategy)."""
    jt, tt = jtop.ring(M), ttop.ring(M)
    b = dict(backend=jax_backend)
    return {
        "sync": (jmake("sync", m=M, **b), tmake("sync", m=M)),
        "periodic": (jmake("periodic", tau=TAU, m=M, **b),
                     tmake("periodic", tau=TAU, m=M)),
        "variation": (jmake("periodic", tau=TAU, taus=TAUS, **b),
                      tmake("periodic", tau=TAU, taus=TAUS)),
        "decay": (jmake("decay", tau=TAU, taus=TAUS, decay=jexp(0.9), **b),
                  tmake("decay", tau=TAU, taus=TAUS, decay=texp(0.9))),
        "dense": (jmake("consensus", tau=TAU, topo=jt, eps=0.3, rounds=2,
                        taus=TAUS, **b),
                  tmake("consensus", tau=TAU, topo=tt, eps=0.3, rounds=2,
                        taus=TAUS)),
        "dense_unfused": (jmake("consensus", tau=TAU, topo=jt, eps=0.3,
                                rounds=2, taus=TAUS, fused=False, **b),
                          tmake("consensus", tau=TAU, topo=tt, eps=0.3,
                                rounds=2, taus=TAUS, fused=False)),
        "sparse": (jmake("consensus", tau=TAU, topo=jt, eps=0.3, rounds=2,
                         taus=TAUS, sparse=True, **b),
                   tmake("consensus", tau=TAU, topo=tt, eps=0.3, rounds=2,
                         taus=TAUS, sparse=True)),
    }


STRATEGIES = list(_strategies())


def jax_uniforms(seed, m, n_periods):
    return np.asarray(jax.random.uniform(
        jaf.delay_axis_key(seed), (m, n_periods), jnp.float32,
        minval=1e-6, maxval=1.0 - 1e-6))


def _extra_cases():
    """name -> (JAX config, port config): the flat-only features."""
    jd, td = _strategies()["decay"]
    jp, tp = _strategies()["periodic"]
    js = jaf.make_schedule("geometric", 0.5, M, N_PERIODS, seed=1234)
    ts = taf.make_schedule("geometric", 0.5, M, N_PERIODS,
                           uniforms=jax_uniforms(1234, M, N_PERIODS))
    base = dict(eta=ETA, n_periods=N_PERIODS)
    return {
        "momentum": (JConfig(strategy=jd, optimizer=jmom(0.9), **base),
                     TConfig(strategy=td, optimizer=flat_momentum(0.9),
                             **base)),
        "adam": (JConfig(strategy=jp, optimizer=jadam(), **base),
                 TConfig(strategy=tp, optimizer=flat_adam(), **base)),
        "bf16": (JConfig(strategy=jd, buffer_dtype="bfloat16", **base),
                 TConfig(strategy=td, buffer_dtype="bfloat16", **base)),
        "topk": (JConfig(strategy=jp.with_comm(jcomm.topk(24)), **base),
                 TConfig(strategy=tp.with_comm(tcomm.topk(24)), **base)),
        "async": (JConfig(strategy=jaf.AsyncStrategy(
                      tau=TAU, schedule=js, stale_decay=jexp(0.8),
                      backend="jnp"), **base),
                  TConfig(strategy=taf.AsyncStrategy(
                      tau=TAU, schedule=ts, stale_decay=texp(0.8)), **base)),
    }


SWEEP_SEEDS, SWEEP_ETAS = (0, 1, 2), (0.05, 0.02)


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX run of this module, compiled as one program (one compile
    instead of one per run): ``name -> (replicas, server, metrics, ledger
    row)`` with numpy leaves; ``("sweep", eta, seed)`` are the runs of the
    port's sweep (JAX's own ``tests/test_sweep.py`` holds its ``run_sweep``
    to these one-run calls)."""
    cases = {}
    for name, (js, _) in _strategies().items():
        cases[("tree", name)] = (JConfig(strategy=js, eta=ETA,
                                         n_periods=N_PERIODS), 0)
        cases[("flat", name)] = (JConfig(strategy=js, eta=ETA,
                                         n_periods=N_PERIODS,
                                         optimizer=jsgd()), 0)
    for name, (jcfg, _) in _extra_cases().items():
        cases[("flat", name)] = (jcfg, 0)
    jp = _strategies()["periodic"][0]
    for eta in SWEEP_ETAS:
        for seed in SWEEP_SEEDS:
            cases[("sweep", eta, seed)] = (
                JConfig(strategy=jp, eta=eta, n_periods=N_PERIODS), seed)
    names = list(cases)
    runs = jax.jit(lambda: [
        jcore(cases[k][0], INIT, jax_grad, jax.random.key(cases[k][1]),
              jax_eval) for k in names])()
    out = {}
    for k, (st, met) in zip(names, runs):
        ledger = JLedger()
        ledger.add_periods(cases[k][0].strategy, N_PERIODS, 79)
        out[k] = (_np_tree(st.params_m), _np_tree(st.server_params),
                  _np_tree(met), ledger.table_row())
    return out


@pytest.fixture(scope="module")
def noise():
    return {s: jax_noise(s, N_PERIODS, TAU) for s in SWEEP_SEEDS}


def _sync_noise(seed=0):
    return {seed: jax_noise(seed, N_PERIODS, 1)}


def _check(got, want, rtol, atol):
    (gp, gs, gm, gl), (wp, ws, wm, wl) = got, want
    np.testing.assert_allclose(gm["server_grad_sq_norm"],
                               wm["server_grad_sq_norm"], rtol=rtol, atol=0)
    np.testing.assert_allclose(gm["mean_aux"]["loss"], wm["mean_aux"]["loss"],
                               rtol=rtol, atol=0)
    for k in SHAPES:
        np.testing.assert_allclose(gp[k], wp[k], rtol=0, atol=atol)
        np.testing.assert_allclose(gs[k], ws[k], rtol=0, atol=atol)
    assert gl == wl


def _port(cfg, noise_by_seed):
    st, met, led = run_fmarl(cfg, INIT, replaying(noise_by_seed), 0, t_eval,
                             device="cpu")
    return (_np_tree(st.params_m), _np_tree(st.server_params), met,
            led.table_row())


@pytest.mark.parametrize("name", STRATEGIES)
def test_run_fmarl_matches_jax_flat_and_tree_paths(name, jax_runs, noise):
    ts = _strategies()[name][1]
    nz = _sync_noise() if name == "sync" else noise
    got = _port(TConfig(strategy=ts, eta=ETA, n_periods=N_PERIODS), nz)
    _check(got, jax_runs[("flat", name)], FLAT_RTOL, FLAT_ATOL)
    _check(got, jax_runs[("tree", name)], TREE_RTOL, TREE_ATOL)
    assert got[2]["server_grad_sq_norm"].shape == (N_PERIODS,)
    assert got[0]["w"].shape == (M, 8, 9) and got[1]["b"].shape == (7,)


@pytest.mark.parametrize("name", ["momentum", "adam", "bf16", "topk", "async"])
def test_run_fmarl_flat_features_match_jax(name, jax_runs, noise):
    tcfg = _extra_cases()[name][1]
    atol = 2.0 ** -7 if name == "bf16" else FLAT_ATOL
    _check(_port(tcfg, noise), jax_runs[("flat", name)], FLAT_RTOL, atol)


def test_async_horizon_is_validated():
    ts = taf.make_schedule("geometric", 0.5, M, 2, seed=3)
    cfg = TConfig(strategy=taf.AsyncStrategy(tau=TAU, schedule=ts), eta=ETA,
                  n_periods=3)
    with pytest.raises(ValueError, match="covers 2 periods"):
        run_fmarl(cfg, INIT, seeded, 0, device="cpu")


@pytest.mark.parametrize("name", ["decay", "dense", "sparse", "momentum"])
def test_batch_equals_its_loop_bitwise(name):
    """Three runs with their own learning rate and seed, as one batched
    run and as three one-run calls: every metric and parameter equal."""
    if name == "momentum":
        cfg = _extra_cases()["momentum"][1]
    else:
        cfg = TConfig(strategy=_strategies()[name][1], eta=ETA,
                      n_periods=N_PERIODS)
    cfgs = [dataclasses.replace(cfg, eta=e) for e in (0.05, 0.02, 0.05)]
    seeds = (3, 4, 5)
    st, met = run_fmarl_batch(cfgs, INIT, seeded, seeds, t_eval, device="cpu")
    for i, (c, s) in enumerate(zip(cfgs, seeds)):
        one, m1 = run_fmarl_core(c, INIT, seeded, s, t_eval, device="cpu")
        np.testing.assert_array_equal(met["server_grad_sq_norm"][i],
                                      m1["server_grad_sq_norm"])
        np.testing.assert_array_equal(met["mean_aux"]["loss"][i],
                                      m1["mean_aux"]["loss"])
        for k in SHAPES:
            assert torch.equal(st.params_m[k][i], one.params_m[k])
            assert torch.equal(st.server_params[k][i], one.server_params[k])
        assert st.gen[i].initial_seed() == s == one.gen.initial_seed()
    assert st.step == N_PERIODS * cfg.strategy.tau


def test_batch_refuses_configs_that_differ_in_structure():
    cfg = TConfig(strategy=_strategies()["periodic"][1], eta=ETA,
                  n_periods=N_PERIODS)
    with pytest.raises(ValueError, match="differs from config 0"):
        run_fmarl_batch([cfg, dataclasses.replace(cfg, n_periods=2)], INIT,
                        seeded, [0, 1], device="cpu")
    with pytest.raises(ValueError, match="one each"):
        run_fmarl_batch([cfg], INIT, seeded, [0, 1], device="cpu")
    with pytest.raises(ValueError, match="buffer_dtype"):
        TConfig(strategy=cfg.strategy, eta=ETA, n_periods=1,
                buffer_dtype="bfloat17")


def test_run_sweep_over_an_fmarl_base_matches_jax(jax_runs, noise):
    """``tests/test_sweep.py:361-395`` on the port: ``run_sweep`` with a
    ``run_fn`` over an ``FmarlConfig`` base (the eta axis x three seeds,
    one batched run) against JAX's runs on the same draws (its tree path:
    rtol 1e-4), and against the port's loop of one-run calls bitwise."""
    def run_fn(cfgs, seeds):
        met = run_fmarl_batch(cfgs, INIT, replaying(noise), seeds, t_eval,
                              device="cpu")[1]
        return {"grad_sq": met["server_grad_sq_norm"]}

    spec = SweepSpec(
        name="fmarl", seeds=SWEEP_SEEDS, run_fn=run_fn,
        base=TConfig(strategy=_strategies()["periodic"][1], eta=ETA,
                     n_periods=N_PERIODS),
        vmapped=(SweepAxis("eta", SWEEP_ETAS),))
    got = run_sweep(spec, device="cpu", warmup=False).metrics["base"]
    assert got["grad_sq"].shape == (2, 3, N_PERIODS)
    want = np.asarray([[jax_runs[("sweep", e, s)][2]["server_grad_sq_norm"]
                        for s in SWEEP_SEEDS] for e in SWEEP_ETAS])
    np.testing.assert_allclose(got["grad_sq"], want, rtol=TREE_RTOL, atol=0)
    loop = run_sweep_loop(spec, device="cpu", warmup=False).metrics["base"]
    np.testing.assert_array_equal(got["grad_sq"], loop["grad_sq"])


def test_quadratic_converges_and_bills_eq7():
    """``tests/test_system.py:29-40`` on the port (its own draws)."""
    strat = tmake("periodic", tau=5, m=6)
    cfg = TConfig(strategy=strat, eta=0.1, n_periods=30)
    init = {"w": torch.ones(8, 8), "b": torch.ones(8)}
    state, metrics, ledger = run_fmarl(cfg, init, seeded, 0, t_eval,
                                       device="cpu")
    norms = metrics["server_grad_sq_norm"]
    assert norms[-1] < norms[0] * 1e-2
    assert ledger.c1_events == 6 * 30
    assert ledger.c2_events == 6 * 5 * 30
    assert ledger.c1_bytes == 6 * 30 * 72 * 4
    assert expected_gradient_norm(metrics) == pytest.approx(float(np.mean(
        norms)))
    assert state.step == 150


def test_without_eval_only_mean_aux():
    cfg = TConfig(strategy=tmake("periodic", tau=2, m=3), eta=ETA, n_periods=2)
    _, metrics, _ = run_fmarl(cfg, INIT, seeded, 0, device="cpu")
    assert set(metrics) == {"mean_aux"}
    assert metrics["mean_aux"]["loss"].shape == (2,)


def test_cuda_is_the_default_device():
    cfg = TConfig(strategy=tmake("periodic", tau=2, m=3), eta=ETA, n_periods=1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_fmarl(cfg, INIT, seeded, 0)


# --- tree-space strategy methods -------------------------------------------------

def _trees(seed):
    rng = np.random.default_rng(seed)
    j = {k: rng.standard_normal((M,) + s).astype(np.float32)
         for k, s in SHAPES.items()}
    return ({k: jnp.asarray(v) for k, v in j.items()},
            {k: torch.from_numpy(v.copy()) for k, v in j.items()})


def _close(got, want, rtol=1e-6, atol=1e-6):
    for k in SHAPES:
        assert tuple(got[k].shape) == tuple(np.shape(want[k]))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", STRATEGIES)
def test_tree_space_methods_match_jax_tree_path(name):
    js, ts = _strategies()[name]
    jg, tg = _trees(1)
    jp, tp = _trees(2)
    for offset in range(ts.tau):
        _close(ts.transform(tg, offset), js.transform(jg, offset))
        _close(ts.local_update(tp, tg, offset, ETA),
               js.local_update(jp, jg, offset, ETA))
    _close(ts.server_average(tp), js.server_average(jp))
    # the inputs are left as they were
    _close(tp, jp, 0, 0)


def test_local_update_refuses_a_mismatched_layout():
    ts = _strategies()["periodic"][1]
    _, tp = _trees(0)
    with pytest.raises(ValueError, match="does not match the layout"):
        ts.local_update(tp, {"w": tp["w"]}, 0, ETA)


def test_consensus_step_tree_matches_jax():
    jg, tg = _trees(3)
    mix = jtop.mixing_matrix(jtop.ring(M), 0.3).astype(np.float32)
    _close(consensus_step_tree(tg, mix), jconsensus_tree(jg, jnp.asarray(mix)))
