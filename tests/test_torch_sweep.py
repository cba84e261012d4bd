"""Port parity, the sweep slice as a whole: ``repro_torch.sweep.run_sweep``
against the JAX package's ``repro.sweep.run_sweep``.

JAX's sweep run i is ``run_fedrl_core(cfg_i, jax.random.key(seed_i))``
(``src/repro/sweep/runner.py:100-109``), so each run's draws are
``test_torch_fedrl.jax_draws(cfg_i, key(seed_i))``; the port's batched run
replays them, run by run, through a ``run_fn`` of ``ReplayDraws``. Grids of
S = 4 runs (2 axis points x 2 seeds), 2 epochs of 40 steps on FIGURE_EIGHT
(m = 7, the figures' shared env; the fleet case at m = 3): a lambda axis
(decay), an eps axis (dense and sparse consensus), a taus axis (periodic)
and an eta axis under momentum, and a lambda axis on a fleet.

Tolerances, as ``tests/test_torch_fedrl.py``: per-epoch ``nas``, ``loss``
and ``server_grad_sq_norm`` within rtol 1e-4; each run's ledger and bytes
curve exactly. Inside the port, the batched run equals the loop of one-run
calls bitwise on the CPU (each run draws from its own source in its own
order), also for the fleet's hetero_scale axis and a top-k compression
point. ``with_mask``, ``make_fleet`` and ``override_hetero_scale`` are held
against JAX's on JAX's direction draws. The committed ``torch_fig*`` CSVs
keep the JAX artifacts' columns, configs, epochs and bytes.
"""
import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import sweep as jsweep
from repro.core import make_strategy as jmake
from repro.core import topology as jtop
from repro.core.decay import exponential_decay as jexp
from repro.optim.flat import flat_momentum as jmom
from repro.rl import FIGURE_EIGHT as JF8
from repro.rl import FedRLConfig as JConfig
from repro.rl import fedrl as jfedrl
from repro.rl import scenarios as jscen
from repro.rl.env import HETERO_FIELDS
from repro.sweep import overrides as jov
from repro_torch import comm as tcomm
from repro_torch import sweep as tsweep
from repro_torch.core import make_strategy as tmake
from repro_torch.core import topology as ttop
from repro_torch.core.decay import exponential_decay as texp
from repro_torch.optim import flat_momentum as tmom
from repro_torch.rl import FIGURE_EIGHT as TF8
from repro_torch.rl import FedRLConfig as TConfig
from repro_torch.rl import ReplayDraws
from repro_torch.rl import fedrl as tfedrl
from repro_torch.rl import scenarios as tscen
from repro_torch.sweep import overrides as tov
from test_torch_fedrl import jax_draws

SEEDS = (0, 1)
COMMON = dict(n_epochs=2, epoch_len=40, minibatch=10, eta=5e-3)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(kind, opt=None, m=7, **kw):
    jkw, tkw = dict(tau=3, m=m), dict(tau=3, m=m)
    if kind == "decay":
        jkw["decay"], tkw["decay"] = jexp(0.95), texp(0.95)
    if kind == "consensus":
        jkw["topo"] = jtop.random_regularish(m, 3, 4, 0)
        tkw["topo"] = ttop.random_regularish(m, 3, 4, 0)
        jkw["eps"] = tkw["eps"] = 0.9 / tkw["topo"].max_degree
        jkw["sparse"] = tkw["sparse"] = kw.pop("sparse", False)
    common = dict(COMMON, **kw)
    return (JConfig(env=JF8, strategy=jmake(kind, backend="jnp", **jkw),
                    optimizer=jmom(0.9) if opt else None, **common),
            TConfig(env=TF8, strategy=tmake(kind, **tkw),
                    optimizer=tmom(0.9) if opt else None, **common))


sp7 = ttop.random_regularish(7, 3, 4, 0)
GRIDS = {
    "lam": (dict(kind="decay"), ("lam", (0.98, 0.92))),
    "eps-dense": (dict(kind="consensus"),
                  ("eps", (0.3 / sp7.max_degree, 0.9 / sp7.max_degree))),
    "eps-sparse": (dict(kind="consensus", sparse=True),
                   ("eps", (0.3 / sp7.max_degree, 0.9 / sp7.max_degree))),
    "taus": (dict(kind="periodic"),
             ("taus", ((3.0, 3.0, 3.0, 2.0, 2.0, 1.0, 1.0), (3.0,) * 7))),
    "eta-momentum": (dict(kind="periodic", opt="momentum"),
                     ("eta", (1e-3, 5e-3))),
    "fleet-lam": (dict(kind="decay", m=3, num_envs=1), ("lam", (0.98, 0.92))),
}


@pytest.fixture(scope="module")
def jax_sweeps():
    """The JAX package's sweeps and the runs' draws, once per module."""
    out = {}
    for name, (pair_kw, (axis, values)) in GRIDS.items():
        jcfg, tcfg = _pair(**dict(pair_kw))
        jspec = jsweep.SweepSpec(name=name, base=jcfg, seeds=SEEDS,
                                 vmapped=(jsweep.SweepAxis(axis, values),))
        draws = {s: ReplayDraws(*jax_draws(jcfg, jax.random.key(s)))
                 for s in SEEDS}
        out[name] = (jcfg, tcfg, jspec, jsweep.run_sweep(jspec), draws)
    return out


def _replaying(draws):
    def run(cfgs, seeds):
        return tfedrl.run_fedrl_batch(cfgs, [draws[s] for s in seeds],
                                      device="cpu")[1]
    return run


@pytest.mark.parametrize("grid", list(GRIDS))
def test_run_sweep_matches_jax_on_replayed_draws(jax_sweeps, grid):
    jcfg, tcfg, jspec, jres, draws = jax_sweeps[grid]
    axis = jspec.vmapped[0]
    tspec = tsweep.SweepSpec(name=grid, base=tcfg, seeds=SEEDS,
                             vmapped=(tsweep.SweepAxis(axis.name,
                                                       axis.values),),
                             run_fn=_replaying(draws))
    tres = tsweep.run_sweep(tspec, device="cpu", warmup=False)
    assert tres.mode == "vmapped" and tres.axes == jres.axes
    jm, tm = jres.metrics["base"], tres.metrics["base"]
    assert set(tm) == set(jm)
    for k in jm:
        assert tm[k].shape == jm[k].shape == (2, 2, 2), k
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)
    # each run's ledger and bytes curve, exactly
    for v in axis.values:
        v32 = np.asarray(v, np.float32)
        jc = jov.apply_overrides(jcfg, [axis.name], [jnp.asarray(v32)])
        tc = tov.apply_overrides(tcfg, [axis.name], [v32])
        assert tfedrl.fedrl_ledger(tc).table_row() == \
            jfedrl.fedrl_ledger(jc).table_row()
        np.testing.assert_array_equal(tfedrl.fedrl_bytes_curve(tc),
                                      jfedrl.fedrl_bytes_curve(jc))


def _loop_equals_batched(spec):
    batched = tsweep.run_sweep(spec, device="cpu", warmup=False)
    loop = tsweep.run_sweep_loop(spec, device="cpu", warmup=False)
    assert loop.mode == "loop" and batched.labels == loop.labels
    for label in batched.labels:
        for k, v in batched.metrics[label].items():
            np.testing.assert_array_equal(v, loop.metrics[label][k],
                                          err_msg=f"{label}/{k}")
            assert np.all(np.isfinite(v))
    return batched


def test_run_sweep_equals_its_loop_bitwise():
    """Batched == loop inside the port, with TorchDraws seeds: a lambda x
    eta grid on the decay strategy with Adam, and a static axis of a dense
    and a top-k uplink."""
    from repro_torch.optim import flat_adam

    _, tcfg = _pair("decay")

    spec = tsweep.SweepSpec(
        name="loop", base=dataclasses.replace(tcfg, optimizer=flat_adam()),
        seeds=(3, 4),
        vmapped=(tsweep.SweepAxis("lam", (0.98, 0.9)),
                 tsweep.SweepAxis("eta", (2e-3, 5e-3))),
        static=(tsweep.compression_axis([tcomm.identity(),
                                         tcomm.topk(584)]),))
    res = _loop_equals_batched(spec)
    assert res.labels == ["dense", "topk584"]
    assert res.metrics["dense"]["nas"].shape == (2, 2, 2, 2)


def test_fleet_hetero_scale_sweep_equals_its_loop_bitwise():
    """The fleet path folds the S runs' m agents into one S * m fleet; a
    (scale, dir_seed) hetero_scale axis and sparse gossip, batched == loop."""
    _, tcfg = _pair("consensus", m=7, num_envs=2, sparse=True)
    spec = tsweep.SweepSpec(
        name="fleet", base=tcfg, seeds=(0, 1),
        vmapped=(tsweep.SweepAxis("hetero_scale", ((0.0, 0.0), (0.3, 1.0))),
                 tsweep.SweepAxis("eps", (0.1, 0.2))))
    _loop_equals_batched(spec)


def test_with_mask_matches_jax():
    mask = np.asarray(
        np.arange(3)[None, :] < np.asarray([3, 3, 2, 2, 1, 1, 1])[:, None],
        np.float32)
    for sparse in (False, True):
        jc, tc = _pair("consensus", sparse=sparse)
        js = jc.strategy.with_mask(jnp.asarray(mask))
        ts = tc.strategy.with_mask(mask)
        np.testing.assert_array_equal(ts.mask, np.asarray(js.mask))
        if not sparse:
            for name in ("p_masked", "p_e_masked"):
                np.testing.assert_array_equal(
                    getattr(ts, name), np.asarray(getattr(js, name)), name)
        # the original keeps its tables and its device copies
        assert not np.array_equal(tc.strategy.mask, ts.mask)
        assert ts.__dict__.get("_on_device") is None
    _, tc = _pair("periodic")
    with pytest.raises(ValueError, match=r"mask must be \(7, 3\)"):
        tc.strategy.with_mask(np.ones((7, 4), np.float32))


def _jax_uniforms(key, m, fields=HETERO_FIELDS):
    """The U(-1, 1) directions JAX's perturb_params draws from ``key``."""
    keys = jax.random.split(key, len(fields))
    return np.stack([np.asarray(jax.random.uniform(k, (m,), minval=-1.0,
                                                   maxval=1.0)) for k in keys])


@pytest.mark.parametrize("name", sorted(jscen.SCENARIOS))
def test_make_fleet_matches_jax_on_jax_directions(name):
    sc = tscen.get_scenario(name)
    assert sc.cfg.name == name
    assert (sc.hetero_scale, sc.hetero_fields, sc.description) == (
        jscen.SCENARIOS[name].hetero_scale, jscen.SCENARIOS[name].hetero_fields,
        jscen.SCENARIOS[name].description)
    key = jax.random.key(7)
    jcfg, jp = jscen.make_fleet(name, 5, key)
    u = _jax_uniforms(key, 5, sc.hetero_fields)
    tcfg, tp = tscen.make_fleet(name, 5, uniforms=u)
    assert (tcfg.n_vehicles, tcfg.rl_indices, tcfg.length) == (
        jcfg.n_vehicles, jcfg.rl_indices, jcfg.length)
    for f in jp._fields:
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), rtol=2e-7,
                                   err_msg=f)
    with pytest.raises(ValueError, match="unknown scenario"):
        tscen.get_scenario("nope")


@pytest.mark.parametrize("point", [0.3, (0.3, 4.0)])
def test_hetero_scale_override_matches_jax_on_jax_directions(point):
    jc, tc = _pair("periodic", m=3, num_envs=1)
    key = jax.random.fold_in(jax.random.key(jc.eval_seed), tov.HETERO_FOLD)
    if np.ndim(point):
        key = jax.random.fold_in(key, int(point[1]))
    jp = jov.override_hetero_scale(jc, jnp.asarray(point, jnp.float32))
    tp = tov.override_hetero_scale(tc, np.asarray(point, np.float32),
                                   uniforms=_jax_uniforms(key, 3))
    for f in jp.env_params._fields:
        np.testing.assert_allclose(getattr(tp.env_params, f).numpy(),
                                   np.asarray(getattr(jp.env_params, f)),
                                   rtol=2e-7, err_msg=f)
    # without JAX's directions the port draws its own, reproducibly
    a = tov.override_hetero_scale(tc, np.asarray(point, np.float32))
    b = tov.override_hetero_scale(tc, np.asarray(point, np.float32))
    assert all(np.array_equal(x.numpy(), y.numpy())
               for x, y in zip(a.env_params, b.env_params))


# --- the committed figure artifacts -----------------------------------------------

FIGS = ("fig4_variation", "fig5_decay", "fig6_consensus")


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("fig", FIGS)
def test_committed_torch_figure_csvs_keep_jax_schema(fig):
    bench = os.path.join(ROOT, "experiments", "bench")
    jrows = _read(os.path.join(bench, f"{fig}.csv"))
    trows = _read(os.path.join(bench, f"torch_{fig}.csv"))
    assert list(trows[0]) == list(jrows[0])
    key = lambda r: (r["config"], int(r["epoch"]))
    assert sorted(map(key, trows)) == sorted(map(key, jrows))
    jby = {key(r): r for r in jrows}
    for r in trows:
        assert r["n_seeds"] == jby[key(r)]["n_seeds"]
        if "bytes" in r:
            assert float(r["bytes"]) == float(jby[key(r)]["bytes"])
        for col in ("nas", "nas_ci_hw", "grad_norm", "grad_norm_ci_hw"):
            assert np.isfinite(float(r[col])), (fig, key(r), col)
