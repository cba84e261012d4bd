"""Port parity: the ring-road environments on the CPU against the JAX package.

The same draws (the reset jitter and the perturbation uniforms, drawn with
JAX's keys) and the same action sequences go through ``repro.rl.env`` and
``repro_torch.rl.env``; positions, speeds, observations, rewards and the
crash latch are compared at every step.

Tolerance: 4 fp32 ulp of the ring length on positions (atol 1.1e-4 m on
the 230 m ring, 3.3e-4 m on the 700 m one), 4 fp32 ulp of v_max on speeds
(3.8e-6 and 5.7e-6 m/s), 2e-6 on observations and rewards (values of order
1); boolean crash flags exactly. Both sides evaluate the same fp32
expressions; the sums over vehicles may round differently. JAX runs eagerly,
op by op: under jit XLA contracts multiply-adds into FMAs, and the IDM
dynamics amplify the 1-ulp differences that leaves over tens of steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl import env as jenv
from repro_torch.rl import env as tenv

SCENARIOS = {"figure_eight": (jenv.FIGURE_EIGHT, tenv.FIGURE_EIGHT),
             "merge": (jenv.MERGE, tenv.MERGE)}


def _jitter(key, n):
    return np.asarray(jax.random.uniform(key, (n,), minval=-0.2, maxval=0.2))


def _state_np(s):
    return [np.asarray(s.x), np.asarray(s.v), np.asarray(s.crashed)]


def _check_state(js, ts, cfg):
    jx, jv, jc = _state_np(js)
    ulps4 = 4 * float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(ts.x.numpy(), jx, rtol=0,
                               atol=ulps4 * cfg.length)
    np.testing.assert_allclose(ts.v.numpy(), jv, rtol=0,
                               atol=ulps4 * cfg.v_max)
    np.testing.assert_array_equal(ts.crashed.numpy(), jc)


def _actions(n_steps, n_rl, seed):
    rng = np.random.default_rng(seed)
    return (1.5 * rng.standard_normal((n_steps, n_rl))).astype(np.float32)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_reset_obs_and_steps_match_jax(name):
    jcfg, tcfg = SCENARIOS[name]
    u = _jitter(jax.random.key(7), jcfg.n_vehicles)
    js = jenv.env_reset(jcfg, jax.random.key(7))
    ts = tenv.env_reset(tcfg, torch.tensor(u))
    _check_state(js, ts, jcfg)
    step = lambda s, a: jenv.env_step(jcfg, s, a)
    obs = lambda s: jenv.get_obs(jcfg, s)
    for t, a in enumerate(_actions(80, jcfg.n_rl, 1)):
        np.testing.assert_allclose(tenv.get_obs(tcfg, ts).numpy(),
                                   np.asarray(obs(js)), rtol=0, atol=2e-6)
        js, jr, jc = step(js, jnp.asarray(a))
        ts, tr, tc = tenv.env_step(tcfg, ts, torch.tensor(a))
        _check_state(js, ts, jcfg)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                                   atol=2e-6)
        assert bool(tc) == bool(jc), t


def _ring_state(x, v):
    return (jenv.EnvState(jnp.asarray(x), jnp.asarray(v), jnp.zeros((), bool)),
            tenv.EnvState(torch.tensor(x), torch.tensor(v),
                          torch.tensor(False)))


def test_forced_crash_latches_the_penalty():
    cfg_j, cfg_t = SCENARIOS["figure_eight"]
    n = cfg_j.n_vehicles
    x = np.linspace(0.0, 220.0, n).astype(np.float32)
    x[4] = x[5] - 0.9                     # vehicle 4 almost on its leader
    v = np.full(n, 5.0, np.float32)
    v[4], v[5] = 8.0, 0.0
    js, ts = _ring_state(x, v)
    acts = np.zeros(cfg_j.n_rl, np.float32)
    for t in range(3):
        js, jr, jc = jenv.env_step(cfg_j, js, jnp.asarray(acts))
        ts, tr, tc = tenv.env_step(cfg_t, ts, torch.tensor(acts))
        _check_state(js, ts, cfg_j)
        assert bool(jc) == bool(tc)
        assert bool(ts.crashed) and float(tr) == float(jr) == -1.0
    assert float(jr) == -cfg_j.crash_penalty


def test_overtaking_guard_binds_the_same_way():
    cfg_j, cfg_t = SCENARIOS["merge"]
    n = cfg_j.n_vehicles
    x = np.linspace(50.0, 690.0, n).astype(np.float32)
    v = np.full(n, 6.0, np.float32)
    x[11] = x[12] - 0.3                   # fast follower just behind a
    v[11], v[12] = 12.0, 0.0              # stopped leader
    js, ts = _ring_state(x, v)
    acts = np.ones(cfg_j.n_rl, np.float32)
    jgaps = np.asarray(jenv._gaps(cfg_j, cfg_j.default_params(), js.x)[0])
    js, _, _ = jenv.env_step(cfg_j, js, jnp.asarray(acts))
    ts, _, _ = tenv.env_step(cfg_t, ts, torch.tensor(acts))
    _check_state(js, ts, cfg_j)
    # the guard bound v_11 <= gap_11 / dt + v_12 is what held vehicle 11 back
    bound = jgaps[11] / cfg_j.dt + float(ts.v[12])
    assert float(ts.v[11]) == pytest.approx(bound, abs=1e-5)
    assert float(ts.v[11]) < 12.0


def test_perturbed_fleet_params_and_batched_steps_match_jax():
    jcfg, tcfg = SCENARIOS["figure_eight"]
    m, B = 3, 2
    key = jax.random.key(11)
    fields = jenv.HETERO_FIELDS
    u = np.stack([np.asarray(jax.random.uniform(k, (m,), minval=-1.0,
                                                maxval=1.0))
                  for k in jax.random.split(key, len(fields))])
    jp = jenv.perturb_params(jcfg, key, m, scale=0.2)
    tp = tenv.perturb_params(tcfg, m, 0.2, uniforms=torch.tensor(u))
    for f in tenv.EnvParams._fields:
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), rtol=1e-7)
    same = tenv.perturb_params(tcfg, m, 0)
    assert all(torch.equal(l, l[:1].expand(m)) for l in same)
    with pytest.raises(ValueError, match="unknown fields"):
        tenv.perturb_params(tcfg, m, 0.2, fields=("nope",))
    # (m, B) batch: per-agent params, B envs each
    keys = jax.random.split(jax.random.key(5), m * B).reshape(m, B)
    jit_u = np.stack([np.stack([_jitter(keys[i, b], jcfg.n_vehicles)
                                for b in range(B)]) for i in range(m)])
    reset_one = lambda p, k: jenv.env_reset(jcfg, k, params=p)
    js = jax.vmap(jax.vmap(reset_one, in_axes=(None, 0)))(jp, keys)
    tpe = tenv.EnvParams(*(l[:, None] for l in tp))
    ts = tenv.env_reset(tcfg, torch.tensor(jit_u), params=tpe)
    _check_state(js, ts, jcfg)
    step_one = lambda p, s, a: jenv.env_step(jcfg, s, a, params=p)
    jstep = jax.vmap(jax.vmap(step_one, in_axes=(None, 0, 0)))
    jobs = jax.vmap(jax.vmap(
        lambda p, s: jenv.get_obs(jcfg, s, params=p), in_axes=(None, 0)))
    rng = np.random.default_rng(3)
    for _ in range(25):
        a = rng.uniform(-1.5, 1.5, (m, B, jcfg.n_rl)).astype(np.float32)
        np.testing.assert_allclose(tenv.get_obs(tcfg, ts, params=tpe).numpy(),
                                   np.asarray(jobs(jp, js)), rtol=0, atol=2e-6)
        js, jr, _ = jstep(jp, js, jnp.asarray(a))
        ts, tr, _ = tenv.env_step(tcfg, ts, torch.tensor(a), params=tpe)
        _check_state(js, ts, jcfg)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                                   atol=2e-6)


def test_broadcast_and_stack_params_match_jax():
    p = tenv.broadcast_params(tenv.FIGURE_EIGHT.default_params(), (4, 2))
    assert all(l.shape == (4, 2) and l.is_contiguous() for l in p)
    assert float(p.length[3, 1]) == 230.0
    cfgs = [(jenv.FIGURE_EIGHT, tenv.FIGURE_EIGHT), (jenv.MERGE, tenv.MERGE)]
    js = jenv.stack_params([j.default_params() for j, _ in cfgs])
    ts = tenv.stack_params([t.default_params() for _, t in cfgs])
    for f in tenv.EnvParams._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
