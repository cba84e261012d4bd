"""Port parity: fleet rollouts (and the shared-env rollout) against JAX.

A heterogeneous FIGURE_EIGHT fleet (m = 3 agents with perturbed dynamics, B =
2 envs each, per-agent policies) is rolled out P steps by
``repro.rl.rollout`` and by ``repro_torch.rl.rollout``. The port receives
JAX's draws: the reset jitter from ``fleet_reset``'s key and the action noise
from ``fleet_rollout``'s key discipline (per step ``key, sub = split(key)``,
``split(sub, m * B)`` row-major over (agent, env), then ``split(k, n_rl)``
per env and one ``normal(k, (1,))`` per vehicle).

Tolerance: every ``(m, B, P, ...)`` buffer within rtol 1e-5 / atol 1e-5
(XLA's compiled scan contracts multiply-adds; a few ulp per step over P = 8
steps, through the tanh policy and the IDM dynamics).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.rl import env as jenv
from repro.rl import fedrl as jfed
from repro.rl import policy as jpol
from repro.rl import rollout as jroll
from repro.core import make_strategy as jmake
from repro_torch.core import make_strategy as tmake
from repro_torch.kernels import dispatch as td
from repro_torch.rl import env as tenv
from repro_torch.rl import fedrl as tfed
from repro_torch.rl import rollout as troll

M, B, P = 3, 2, 8
TOL = dict(rtol=1e-5, atol=1e-5)


def _policies(m):
    trees = [jax.tree.map(lambda x, i=i: x + 0.05 * jax.random.normal(
        jax.random.key(40 + i), x.shape), jpol.init_policy(jax.random.key(i), 6))
        for i in range(m)]
    jstack = jax.tree.map(lambda *ls: jnp.stack(ls), *trees)
    tstack = {h: {k: torch.tensor(np.asarray(v)) for k, v in jstack[h].items()}
              for h in jstack}
    flat, spec = td.stacked_ravel_spec(tstack)
    return jstack, spec.unravel(flat)


def _fleet_noise(key, m, b, n_rl, steps):
    @jax.jit
    def step(key):
        key, sub = jax.random.split(key)
        eps = jax.vmap(lambda k: jax.vmap(lambda kv: jax.random.normal(
            kv, (1,)))(jax.random.split(k, n_rl)))(jax.random.split(sub, m * b))
        return key, eps.reshape(m, b, n_rl, 1)

    out = []
    for _ in range(steps):
        key, eps = step(key)
        out.append(np.asarray(eps))
    return np.stack(out)


def test_fleet_rollout_matches_jax():
    cfg_j, cfg_t = jenv.FIGURE_EIGHT, tenv.FIGURE_EIGHT
    n, n_rl = cfg_j.n_vehicles, cfg_j.n_rl
    pkey = jax.random.key(3)
    u = np.stack([np.asarray(jax.random.uniform(k, (M,), minval=-1.0,
                                                maxval=1.0))
                  for k in jax.random.split(pkey, len(jenv.HETERO_FIELDS))])
    jp = jenv.perturb_params(cfg_j, pkey, M, scale=0.2)
    tp = tenv.perturb_params(cfg_t, M, 0.2, uniforms=torch.tensor(u))
    jpolicy, tpolicy = _policies(M)

    rkey, key = jax.random.key(8), jax.random.key(9)
    jitter = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (n,), minval=-0.2, maxval=0.2))(jax.random.split(rkey, M * B)))
    js = jroll.fleet_reset(cfg_j, jp, rkey, B)
    ts = troll.fleet_reset(cfg_t, tp, torch.tensor(jitter.reshape(M, B, n)))
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), **TOL)

    js, jtraj = jroll.fleet_rollout(cfg_j, jp, jpolicy, js, key, P)
    noise = _fleet_noise(key, M, B, n_rl, P)
    with torch.no_grad():
        ts, ttraj = troll.fleet_rollout(cfg_t, tp, tpolicy, ts,
                                        torch.tensor(noise))
    for k in ("obs", "act", "logp_old", "val", "rew"):
        assert tuple(ttraj[k].shape) == jtraj[k].shape, k
        np.testing.assert_allclose(ttraj[k].numpy(), np.asarray(jtraj[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), **TOL)
    assert ttraj["obs"].shape == (M, B, P, n_rl, 6)

    with torch.no_grad():
        tlast = troll.fleet_last_values(cfg_t, tp, tpolicy, ts)
    jlast = jroll.fleet_last_values(cfg_j, jp, jpolicy, js)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)

    jadv, jret = jroll.fleet_gae(jtraj["rew"], jtraj["val"], jlast,
                                 gamma=0.99, lam=0.95)
    tadv, tret = troll.fleet_gae(ttraj["rew"], ttraj["val"], tlast,
                                 gamma=0.99, lam=0.95)
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), **TOL)
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), **TOL)

    jflat = jroll.fleet_flatten({"adv": jadv, "obs": jtraj["obs"]})
    tflat = troll.fleet_flatten({"adv": tadv, "obs": ttraj["obs"]})
    for k in jflat:
        assert tuple(tflat[k].shape) == jflat[k].shape
        np.testing.assert_allclose(tflat[k].numpy(), np.asarray(jflat[k]), **TOL)


def test_shared_env_rollout_matches_jax():
    """The legacy shared env (m = n_rl agents, vehicle i acting through
    replica i) with JAX's per-step ``split(sub, m)`` action keys."""
    cfg_j, cfg_t = jenv.FIGURE_EIGHT, tenv.FIGURE_EIGHT
    m = cfg_j.n_rl
    jpolicy, tpolicy = _policies(m)
    jcfg = jfed.FedRLConfig(env=cfg_j, strategy=jmake("periodic", tau=2, m=m),
                            epoch_len=P, minibatch=P)
    tcfg = tfed.FedRLConfig(env=cfg_t, strategy=tmake("periodic", tau=2, m=m),
                            epoch_len=P, minibatch=P)
    ekey, key = jax.random.key(1), jax.random.key(2)
    u = np.asarray(jax.random.uniform(ekey, (cfg_j.n_vehicles,), minval=-0.2,
                                      maxval=0.2))
    noise, k = [], key
    for _ in range(P):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.vmap(lambda kv: jax.random.normal(
            kv, (1,)))(jax.random.split(sub, m))))
    js, jtraj = jfed._rollout(jcfg, jpolicy, jenv.env_reset(cfg_j, ekey), key, P)
    with torch.no_grad():
        ts, ttraj = tfed._rollout(tcfg, cfg_t.default_params(), tpolicy,
                                  tenv.env_reset(cfg_t, torch.tensor(u)),
                                  torch.tensor(np.stack(noise)))
    for name in ("obs", "act", "logp_old", "val", "rew"):
        assert tuple(ttraj[name].shape) == jtraj[name].shape, name
        np.testing.assert_allclose(ttraj[name].numpy(), np.asarray(jtraj[name]),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0,
                               atol=4 * 1.2e-7 * cfg_j.length)
