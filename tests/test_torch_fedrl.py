"""Port parity, the whole slice: ``run_fedrl`` against the JAX package's.

The port's driver runs on the CPU with JAX's draws replayed through a
``ReplayDraws``: the initial parameters from ``init_policy(pk)``, the reset
jitter of every epoch, the action noise of every local update, the PPO
minibatch permutations and the fixed evaluation stream, each drawn with the
key the JAX driver uses for it (``fedrl.py:410, :473, :427``; the legacy
rollout's ``split(sub, m)`` action keys, the fleet's ``split(sub, m * B)`` /
``split(k, n_rl)``; ``ppo.py:117``'s ``split(key, epochs)`` permutations).
Short runs (2 epochs of 4 updates on FIGURE_EIGHT), so that no crash flip
separates the two trajectories: sync, periodic and decay, dense and sparse
consensus (E = 1 and 2) with SGD, momentum and Adam, and compressed runs
(a top-k uplink with error feedback, an int8 uplink, top-k gossip).

Tolerances: the per-epoch ``nas``, ``loss`` and ``server_grad_sq_norm``
within rtol 1e-4 (the figure ``tests/test_flat_loop.py`` allows between the
JAX package's own backends); the final server parameters within atol 1e-4
(Adam divides by sqrt(nu): where a gradient entry is near zero, a few-ulp
change in it moves that step by up to lr = 5e-3, so the parameters are held
more loosely than the metrics), plus one bf16 ulp (rtol 2^-7) with bf16
buffers, whose server row is bf16. The runs measured here agree to ~5e-7
(fp32) and ~1e-5 (bf16 buffers) in the metrics.
"""
import jax
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.core import make_strategy as jmake
from repro.core import topology as jtop
from repro.core.decay import exponential_decay as jexp
from repro.optim.flat import flat_adam as jadam
from repro.optim.flat import flat_momentum as jmom
from repro.rl import FIGURE_EIGHT as JF8
from repro.rl import FedRLConfig as JConfig
from repro.rl import run_fedrl as jrun
from repro.rl.env import OBS_DIM
from repro.rl.policy import init_policy as jinit
from repro_torch import comm as tcomm
from repro_torch.core import exponential_decay as texp
from repro_torch.core import topology as ttop
from repro_torch.core import make_strategy as tmake
from repro_torch.optim import flat_adam, flat_momentum
from repro_torch.rl import FIGURE_EIGHT as TF8
from repro_torch.rl import FedRLConfig as TConfig
from repro_torch.rl import ReplayDraws, TorchDraws, replay_of
from repro_torch.rl import run_fedrl as trun


def jax_draws(cfg, key):
    """Every draw ``repro.rl.run_fedrl(cfg, key)`` takes on its flat carry,
    in the port's order: ``(init, resets, noise, perms, eval)``."""
    m, P, n = cfg.strategy.m, cfg.minibatch, cfg.env.n_vehicles
    B, n_rl = cfg.B, cfg.env.n_rl
    d = B * P * n_rl
    shuffle = cfg.fleet and (cfg.ppo_epochs > 1 or cfg.n_minibatches > 1)
    uniform = lambda k: jax.random.uniform(k, (n,), minval=-0.2, maxval=0.2)
    normal = lambda k: jax.random.normal(k, (1,))

    @jax.jit
    def reset_u(k):
        if cfg.fleet:                           # rollout.py:45
            return jax.vmap(uniform)(jax.random.split(k, m * B)).reshape(m, B, n)
        return uniform(k)

    @jax.jit
    def noise(k):
        def step(key, _):
            key, sub = jax.random.split(key)
            if cfg.fleet:                       # rollout.py:64, :78
                per_env = lambda ke: jax.vmap(normal)(jax.random.split(ke, n_rl))
                eps = jax.vmap(per_env)(jax.random.split(sub, m * B))
                return key, eps.reshape(m, B, n_rl, 1)
            return key, jax.vmap(normal)(jax.random.split(sub, m))  # fedrl.py:151
        return jax.lax.scan(step, k, None, length=P)[1]

    @jax.jit
    def perms(gk):                              # fedrl.py:199, ppo.py:105,117
        agent = lambda k: jax.vmap(lambda ke: jax.random.permutation(ke, d))(
            jax.random.split(k, cfg.ppo_epochs))
        return jax.vmap(agent)(jax.random.split(gk, m))

    key, pk = jax.random.split(key)
    init = jax.tree.map(np.asarray, jinit(pk, OBS_DIM))
    resets, noises, perm_draws = [], [], []
    for _ in range(cfg.n_epochs):
        key, ek = jax.random.split(key)
        resets.append(np.asarray(reset_u(ek)))
        for _ in range(cfg.epoch_len // P):
            key, rk = jax.random.split(key)
            if cfg.fleet:
                rk, gk = jax.random.split(rk)
                if shuffle:
                    perm_draws.append(np.asarray(perms(gk)))
            noises.append(np.asarray(noise(rk)))
    k_reset, k_roll = jax.random.split(jax.random.key(cfg.eval_seed))
    if cfg.fleet:
        k_roll, _ = jax.random.split(k_roll)
    ev = {"reset": np.asarray(reset_u(k_reset)),
          "noise": np.asarray(noise(k_roll))}
    return init, resets, noises, perm_draws, ev


def _configs(kind, opt, m=7, backend="jnp", comm=None, gossip=None, **kw):
    """The same run for both packages. ``comm``: ``(transform factory,
    *args)`` of a payload transform; consensus runs on
    ``random_regularish(m, 3, 4, seed=0)`` with eps = 0.9 / Delta and the
    keywords ``gossip`` (``rounds``, ``sparse``)."""
    jkw, tkw = dict(tau=3, m=m), dict(tau=3, m=m)
    if kind == "sync":                  # sync takes m only
        del jkw["tau"], tkw["tau"]
    if comm is not None:
        jkw["comm"] = getattr(jcomm, comm[0])(*comm[1:])
        tkw["comm"] = getattr(tcomm, comm[0])(*comm[1:])
    if kind == "decay":
        jkw["decay"], tkw["decay"] = jexp(0.95), texp(0.95)
    if kind == "consensus":
        jkw["topo"] = jtop.random_regularish(m, 3, 4, 0)
        tkw["topo"] = ttop.random_regularish(m, 3, 4, 0)
        jkw["eps"] = tkw["eps"] = 0.9 / tkw["topo"].max_degree
        jkw.update(gossip or {})
        tkw.update(gossip or {})
    js, ts = jmake(kind, backend=backend, **jkw), tmake(kind, **tkw)
    jo = {"adam": jadam(), "momentum": jmom(0.9), None: None}[opt]
    to = {"adam": flat_adam(), "momentum": flat_momentum(0.9), None: None}[opt]
    common = dict(n_epochs=2, epoch_len=40, minibatch=10, eta=5e-3, **kw)
    return (JConfig(env=JF8, strategy=js, optimizer=jo, **common),
            TConfig(env=TF8, strategy=ts, optimizer=to, **common))


CASES = {
    "sync-sgd": dict(kind="sync", opt=None),
    "periodic-momentum": dict(kind="periodic", opt="momentum"),
    "decay-adam": dict(kind="decay", opt="adam"),
    "periodic-adam-bf16": dict(kind="periodic", opt="adam",
                               buffer_dtype="bfloat16"),
    "fleet-decay-momentum": dict(kind="decay", opt="momentum", m=3, num_envs=2,
                                 ppo_epochs=2, n_minibatches=2),
    "interpret-decay-adam": dict(kind="decay", opt="adam",
                                 backend="interpret"),
    "consensus-E1-sgd": dict(kind="consensus", opt=None),
    "consensus-E1-momentum": dict(kind="consensus", opt="momentum"),
    "consensus-E1-adam": dict(kind="consensus", opt="adam"),
    "consensus-E2-sgd": dict(kind="consensus", opt=None,
                             gossip=dict(rounds=2)),
    "consensus-E2-momentum": dict(kind="consensus", opt="momentum",
                                  gossip=dict(rounds=2)),
    "consensus-E2-adam": dict(kind="consensus", opt="adam",
                              gossip=dict(rounds=2)),
    "consensus-sparse-E2-adam": dict(kind="consensus", opt="adam",
                                     gossip=dict(rounds=2, sparse=True)),
    "periodic-topk584-momentum": dict(kind="periodic", opt="momentum",
                                      comm=("topk", 584)),
    "decay-int8-adam": dict(kind="decay", opt="adam", comm=("qint8",)),
    "consensus-topk584-sgd": dict(kind="consensus", opt=None,
                                  comm=("topk", 584)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_fedrl_matches_jax(case):
    jcfg, tcfg = _configs(**CASES[case])
    key = jax.random.key(3)
    init, resets, noise, perms, ev = jax_draws(jcfg, key)
    jserver, jm, jledger = jrun(jcfg, key)
    tserver, tm, tledger = trun(
        tcfg, ReplayDraws(init, resets, noise, perms, ev), device="cpu")
    assert set(tm) == set(jm)
    for k in jm:
        assert tm[k].shape == (2,) and tm[k].dtype == np.float32
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)
    # bf16 buffers: the server row itself is bf16, within one bf16 ulp
    rtol = 2.0 ** -7 if tcfg.buffer_dtype else 0.0
    for h in ("pi", "vf"):
        for k, v in jserver[h].items():
            np.testing.assert_allclose(tserver[h][k].detach().numpy(),
                                       np.asarray(v), rtol=rtol, atol=1e-4,
                                       err_msg=f"{h}/{k}")
    assert tledger.table_row() == jledger.table_row()


def test_replay_draws_refuse_what_the_run_does_not_take():
    _, tcfg = _configs("periodic", None)
    draws = replay_of(tcfg, TorchDraws(0, "cpu"))
    assert len(draws.noise) == 8 and len(draws.resets) == 2 and not draws.perms
    short = ReplayDraws(draws.init, draws.resets, draws.noise[:3], [],
                        draws.eval)
    with pytest.raises(IndexError, match="noise"):
        trun(tcfg, short, device="cpu")
    bad = ReplayDraws(draws.init, draws.resets,
                      [n[:, :, :1].repeat(1, 1, 2) for n in draws.noise], [],
                      draws.eval)
    with pytest.raises(ValueError, match="the run needs"):
        trun(tcfg, bad, device="cpu")


def test_a_seeded_run_repeats_itself():
    _, tcfg = _configs("decay", "adam")
    a = trun(tcfg, 5, device="cpu")
    b = trun(tcfg, 5, device="cpu")
    for k in a[1]:
        np.testing.assert_array_equal(a[1][k], b[1][k])
        assert np.all(np.isfinite(a[1][k]))
    for h in ("pi", "vf"):
        for k in a[0][h]:
            assert torch.equal(a[0][h][k], b[0][h][k])


def test_run_fedrl_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    _, tcfg = _configs("periodic", None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trun(tcfg, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trun(tcfg, 0, device="cuda")
