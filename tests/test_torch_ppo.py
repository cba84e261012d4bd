"""Port parity: the policy head, GAE, the three losses and their gradients.

Per-agent JAX parameters (``repro.rl.policy.init_policy`` with one key per
agent, nudged off their init so every term is live) are stacked into the
port's flat ``(m, n)`` matrix; numpy transition batches go through JAX's
``value_and_grad`` of each loss per agent and through the port's stacked
losses and one autograd ``backward``. JAX's action noise and minibatch
permutations are drawn with its keys and handed to the port.

Tolerances: elementwise results (sampled actions, log densities) rtol 1e-6 /
atol 1e-6; GAE (a P-step recurrence) and the losses (sums over D
transitions) rtol 1e-5; gradients rtol 1e-5 with atol 1e-5 of the gradient's
largest entry, since XLA and torch take the batched sums in another order.
"""
import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl import policy as jpol
from repro.rl import ppo as jppo
from repro_torch.kernels import dispatch as td
from repro_torch.rl import policy as tpol
from repro_torch.rl import ppo as tppo

M, D = 3, 24


def _agent_trees():
    trees = []
    for i in range(M):
        t = jpol.init_policy(jax.random.key(i), 6)
        # nudge off init: biases and pi.w3 are not zero / tiny any more
        t = jax.tree.map(lambda x, k=i: x + 0.1 * jax.random.normal(
            jax.random.key(100 + k), x.shape), t)
        trees.append(t)
    return trees


def _stacked(trees):
    stacked = {h: {k: torch.tensor(np.stack([np.asarray(t[h][k])
                                             for t in trees]))
                   for k in trees[0][h]} for h in ("pi", "vf")}
    return td.stacked_ravel_spec(stacked)


def _traj(seed, m=M, d=D):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"obs": f(m, d, 6), "act": f(m, d, 1), "logp_old": f(m, d) - 1.0,
            "adv": f(m, d), "ret": f(m, d)}


def _row(tree):
    return np.asarray(jax.flatten_util.ravel_pytree(tree)[0])


def test_gae_matches_jax():
    rng = np.random.default_rng(0)
    r, v = rng.standard_normal((2, 4, 25)).astype(np.float32)
    lv = rng.standard_normal(4).astype(np.float32)
    adv, ret = tppo.gae(torch.tensor(r), torch.tensor(v), torch.tensor(lv),
                        gamma=0.99, lam=0.95)
    for i in range(4):
        ja, jr = jppo.gae(jnp.asarray(r[i]), jnp.asarray(v[i]), lv[i],
                          gamma=0.99, lam=0.95)
        np.testing.assert_allclose(adv[i].numpy(), ja, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ret[i].numpy(), jr, rtol=1e-5, atol=1e-6)


def test_sample_action_and_heads_match_jax():
    trees = _agent_trees()
    flat, spec = _stacked(trees)
    params = spec.unravel(flat)
    obs = _traj(1)["obs"][:, :5]
    keys = jax.random.split(jax.random.key(9), M * 5).reshape(M, 5)
    normal = jax.vmap(lambda k: jax.random.normal(k, (1,)))
    for i in range(M):
        noise = np.asarray(normal(keys[i]))
        ja, jl = jax.vmap(jpol.sample_action, in_axes=(None, 0, 0))(
            trees[i], obs[i], keys[i])
        act, logp = tpol.sample_action(
            {h: {k: v[i:i + 1] for k, v in params[h].items()} for h in params},
            torch.tensor(obs[i:i + 1]), torch.tensor(noise[None]))
        np.testing.assert_allclose(act[0].numpy(), ja, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(logp[0].numpy(), jl, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            tpol.policy_value(params, torch.tensor(obs))[i].numpy(),
            jpol.policy_value(trees[i], obs[i]), rtol=1e-6, atol=1e-6)
    ls = torch.tensor([-0.5, 0.25])
    np.testing.assert_allclose(tpol.gaussian_entropy(ls).item(),
                               jpol.gaussian_entropy(jnp.asarray(ls.numpy())),
                               rtol=1e-7)
    np.testing.assert_allclose(tpol.tsallis2_entropy(ls).item(),
                               jpol.tsallis2_entropy(jnp.asarray(ls.numpy())),
                               rtol=1e-6)


@pytest.mark.parametrize("algo", ["ppo", "trpo", "tac"])
def test_losses_and_gradients_match_jax(algo):
    trees = _agent_trees()
    flat, spec = _stacked(trees)
    traj = _traj(2)
    # logp_old near the current policy's, so ratios straddle the clip range
    mean = tpol.policy_apply(spec.unravel(flat), torch.tensor(traj["obs"]))[0]
    act = mean.detach().numpy() + 0.3 * traj["act"]
    logp = tpol.gaussian_logp(torch.tensor(act), mean,
                              spec.unravel(flat)["pi"]["log_std"][:, None, :])
    traj["act"] = act.astype(np.float32)
    traj["logp_old"] = (logp.detach().numpy()
                        + 0.3 * traj["logp_old"]).astype(np.float32)
    grads, losses = tppo.stacked_grad(tppo.LOSSES[algo], flat, spec,
                                      {k: torch.tensor(v)
                                       for k, v in traj.items()})
    assert grads.shape == (M, spec.n) and losses.shape == (M,)
    for i in range(M):
        ti = {k: jnp.asarray(v[i]) for k, v in traj.items()}
        jl, jg = jax.value_and_grad(jppo.LOSSES[algo])(trees[i], ti)
        jrow = _row(jg)
        np.testing.assert_allclose(losses[i].item(), float(jl), rtol=1e-5)
        np.testing.assert_allclose(grads[i].numpy(), jrow, rtol=1e-5,
                                   atol=1e-5 * np.abs(jrow).max())


def test_minibatch_epoch_grad_matches_jax():
    trees = _agent_trees()
    flat, spec = _stacked(trees)
    traj = _traj(3)
    epochs, nmb, lr = 2, 3, 5e-3
    keys = [jax.random.key(50 + i) for i in range(M)]
    perms = np.stack([
        np.stack([np.asarray(jax.random.permutation(k, D))
                  for k in jax.random.split(keys[i], epochs)])
        for i in range(M)])
    grads, losses = tppo.minibatch_epoch_grad(
        tppo.ppo_loss, flat, spec, {k: torch.tensor(v) for k, v in traj.items()},
        torch.tensor(perms), epochs=epochs, n_minibatches=nmb, lr=lr)
    for i in range(M):
        ti = {k: jnp.asarray(v[i]) for k, v in traj.items()}
        jg, jl = jppo.minibatch_epoch_grad(jppo.ppo_loss, trees[i], ti,
                                           keys[i], epochs=epochs,
                                           n_minibatches=nmb, lr=lr)
        jrow = _row(jg)
        np.testing.assert_allclose(losses[i].item(), float(jl), rtol=1e-5)
        # g = (p - p_new) / lr: a difference of parameters of size ~1 divided
        # by 5e-3, so an ulp of the parameters is 2.4e-5 of g
        np.testing.assert_allclose(grads[i].numpy(), jrow, rtol=1e-4,
                                   atol=1e-4 * np.abs(jrow).max())
    # one epoch of one minibatch is the plain gradient and draws nothing
    g1, _ = tppo.minibatch_epoch_grad(
        tppo.ppo_loss, flat, spec, {k: torch.tensor(v) for k, v in traj.items()})
    g2, _ = tppo.stacked_grad(tppo.ppo_loss, flat, spec,
                              {k: torch.tensor(v) for k, v in traj.items()})
    assert torch.equal(g1, g2)
    with pytest.raises(ValueError, match="minibatches"):
        tppo.minibatch_epoch_grad(tppo.ppo_loss, flat, spec,
                                  {k: torch.tensor(v) for k, v in traj.items()},
                                  torch.tensor(perms), epochs=2, n_minibatches=5)
