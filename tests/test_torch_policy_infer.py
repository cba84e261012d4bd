"""Port parity: ``repro_torch`` policy_infer on the CPU against the JAX package.

The same numpy inputs go through ``repro.kernels.dispatch.policy_infer``
(``backend="jnp"``, and ``backend="interpret"``: the Pallas kernel body on
the CPU) and through the port's ``dispatch.policy_infer`` on CPU tensors,
which runs the plain PyTorch version. Both sides compute in fp32; only the
summation order of the matmuls differs (XLA's dot vs torch's CPU matmul).

Tolerance ``rtol 1e-5`` and ``atol 1e-6`` at the ``init_policy`` scales.
With unit-scale weights the 64-term pre-activation sums reach ~8, and fp32
itself is then off by a few ulp of 8 (ulp(8) = 9.5e-7) on each side, passed
through tanh' <= 1: there ``atol`` is ``max(1e-6, 3 x`` the fp32 plain
version's own error against its float64 evaluation on the same inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.rl.policy import init_policy as jax_init_policy
from repro_torch.kernels import dispatch
from repro_torch.kernels.policy_infer import (
    policy_infer_cuda,
    policy_infer_plain,
)
from repro_torch.rl.policy import params_from_jax

ATOL, RTOL = 1e-6, 1e-5


def _inputs(dims, batch, init, seed):
    """numpy pi head, norm stats, obs and noise for one case."""
    obs_dim, hidden, act_dim = dims
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    if init == "jax":
        tree = jax_init_policy(jax.random.key(seed), obs_dim, hidden=hidden,
                               act_dim=act_dim)
        pi = {k: np.array(v) for k, v in tree["pi"].items()}
    else:   # unit-scale weights: the tanh layers saturate
        pi = {"w1": f(obs_dim, hidden), "b1": f(hidden),
              "w2": f(hidden, hidden), "b2": f(hidden),
              "w3": f(hidden, act_dim), "b3": f(act_dim),
              "log_std": 0.3 * f(act_dim)}
    nm = 0.5 * f(obs_dim)
    ns = rng.uniform(0.5, 2.0, obs_dim).astype(np.float32)
    return pi, nm, ns, 2.0 * f(batch, obs_dim), f(batch, act_dim)


def _jax(pi, nm, ns, obs, noise, sample, backend, dtype=jnp.float32):
    out = jdispatch.policy_infer(
        jnp.asarray(obs, dtype), {k: jnp.asarray(v) for k, v in pi.items()},
        nm, ns, jnp.asarray(noise, dtype), sample=sample, backend=backend,
    )
    return np.asarray(out.astype(jnp.float32))


def _torch(pi, nm, ns, obs, noise, sample, dtype=torch.float32, out=None):
    return dispatch.policy_infer(
        torch.as_tensor(obs).to(dtype),
        {k: torch.as_tensor(v) for k, v in pi.items()},
        torch.as_tensor(nm), torch.as_tensor(ns), torch.as_tensor(noise).to(dtype),
        sample=sample, out=out,
    )


@pytest.mark.parametrize("backend", ["jnp", "interpret"])
@pytest.mark.parametrize("init", ["jax", "unit"])
@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("batch", [1, 37, 300])
@pytest.mark.parametrize("dims", [(6, 16, 2), (6, 64, 1)])
def test_cpu_path_matches_jax(dims, batch, sample, init, backend):
    pi, nm, ns, obs, noise = _inputs(dims, batch, init, seed=batch + 7)
    want = _jax(pi, nm, ns, obs, noise, sample, backend)
    got = _torch(pi, nm, ns, obs, noise, sample)
    assert got.dtype == torch.float32 and got.shape == (batch, dims[2])
    atol = ATOL
    if init == "unit":
        d = lambda a: torch.tensor(a, dtype=torch.float64)
        exact = policy_infer_plain(d(obs), {k: d(v) for k, v in pi.items()},
                                   d(nm), d(ns), d(noise), sample=sample)
        atol = max(ATOL, 3.0 * float((got.double() - exact).abs().max()))
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=RTOL)


@pytest.mark.parametrize("sample", [False, True])
def test_cpu_path_bf16_obs_matches_jax(sample):
    """bf16 obs/noise: fp32 inside, cast back to bf16 on both sides; the two
    casts may land one bf16 ulp (2^-7 relative) apart."""
    pi, nm, ns, obs, noise = _inputs((6, 64, 1), 37, "unit", seed=3)
    want = _jax(pi, nm, ns, obs, noise, sample, "jnp", jnp.bfloat16)
    got = _torch(pi, nm, ns, obs, noise, sample, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=1e-6, rtol=2.0 ** -7)


def test_out_receives_the_actions_in_place():
    pi, nm, ns, obs, noise = _inputs((6, 16, 2), 9, "unit", seed=4)
    buf = torch.tensor(noise)
    got = _torch(pi, nm, ns, obs, buf, True, out=buf)
    assert got.data_ptr() == buf.data_ptr()
    np.testing.assert_allclose(got.numpy(), _jax(pi, nm, ns, obs, noise, True,
                                                 "jnp"), atol=ATOL, rtol=RTOL)


def _bad_cases():
    pi, nm, ns, obs, noise = _inputs((6, 16, 2), 4, "unit", seed=5)
    no_w2 = {k: v for k, v in pi.items() if k != "w2"}
    return {
        "obs_width": (np.zeros((4, 7), np.float32), pi, nm, ns, noise),
        "noise_batch": (obs, pi, nm, ns, np.zeros((3, 2), np.float32)),
        "obs_rank": (obs[None], pi, nm, ns, noise),
        "missing_w2": (obs, no_w2, nm, ns, noise),
        "norm_shape": (obs, pi, nm[:5], ns, noise),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_rejects_what_jax_rejects(case):
    obs, pi, nm, ns, noise = _bad_cases()[case]
    with pytest.raises(ValueError):
        _jax(pi, nm, ns, obs, noise, False, "jnp")
    with pytest.raises(ValueError):
        _torch(pi, nm, ns, obs, noise, False)


def test_no_hidden_fallback_to_the_cpu():
    """Asking for the card on a host without one raises; the kernel wrapper
    never runs the plain version on a CPU tensor."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dispatch.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        dispatch.resolve_device()
    assert dispatch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        dispatch.resolve_device("meta")
    pi, nm, ns, obs, noise = _inputs((6, 16, 2), 4, "unit", seed=6)
    t = lambda a: torch.tensor(a)
    with pytest.raises(ValueError, match="CUDA device"):
        policy_infer_cuda(t(obs), {k: t(v) for k, v in pi.items()}, t(nm),
                          t(ns), t(noise))


def test_plain_version_is_policy_apply_on_normalized_obs():
    """The plain version is op for op the port's policy_apply after the
    normalization: bitwise within torch."""
    from repro_torch.rl.policy import policy_apply

    pi, nm, ns, obs, noise = _inputs((6, 64, 1), 37, "jax", seed=8)
    tp = {k: torch.tensor(v) for k, v in pi.items()}
    x = (torch.tensor(obs) - torch.tensor(nm)) / torch.tensor(ns)
    mean, log_std = policy_apply({"pi": tp}, x)
    got = policy_infer_plain(torch.tensor(obs), tp, torch.tensor(nm),
                             torch.tensor(ns), torch.tensor(noise))
    assert torch.equal(got, mean)
    got = policy_infer_plain(torch.tensor(obs), tp, torch.tensor(nm),
                             torch.tensor(ns), torch.tensor(noise), sample=True)
    assert torch.equal(got, mean + torch.exp(log_std) * torch.tensor(noise))


def test_params_from_jax_round_trip():
    from repro_torch.rl.policy import params_to_numpy

    tree = jax.tree.map(np.asarray, jax_init_policy(jax.random.key(2), 6,
                                                    hidden=16, act_dim=2))
    mod = params_from_jax(tree, device="cpu")
    assert "pi" in mod and "vf" in mod and sorted(mod) == ["pi", "vf"]
    assert tuple(mod["pi"]["w1"].shape) == (6, 16)     # (in, out), as in JAX
    back = params_to_numpy(mod)
    for head in ("pi", "vf"):
        assert sorted(back[head]) == sorted(tree[head])
        for k in tree[head]:
            np.testing.assert_array_equal(back[head][k], tree[head][k])
