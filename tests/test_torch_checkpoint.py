"""Checkpoints move between the JAX package and the port, both ways.

``repro_torch.checkpoint`` is the port's own copy of ``repro.checkpoint.io``:
the same escaped flat-key ``.npz`` format, so for one tree both packages
write identical keys and arrays, and a serving checkpoint written by either
restores in the other and serves the same decisions (``atol 1e-6, rtol
1e-5``: fp32 on both sides, matmul summation order differs).
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jax_restore
from repro.checkpoint import save as jax_save
from repro.rl.policy import init_policy as jax_init_policy
from repro.serve import ObsNorm as JaxObsNorm
from repro.serve import ServeEngine as JaxEngine
from repro.serve import save_for_serving as jax_save_for_serving
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.rl.policy import init_policy, params_from_jax, params_to_numpy
from repro_torch.serve import ObsNorm, ServeEngine, save_for_serving

OBS_DIM, HIDDEN, ACT_DIM = 6, 16, 2
ATOL, RTOL = 1e-6, 1e-5


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_policy(jax.random.key(3), OBS_DIM, hidden=HIDDEN,
                           act_dim=ACT_DIM)


@pytest.fixture(scope="module")
def norm():
    return (np.linspace(-1, 1, OBS_DIM).astype(np.float32),
            np.full(OBS_DIM, 1.5, np.float32))


def _obs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, OBS_DIM)).astype(np.float32)


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("mode", ["mean", "sample"])
def test_jax_checkpoint_serves_in_the_port(jax_params, norm, tmp_path, mode):
    jax_save_for_serving(str(tmp_path), 4, jax_params, norm=JaxObsNorm(*norm))
    port = ServeEngine.from_checkpoint(str(tmp_path), buckets=(8,), mode=mode,
                                       seed=2, device="cpu")
    ref = JaxEngine.from_checkpoint(str(tmp_path), buckets=(8,), mode=mode,
                                    seed=2, backend="jnp")
    np.testing.assert_array_equal(port.norm.mean, norm[0])
    np.testing.assert_array_equal(port.norm.std, norm[1])
    for seed in (5, 6):
        obs = _obs(7, seed)
        np.testing.assert_allclose(port.decide(obs), ref.decide(obs),
                                   atol=ATOL, rtol=RTOL)


def test_port_checkpoint_serves_in_jax(norm, tmp_path):
    params = init_policy(OBS_DIM, HIDDEN, ACT_DIM,
                         generator=torch.Generator().manual_seed(1),
                         device="cpu")
    save_for_serving(str(tmp_path), 9, params, norm=ObsNorm(*norm),
                     metadata={"note": "port"})
    ref = JaxEngine.from_checkpoint(str(tmp_path), buckets=(8,),
                                    backend="jnp")
    port = ServeEngine(params, norm=ObsNorm(*norm), buckets=(8,), device="cpu")
    obs = _obs(8, 7)
    np.testing.assert_allclose(port.decide(obs), ref.decide(obs), atol=ATOL,
                               rtol=RTOL)
    tree, meta = jax_restore(str(tmp_path))
    assert meta == {"note": "port", "kind": "serve", "step": 9}
    want = params_to_numpy(params)
    for head in ("pi", "vf"):
        for k, v in want[head].items():
            np.testing.assert_array_equal(tree["params"][head][k], v)


def test_serving_checkpoints_have_identical_files(jax_params, norm, tmp_path):
    jax_save_for_serving(str(tmp_path / "jax"), 1, jax_params,
                         norm=JaxObsNorm(*norm))
    port_params = params_from_jax(jax.tree.map(np.asarray, jax_params),
                                  device="cpu")
    save_for_serving(str(tmp_path / "port"), 1, port_params, norm=ObsNorm(*norm))
    a = _npz(tmp_path / "jax" / "step_0000000001.npz")
    b = _npz(tmp_path / "port" / "step_0000000001.npz")
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


def _mixed_tree():
    rng = np.random.default_rng(0)
    return {
        "a/b": rng.standard_normal(3).astype(np.float32),
        "50%": {"%2F": np.arange(4, dtype=np.int32), "x": np.float32(2.5)},
        "d:tag": [np.ones((2, 2), np.float64), (np.int64(7), np.zeros(0))],
        "plain": np.asarray(True),
    }


def test_flat_keys_and_arrays_identical_for_one_tree(tmp_path):
    tree = _mixed_tree()
    jax_save(str(tmp_path / "jax"), 3, tree)
    save(str(tmp_path / "port"), 3, tree)
    a = _npz(tmp_path / "jax" / "step_0000000003.npz")
    b = _npz(tmp_path / "port" / "step_0000000003.npz")
    assert sorted(a) == sorted(b)
    assert "/d:a%2Fb/a" in b and "/d:50%25/d:%252F/a" in b
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port",
                                       "port_to_port"])
def test_escaped_keys_round_trip(tmp_path, direction):
    tree = _mixed_tree()
    writer = jax_save if direction == "jax_to_port" else save
    reader = jax_restore if direction == "port_to_jax" else restore
    writer(str(tmp_path), 0, tree)
    back, meta = reader(str(tmp_path))
    assert meta == {"step": 0}
    assert sorted(back) == sorted(tree)
    np.testing.assert_array_equal(back["a/b"], tree["a/b"])
    np.testing.assert_array_equal(back["50%"]["%2F"], tree["50%"]["%2F"])
    assert isinstance(back["d:tag"], list) and isinstance(back["d:tag"][1], tuple)
    np.testing.assert_array_equal(back["d:tag"][0], tree["d:tag"][0])
    assert int(back["d:tag"][1][0]) == 7 and back["d:tag"][1][1].shape == (0,)


@pytest.mark.parametrize("key", [3, None, ("t",), ""])
def test_rejects_non_str_and_empty_keys(tmp_path, key):
    with pytest.raises((TypeError, ValueError)):
        save(str(tmp_path), 0, {key: np.zeros(2)})


def test_tensor_leaves_are_saved_as_numpy(tmp_path):
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3).requires_grad_()
    save(str(tmp_path), 2, {"w": t, "xs": [torch.ones(2, dtype=torch.int64)]})
    back, _ = jax_restore(str(tmp_path))
    np.testing.assert_array_equal(back["w"], t.detach().numpy())
    assert back["xs"][0].dtype == np.int64


def test_latest_step_and_missing_checkpoint(tmp_path):
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path))
    for step in (3, 12, 7):
        save(str(tmp_path), step, {"s": np.asarray(step)})
    assert latest_step(str(tmp_path)) == 12
    assert int(restore(str(tmp_path))[0]["s"]) == 12
    assert int(restore(str(tmp_path), 7)[0]["s"]) == 7


def test_from_checkpoint_accepts_a_bare_policy_tree(jax_params, tmp_path):
    jax_save(str(tmp_path), 0, jax_params)
    eng = ServeEngine.from_checkpoint(str(tmp_path), buckets=(8,),
                                      device="cpu")
    assert (eng.obs_dim, eng.act_dim) == (OBS_DIM, ACT_DIM)
    np.testing.assert_array_equal(eng.norm.mean, np.zeros(OBS_DIM, np.float32))
    save(str(tmp_path / "bad"), 0, {"other": np.zeros(2)})
    with pytest.raises(ValueError, match="neither"):
        ServeEngine.from_checkpoint(str(tmp_path / "bad"), device="cpu")
