"""Port parity: ``repro_torch.serve`` on the CPU against ``repro.serve``.

The port's engine (``device="cpu"``, the plain PyTorch path) and the JAX
engine (``backend="jnp"``) get the same weights (carried across with
``params_from_jax``), the same norm, the same seed and the same batches from
the same seeded client schedule; decisions agree to ``atol 1e-6, rtol 1e-5``
(fp32 on both sides, matmul summation order differs). Inside the port the
serving contracts of the JAX engine hold bitwise: padding is
decision-neutral and a seeded run replays exactly. The queue is a numpy
copy, so schedules and batch compositions are identical, not close.
"""
import jax
import numpy as np
import pytest
import torch

from repro.rl.policy import init_policy as jax_init_policy
from repro.serve import MicroBatchQueue as JaxQueue
from repro.serve import ObsNorm as JaxObsNorm
from repro.serve import ServeEngine as JaxEngine
from repro.serve import poisson_arrivals as jax_poisson_arrivals
from repro.serve import simulate_clients as jax_simulate_clients
from repro_torch.rl.policy import params_from_jax, policy_apply
from repro_torch.serve import (
    MicroBatchQueue,
    ObsNorm,
    ObsRequest,
    ServeEngine,
    poisson_arrivals,
    simulate_clients,
)

OBS_DIM, HIDDEN, ACT_DIM = 6, 16, 2
BUCKETS = (8, 64)
ATOL, RTOL = 1e-6, 1e-5


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jax_init_policy(
        jax.random.key(0), OBS_DIM, hidden=HIDDEN, act_dim=ACT_DIM))


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax_params, device="cpu")


@pytest.fixture(scope="module")
def norm():
    return ObsNorm(np.linspace(-1, 1, OBS_DIM).astype(np.float32),
                   np.full(OBS_DIM, 1.5, np.float32))


def _obs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, OBS_DIM)).astype(np.float32)


def _batches(seed=13, max_batch=BUCKETS[-1]):
    q = MicroBatchQueue(max_batch=max_batch, obs_dim=OBS_DIM)
    q.push_all(simulate_clients(40, 4.0, 1.0, obs_dim=OBS_DIM, seed=seed))
    out = []
    while (nxt := q.next_batch()) is not None:
        out.append(nxt[0])
    return out


# --- against the JAX engine ------------------------------------------------------

@pytest.mark.parametrize("mode", ["mean", "sample"])
def test_engine_matches_jax_engine_on_one_schedule(jax_params, params, norm,
                                                   mode):
    jeng = JaxEngine(jax_params, norm=JaxObsNorm(norm.mean, norm.std),
                     buckets=BUCKETS, mode=mode, backend="jnp", seed=5)
    teng = ServeEngine(params, norm=norm, buckets=BUCKETS, mode=mode, seed=5,
                       device="cpu")
    batches = _batches()
    assert len(batches) > 2 and {b.shape[0] for b in batches} != {64}
    for obs in batches:
        np.testing.assert_allclose(teng.decide(obs), jeng.decide(obs),
                                   atol=ATOL, rtol=RTOL)
    assert teng.bucket_calls == jeng.bucket_calls
    assert (teng.n_decisions, teng.n_padded) == (jeng.n_decisions,
                                                 jeng.n_padded)


def test_obsnorm_matches_jax():
    o = np.random.default_rng(1).standard_normal((5, 7, OBS_DIM)) * 3 + 1
    a, b = ObsNorm.from_obs(o), JaxObsNorm.from_obs(o)
    np.testing.assert_array_equal(a.mean, b.mean)
    np.testing.assert_array_equal(a.std, b.std)
    c = ObsNorm.from_obs(torch.tensor(o))
    np.testing.assert_array_equal(c.mean, a.mean)
    with pytest.raises(ValueError):
        ObsNorm(np.zeros(3), np.zeros(3))
    with pytest.raises(ValueError):
        ObsNorm(np.zeros(3), np.ones(4))


# --- the engine's own contracts ---------------------------------------------------

def test_engine_decide_matches_policy_apply(params, norm):
    eng = ServeEngine(params, norm=norm, buckets=(8, 32), device="cpu")
    obs = _obs(5, seed=6)
    x = (torch.tensor(obs) - torch.tensor(norm.mean)) / torch.tensor(norm.std)
    mean, _ = policy_apply(params, x)
    np.testing.assert_allclose(eng.decide(obs), mean.detach().numpy(),
                               atol=ATOL, rtol=RTOL)


def test_bucket_padding_never_changes_a_decision(params, norm):
    """Same bucket, different padding: bitwise."""
    eng = ServeEngine(params, norm=norm, buckets=(8,), device="cpu")
    obs5 = _obs(5, seed=7)
    alone = eng.decide(obs5)                                        # 5 -> 8
    together = eng.decide(np.concatenate([obs5, _obs(3, seed=8)]))  # full
    np.testing.assert_array_equal(alone, together[:5])
    eng2 = ServeEngine(params, norm=norm, buckets=(8, 64), device="cpu")
    np.testing.assert_array_equal(eng2.decide(obs5), eng2.decide(obs5))


def test_one_build_and_no_build_on_the_hot_path(params, norm):
    eng = ServeEngine(params, norm=norm, buckets=(8, 32, 128), device="cpu")
    assert eng.n_builds == 1
    bufs = {b: eng._bufs[b].dev_noise.data_ptr() for b in eng.buckets}
    for n in (1, 8, 9, 32, 33, 128, 1, 9, 33):
        eng.decide(_obs(n, seed=n))
    assert eng.n_builds == 1
    assert {b: eng._bufs[b].dev_noise.data_ptr() for b in eng.buckets} == bufs
    assert eng.bucket_calls == {8: 3, 32: 3, 128: 3}
    assert eng.n_decisions == 1 + 8 + 9 + 32 + 33 + 128 + 1 + 9 + 33


def test_engine_rejects_oversized_batch_and_bad_obs(params):
    eng = ServeEngine(params, buckets=(8,), device="cpu")
    with pytest.raises(ValueError, match="largest bucket"):
        eng.decide(_obs(9))
    with pytest.raises(ValueError, match="obs must be"):
        eng.decide(np.zeros((4, OBS_DIM + 2), np.float32))


@pytest.mark.parametrize("bad", ["mode", "no_pi", "buckets", "norm"])
def test_engine_rejects_bad_construction(params, bad):
    kw = {"device": "cpu"}
    p = params
    if bad == "mode":
        kw["mode"] = "argmax"
    elif bad == "no_pi":
        p = {"vf": {}}
    elif bad == "buckets":
        kw["buckets"] = (0, 8)
    else:
        kw["norm"] = ObsNorm.identity(OBS_DIM + 1)
    with pytest.raises(ValueError):
        ServeEngine(p, **kw)


def test_engine_asks_for_the_card_by_default(params):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(params, device="cuda")


def test_engine_sample_mode_is_seed_deterministic(params, norm):
    obs = _obs(12, seed=9)
    run = lambda seed: ServeEngine(params, norm=norm, buckets=(16,),
                                   mode="sample", seed=seed,
                                   device="cpu").decide(obs)
    np.testing.assert_array_equal(run(3), run(3))
    assert not np.array_equal(run(3), run(4))


def test_engine_load_params_hot_swaps_in_place(jax_params, params, norm):
    eng = ServeEngine(params, norm=norm, buckets=(8,), device="cpu")
    obs = _obs(4, seed=10)
    before = eng.decide(obs)
    w1 = eng._pi["w1"]
    new = jax.tree.map(np.asarray, jax_init_policy(
        jax.random.key(1), OBS_DIM, hidden=HIDDEN, act_dim=ACT_DIM))
    eng.load_params(new)
    after = eng.decide(obs)
    assert eng.n_builds == 1 and eng._pi["w1"] is w1     # same buffers
    assert not np.array_equal(before, after)
    fresh = ServeEngine(params_from_jax(new, device="cpu"), norm=norm,
                        buckets=(8,), device="cpu")
    np.testing.assert_array_equal(after, fresh.decide(obs))
    # the caller's tensors are not written through
    np.testing.assert_array_equal(params["pi"]["w1"].detach().numpy(),
                                  jax_params["pi"]["w1"])
    bad = {"pi": {k: v for k, v in new["pi"].items() if k != "w2"}}
    with pytest.raises(ValueError, match="structure"):
        eng.load_params(bad)
    wrong = {"pi": {**new["pi"], "w2": np.zeros((3, 3), np.float32)}}
    with pytest.raises(ValueError, match="structure"):
        eng.load_params(wrong)


# --- queue: the numpy copy of repro.serve.queue --------------------------------------

def test_queue_coalesces_fifo_up_to_max_batch():
    q = MicroBatchQueue(max_batch=4, obs_dim=OBS_DIM)
    for i in range(6):
        q.push(ObsRequest(client_id=i, t_arrival=float(i),
                          obs=np.full(OBS_DIM, i, np.float32)))
    obs, reqs = q.next_batch()
    assert obs.shape == (4, OBS_DIM)
    assert [r.client_id for r in reqs] == [0, 1, 2, 3]
    obs, reqs = q.next_batch()
    assert [r.client_id for r in reqs] == [4, 5]
    assert q.next_batch() is None and len(q) == 0


@pytest.mark.parametrize("seed", [0, 11])
def test_schedule_and_batches_identical_to_jax(seed):
    mine = simulate_clients(20, 3.0, 2.0, obs_dim=OBS_DIM, seed=seed)
    theirs = jax_simulate_clients(20, 3.0, 2.0, obs_dim=OBS_DIM, seed=seed)
    assert len(mine) == len(theirs) > 10
    for a, b in zip(mine, theirs):
        assert (a.client_id, a.t_arrival) == (b.client_id, b.t_arrival)
        np.testing.assert_array_equal(a.obs, b.obs)
    qa = MicroBatchQueue(max_batch=8, obs_dim=OBS_DIM)
    qb = JaxQueue(max_batch=8, obs_dim=OBS_DIM)
    qa.push_all(mine)
    qb.push_all(theirs)
    while (na := qa.next_batch()) is not None:
        nb = qb.next_batch()
        np.testing.assert_array_equal(na[0], nb[0])
        assert [(r.client_id, r.seq) for r in na[1]] == \
            [(r.client_id, r.seq) for r in nb[1]]
    assert qb.next_batch() is None


def test_poisson_arrivals_identical_to_jax():
    a = poisson_arrivals(5.0, 3.0, seed=2)
    np.testing.assert_array_equal(a, jax_poisson_arrivals(5.0, 3.0, seed=2))
    assert np.all(a >= 0.0) and np.all(a < 3.0) and np.all(np.diff(a) >= 0.0)
    with pytest.raises(ValueError):
        poisson_arrivals(0.0, 1.0)


def test_queue_rejects_bad_obs():
    q = MicroBatchQueue(max_batch=4, obs_dim=OBS_DIM)
    with pytest.raises(ValueError):
        q.push(ObsRequest(0, 0.0, np.zeros(OBS_DIM + 1, np.float32)))
    with pytest.raises(ValueError):
        MicroBatchQueue(max_batch=0, obs_dim=OBS_DIM)


# --- end to end: clients -> queue -> engine --------------------------------------

def test_serving_pipeline_end_to_end_deterministic(params, norm):
    def serve_run():
        eng = ServeEngine(params, norm=norm, buckets=(8, 32), mode="sample",
                          seed=5, device="cpu")
        q = MicroBatchQueue(max_batch=eng.max_batch(), obs_dim=OBS_DIM)
        q.push_all(simulate_clients(16, 2.0, 2.0, obs_dim=OBS_DIM, seed=13))
        out = {}
        while (nxt := q.next_batch()) is not None:
            obs, reqs = nxt
            for r, a in zip(reqs, eng.decide(obs)):
                out.setdefault(r.client_id, []).append(a)
        return out

    a, b = serve_run(), serve_run()
    assert a.keys() == b.keys() and len(a) > 0
    for cid in a:
        np.testing.assert_array_equal(np.stack(a[cid]), np.stack(b[cid]))
