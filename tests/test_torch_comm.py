"""Port parity: payload transforms, the top-k server reduction and the
compressed strategy seams, on the CPU against the JAX package.

Tolerances:

* ``topk_threshold``, ``quantize_int8`` / ``dequantize_int8``, ``encode``
  for every kind and ``payload_bytes``: identical (the same fp32 operations:
  a k-th largest value, a true division, round half to even, a clamp, a
  bf16 round trip);
* ``sent + residual == x`` exactly, in fp32, for every kind;
* ``topk_scatter``: the residual identical to JAX's ``jnp`` and
  ``interpret`` paths; the sum within ``m * 2^-24 * sum_i |sent[i, j]|``
  (+ one ulp of the output dtype) — ``segment_sum`` and torch's sum add in
  different orders;
* ``reduce_mean`` and the compressed ``flat_sync`` / consensus
  ``flat_local_step``: rtol 1e-6, atol 1e-7 (the same reductions in
  another order);
* a strategy with the identity transform is bitwise the strategy without
  one, step for step and over a whole ``run_fedrl``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.core import strategies as jstrat
from repro.core import topology as J
from repro.kernels import dispatch as jd
from repro.optim.flat import flat_momentum as jmom
from repro_torch import comm as tcomm
from repro_torch.core import strategies as tstrat
from repro_torch.core import topology as T
from repro_torch.kernels import dispatch as td
from repro_torch.optim import flat_momentum
from repro_torch.rl import FIGURE_EIGHT, FedRLConfig, run_fedrl

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _payload(m, n, seed, *, grid=None, zero_row=None):
    x = np.random.default_rng(seed).standard_normal((m, n)).astype(np.float32)
    if grid is not None:          # coarse values: many magnitude ties
        x = (np.round(x / grid) * grid).astype(np.float32)
    if zero_row is not None:
        x[zero_row] = 0.0
    return x


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


TRANSFORMS = {"identity": ("identity", {}), "topk": ("topk", dict(k=37)),
              "topk-noef": ("topk", dict(k=5, error_feedback=False)),
              "int8": ("qint8", {}), "bf16": ("qbf16", {})}


def _transform(name):
    fn, kw = TRANSFORMS[name]
    return getattr(jcomm, fn)(**kw), getattr(tcomm, fn)(**kw)


@pytest.mark.parametrize("name", list(TRANSFORMS))
@pytest.mark.parametrize("case", ["plain", "ties", "zero-row"])
def test_encode_and_payload_bytes_are_identical(name, case):
    jt, tt = _transform(name)
    assert (tt.kind, tt.k, tt.error_feedback, tt.enabled, tt.label) == \
        (jt.kind, jt.k, jt.error_feedback, jt.enabled, jt.label)
    for n in (0, 1, 37, 9347):
        assert tt.payload_bytes(n) == jt.payload_bytes(n)
    x = _payload(6, 97, 1, grid=0.25 if case == "ties" else None,
                 zero_row=2 if case == "zero-row" else None)
    js, jr = jt.encode(jnp.asarray(x))
    ts, tr = tt.encode(torch.tensor(x))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert torch.equal(ts + tr, torch.tensor(x))          # exact in fp32


@pytest.mark.parametrize("case", ["plain", "ties", "zero-row"])
def test_threshold_and_int8_are_exact(case):
    x = _payload(5, 64, 2, grid=0.5 if case == "ties" else None,
                 zero_row=0 if case == "zero-row" else None)
    for k in (1, 7, 64):
        np.testing.assert_array_equal(
            tcomm.topk_threshold(torch.tensor(x), k).numpy(),
            np.asarray(jcomm.topk_threshold(jnp.asarray(x), k)))
    jq, js = jcomm.quantize_int8(jnp.asarray(x))
    tq, ts = tcomm.quantize_int8(torch.tensor(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tcomm.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(jcomm.dequantize_int8(jq, js)))
    # half-way cases round to even on both sides
    h = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]], np.float32)
    np.testing.assert_array_equal(
        tcomm.quantize_int8(torch.tensor(h))[0].numpy(),
        np.asarray(jcomm.quantize_int8(jnp.asarray(h))[0]))


def test_the_same_errors():
    for fn in (lambda M: M.PayloadTransform("gzip"),
               lambda M: M.PayloadTransform("topk", k=0),
               lambda M: M.PayloadTransform("int8", k=3),
               lambda M: M.topk(3).payload_bytes(-1)):
        with pytest.raises(ValueError) as je:
            fn(jcomm)
        with pytest.raises(ValueError) as te:
            fn(tcomm)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="need 1 <= k <= 4"):
        tcomm.topk_threshold(torch.zeros(2, 4), 5)
    with pytest.raises(TypeError, match="PayloadTransform"):
        tstrat.make_strategy("sync", m=3).with_comm("topk")


@pytest.mark.parametrize("backend", ["jnp", "interpret"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["plain", "ties", "zero-row"])
def test_topk_scatter_matches_jax(case, dtype, backend):
    jdt, tdt = DTYPES[dtype]
    x = _payload(16, 257, 3, grid=0.25 if case == "ties" else None,
                 zero_row=5 if case == "zero-row" else None)
    xj = jnp.asarray(x).astype(jdt)
    t = np.asarray(jcomm.topk_threshold(xj.astype(jnp.float32), 16))
    if case == "zero-row":
        assert t[5] == 0.0
    js, jr = jd.topk_scatter(xj, t, backend=backend, block_n=128)
    ts, tr = td.topk_scatter(torch.tensor(x).to(tdt), torch.tensor(t))
    assert ts.dtype == tr.dtype == tdt
    np.testing.assert_array_equal(_np(tr), _np(jr))
    x32 = _np(xj)
    sent = np.where(np.abs(x32) >= t[:, None], x32, 0.0)
    eps = float(jnp.finfo(jdt).eps)
    bound = 16 * 2.0 ** -24 * np.abs(sent).sum(0) + eps * np.abs(_np(js))
    assert np.all(np.abs(_np(ts) - _np(js)) <= bound)
    # sent + residual == x exactly
    sum_of_rows = torch.tensor(x).to(tdt).float() - tr.float()
    np.testing.assert_array_equal(sum_of_rows.numpy(), sent)


@pytest.mark.parametrize("name", ["topk", "int8", "bf16"])
def test_reduce_mean_matches_jax(name):
    jt, tt = _transform(name)
    x = _payload(7, 129, 4)
    jm, jr = jt.reduce_mean(jnp.asarray(x), backend="jnp")
    tm, tr = tt.reduce_mean(torch.tensor(x))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def _strategy_pairs(name, comm_name):
    jc, tc = _transform(comm_name)
    taus = np.array([4, 4, 3, 3, 2, 1, 1])
    if name == "consensus" or name == "consensus-sparse":
        jt, tt = J.random_regularish(7, 3, 4, 0), T.random_regularish(7, 3, 4, 0)
        kw = dict(tau=4, eps=0.9 / tt.max_degree, taus=taus, rounds=2,
                  sparse=name.endswith("sparse"))
        return (jstrat.make_strategy("consensus", topo=jt, comm=jc, **kw),
                tstrat.make_strategy("consensus", topo=tt, comm=tc, **kw))
    return (jstrat.make_strategy(name, tau=4, taus=taus, comm=jc),
            tstrat.make_strategy(name, tau=4, taus=taus, comm=tc))


@pytest.mark.parametrize("comm_name", ["topk", "int8", "bf16", "topk-noef"])
@pytest.mark.parametrize("name", ["periodic", "consensus", "consensus-sparse"])
def test_compressed_seams_match_jax(name, comm_name):
    js, ts = _strategy_pairs(name, comm_name)
    m, n = 7, 65
    p0 = _payload(m, n, 0)
    p0[:] = p0[0]                                  # replicas start equal
    jp, tp = jnp.asarray(p0), torch.tensor(p0)
    jcs, tcs = js.init_comm_state(jp), ts.init_comm_state(tp)
    assert set(tcs) == set(jcs)
    jo, to = jmom(0.9), flat_momentum(0.9)
    jos, tos = jo.init(jp), to.init(tp)
    for step in range(9):
        g = _payload(m, n, 20 + step)
        jp, jos, jcs = js.flat_local_step(jp, jnp.asarray(g), step % 4, 5e-3,
                                          jo, jos, jcs, backend="jnp")
        out, tos, tcs = ts.flat_local_step(tp, torch.tensor(g), step % 4, 5e-3,
                                           to, tos, tcs)
        assert out is tp
        if step % 4 == 3:
            jp, jcs = js.flat_sync(jp, jcs, backend="jnp")
            out, tcs = ts.flat_sync(tp, tcs)
            assert out is tp
            np.testing.assert_array_equal(ts.server_row(tp, tcs).numpy(),
                                          tp[0].numpy())
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-7, err_msg=f"step {step}")
        for k in jcs:
            np.testing.assert_allclose(tcs[k].numpy(), np.asarray(jcs[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert ts.comm_bytes_per_event(9347) == js.comm_bytes_per_event(9347)


def test_the_reference_is_a_copy_of_row_0():
    ts = tstrat.make_strategy("periodic", tau=2, m=3, comm=tcomm.topk(2))
    flat = torch.ones(3, 4)
    state = ts.init_comm_state(flat)
    flat.add_(1.0)                                 # the local steps write flat
    assert torch.equal(state["ref"], torch.ones(4))
    assert state["err_up"].dtype == torch.float32


@pytest.mark.parametrize("name", ["periodic", "decay", "consensus",
                                  "consensus-sparse"])
def test_identity_comm_is_bitwise_the_dense_strategy(name):
    topo = T.random_regularish(7, 3, 4, 0)
    kw = dict(tau=3, m=7)
    if name.startswith("consensus"):
        kw = dict(tau=3, topo=topo, eps=0.1, rounds=2,
                  sparse=name.endswith("sparse"))
        name = "consensus"
    plain = tstrat.make_strategy(name, **kw)
    ident = tstrat.make_strategy(name, comm=tcomm.identity(), **kw)
    assert ident.comm == tcomm.IDENTITY and ident.init_comm_state(
        torch.zeros(7, 3)) == {}
    runs = []
    for s in (plain, ident):
        cfg = FedRLConfig(env=FIGURE_EIGHT, strategy=s, eta=5e-3, n_epochs=1,
                          epoch_len=40, minibatch=10,
                          optimizer=flat_momentum(0.9))
        runs.append(run_fedrl(cfg, 0, device="cpu"))
    (pa, ma, la), (pb, mb, lb) = runs
    for k in ma:
        np.testing.assert_array_equal(ma[k], mb[k])
    for h in ("pi", "vf"):
        for k in pa[h]:
            assert torch.equal(pa[h][k], pb[h][k])
    assert la.table_row() == lb.table_row()
