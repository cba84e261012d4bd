"""Port parity: the flat ``(m, n)`` primitives on the CPU against the JAX package.

The same numpy inputs go through ``repro.kernels.dispatch`` (``backend="jnp"``
and ``backend="interpret"``: the Pallas kernel bodies on the CPU) and through
the port's ``repro_torch.kernels.dispatch`` on CPU tensors, which runs the
plain PyTorch versions of the four kernels: ``decay_accum`` (also the SGD
step and ``scale_rows``), ``row_mean``, ``momentum_update`` and
``adam_update``. Every path computes in fp32 and casts to the buffer dtype.

Tolerances, elementwise, in ulp of the compared output's dtype at the
output's largest magnitude (atol = k * eps(dtype) * max|want|, rtol 0):

* against ``jnp``: k = 1. The two sides run the same fp32 operations in the
  same order; XLA may still contract one multiply-add or sum in another
  order (row_mean).
* against ``interpret``: k = 4. The Pallas bodies contract ``acc + d*g``
  into one FMA, compute ``1 - b1`` in fp32 from fp32 ``b1`` (3 ulp away from
  the jnp path's ``1 - 0.9`` rounded once) and take ``(1-b2)*wg*wg`` in
  another order.
"""
import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jd
from repro.rl.policy import init_policy as jax_init_policy
from repro_torch.kernels import dispatch as td

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
ULPS = {"jnp": 1, "interpret": 4}
SHAPES = [(1,), (97,), (3, 97), (3, 4097), (2, 1)]


def _arr(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.tensor(a).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype_name, ulps):
    got, want = _np(got), _np(want)
    eps = float(jnp.finfo(DTYPES[dtype_name][0]).eps)
    atol = ulps * eps * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _coefs(shape):
    """A scalar, and per-agent (m,) coefficients for (m, n) buffers."""
    out = [-0.37]
    if len(shape) == 2:
        out.append(np.linspace(-1.0, 1.0, shape[0]).astype(np.float32))
    return out


def _tc(d):
    return d if np.ndim(d) == 0 else torch.tensor(d)


@pytest.mark.parametrize("backend", ["jnp", "interpret"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_decay_accum_matches_jax(shape, dtype, backend):
    jdt, tdt = DTYPES[dtype]
    a, g = _arr(shape, 0), _arr(shape, 1)
    for d in _coefs(shape):
        want = jd.decay_accum(jnp.asarray(a, jdt), jnp.asarray(g, jdt), d,
                              backend=backend)
        out = _t(a, tdt)
        got = td.decay_accum(out, _t(g, tdt), _tc(d), out=out)
        assert got.dtype == tdt and got.data_ptr() == out.data_ptr()
        _close(got, want, dtype, ULPS[backend])


@pytest.mark.parametrize("backend", ["jnp", "interpret"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_scale_rows_matches_jax(dtype, backend):
    jdt, tdt = DTYPES[dtype]
    g = _arr((3, 97), 2)
    w = np.array([0.0, 0.5, 1.0], np.float32)
    want = jd.scale_rows(jnp.asarray(g, jdt), w, backend=backend)
    _close(td.scale_rows(_t(g, tdt), w), want, dtype, ULPS[backend])


@pytest.mark.parametrize("backend", ["jnp", "interpret"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(3, 97), (3, 4097), (7, 1), (1, 3)],
                         ids=str)
def test_row_mean_matches_jax(shape, dtype, backend):
    jdt, tdt = DTYPES[dtype]
    g = _arr(shape, 3)
    want = jd.row_mean(jnp.asarray(g, jdt), backend=backend)
    got = td.row_mean(_t(g, tdt))
    assert got.shape == (shape[1],) and got.dtype == tdt
    _close(got, want, dtype, ULPS[backend])


def _states(kind, shape):
    mu, nu = _arr(shape, 4, 0.1), np.abs(_arr(shape, 5, 0.1))
    if kind == "momentum":
        return {"mu": jnp.asarray(mu)}, {"mu": torch.tensor(mu)}
    return ({"mu": jnp.asarray(mu), "nu": jnp.asarray(nu),
             "t": jnp.asarray(2, jnp.int32)},
            {"mu": torch.tensor(mu), "nu": torch.tensor(nu), "t": 2})


OPTIONS = [("sgd", {}), ("momentum", {"nesterov": False}),
           ("momentum", {"nesterov": True, "beta": 0.8}),
           ("adam", {"weight_decay": 0.0}),
           ("adam", {"weight_decay": 0.01, "b1": 0.85, "eps": 1e-6})]


@pytest.mark.parametrize("backend", ["jnp", "interpret"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(97,), (3, 97), (3, 4097)], ids=str)
@pytest.mark.parametrize("kind,kw", OPTIONS,
                         ids=["sgd", "momentum", "nesterov", "adam", "adamw"])
def test_flat_opt_update_matches_jax(kind, kw, shape, dtype, backend):
    jdt, tdt = DTYPES[dtype]
    p, g = _arr(shape, 6), _arr(shape, 7)
    for w in _coefs(shape):
        js, ts = ({}, {}) if kind == "sgd" else _states(kind, shape)
        jp, jst = jd.flat_opt_update(jnp.asarray(p, jdt), jnp.asarray(g, jdt),
                                     w, js, kind=kind, lr=5e-3,
                                     backend=backend, **kw)
        pt = _t(p, tdt)
        tp, tst = td.flat_opt_update(pt, _t(g, tdt), _tc(w), ts, kind=kind,
                                     lr=5e-3, inplace=True, **kw)
        assert tp.data_ptr() == pt.data_ptr() and tp.dtype == tdt
        _close(tp, jp, dtype, ULPS[backend])
        for k in ("mu", "nu"):
            if k in ts:
                assert tst[k].data_ptr() == ts[k].data_ptr()
                _close(tst[k], jst[k], "float32", ULPS[backend])
        if kind == "adam":
            assert tst["t"] == int(jst["t"]) == 3


def test_functional_update_leaves_its_inputs():
    p, g = _t(_arr((3, 8), 0)), _t(_arr((3, 8), 1))
    mu = torch.zeros(3, 8)
    before = p.clone()
    new_p, new_s = td.flat_opt_update(p, g, 1.0, {"mu": mu}, kind="momentum",
                                      lr=0.1)
    assert torch.equal(p, before) and not torch.equal(new_p, before)
    assert torch.count_nonzero(mu) == 0 and torch.count_nonzero(new_s["mu"])


def _raises_both(match, jfn, tfn):
    with pytest.raises(ValueError, match=match):
        jfn()
    with pytest.raises(ValueError, match=match):
        tfn()


def test_same_validation_errors():
    a, b = np.zeros((3, 5), np.float32), np.zeros((3, 4), np.float32)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), _t(a), _t(b)
    _raises_both("matching", lambda: jd.decay_accum(ja, jb, 1.0),
                 lambda: td.decay_accum(ta, tb, 1.0))
    _raises_both("dtypes must match",
                 lambda: jd.decay_accum(ja, ja.astype(jnp.bfloat16), 1.0),
                 lambda: td.decay_accum(ta, ta.bfloat16(), 1.0))
    _raises_both("d must be scalar or",
                 lambda: jd.decay_accum(ja[0], ja[0], jnp.ones(3)),
                 lambda: td.decay_accum(ta[0], ta[0], torch.ones(3)))
    _raises_both("scale_rows: g must be", lambda: jd.scale_rows(ja[0], 1.0),
                 lambda: td.scale_rows(ta[0], 1.0))
    _raises_both("scale_rows: w must be",
                 lambda: jd.scale_rows(ja, jnp.ones(2)),
                 lambda: td.scale_rows(ta, torch.ones(2)))
    _raises_both("row_mean: g must be", lambda: jd.row_mean(ja[0]),
                 lambda: td.row_mean(ta[0]))
    _raises_both("unknown optimizer kind",
                 lambda: jd.flat_opt_update(ja, ja, 1.0, {}, kind="lamb",
                                            lr=0.1),
                 lambda: td.flat_opt_update(ta, ta, 1.0, {}, kind="lamb",
                                            lr=0.1))
    _raises_both("w must be scalar or",
                 lambda: jd.flat_opt_update(ja, ja, jnp.ones((3, 1)), {},
                                            kind="sgd", lr=0.1),
                 lambda: td.flat_opt_update(ta, ta, torch.ones(3, 1), {},
                                            kind="sgd", lr=0.1))
    _raises_both("state needs 'mu'",
                 lambda: jd.flat_opt_update(ja, ja, 1.0, {}, kind="momentum",
                                            lr=0.1),
                 lambda: td.flat_opt_update(ta, ta, 1.0, {}, kind="momentum",
                                            lr=0.1))
    _raises_both("fp32 accumulator",
                 lambda: jd.flat_opt_update(
                     ja, ja, 1.0, {"mu": ja.astype(jnp.bfloat16)},
                     kind="momentum", lr=0.1),
                 lambda: td.flat_opt_update(ta, ta, 1.0, {"mu": ta.bfloat16()},
                                            kind="momentum", lr=0.1))


def test_sweep_shapes_wait_for_their_slice():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(NotImplementedError, match="sweep"):
        td.row_mean(x)
    with pytest.raises(NotImplementedError, match="sweep"):
        td.decay_accum(x, x, 1.0)


def test_flat_rows_follow_ravel_pytree():
    """The port's flat row order is ravel_pytree's, so a JAX flat row and the
    port's flat row of the same policy are the same array, and unravel gives
    views of the carry."""
    tree = jax.tree.map(np.asarray, jax_init_policy(jax.random.key(0), 6))
    jrow = np.asarray(jax.flatten_util.ravel_pytree(tree)[0])
    assert jrow.shape == (9347,)
    stacked = {h: {k: torch.tensor(np.stack([v, 2 * v, 3 * v]))
                   for k, v in tree[h].items()} for h in tree}
    flat, spec = td.stacked_ravel_spec(stacked)
    assert flat.shape == (3, 9347) and flat.is_contiguous()
    np.testing.assert_array_equal(flat[0].numpy(), jrow)
    np.testing.assert_array_equal(flat[2].numpy(), 3 * jrow)
    assert [p for p in spec.paths] == [
        ("pi", k) for k in ("b1", "b2", "b3", "log_std", "w1", "w2", "w3")
    ] + [("vf", k) for k in ("b1", "b2", "b3", "w1", "w2", "w3")]
    views = spec.unravel(flat)
    assert views["pi"]["w2"].shape == (3, 64, 64)
    views["pi"]["w2"][1, 0, 0] = 123.0                     # a view, not a copy
    assert 123.0 in flat[1]
    one = spec.unravel_one(flat[0])
    np.testing.assert_array_equal(spec.ravel_one(one).numpy(), jrow)
    with pytest.raises(ValueError, match="leading agent axis"):
        td.stacked_ravel_spec({"a": torch.zeros(3, 2), "b": torch.zeros(2)})
    assert td.compute_view(flat, None) is flat
    assert td.compute_view(flat.bfloat16(), torch.bfloat16).dtype == torch.float32


def test_adam_bias_corrections_are_fp32():
    for t in (1, 2, 7, 150):
        want = (1.0 - jnp.float32(0.9) ** jnp.float32(t),
                1.0 - jnp.float32(0.95) ** jnp.float32(t))
        got = td.adam_bias_corrections(t, 0.9, 0.95)
        np.testing.assert_allclose(got, [float(w) for w in want], rtol=2e-7)
        assert all(float(np.float32(x)) == x for x in got)
