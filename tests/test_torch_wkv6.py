"""Port parity: the WKV6 recurrence and the RWKV6 time-mix on the CPU.

The same numpy inputs go through the JAX package (the Pallas kernel
``repro.kernels.ops.wkv6`` in interpret mode, its oracle
``repro.kernels.ref.wkv6_ref``, and ``repro.models.rwkv6.time_mix``) and
through the port's ``wkv6_plain`` / ``dispatch.wkv6`` / ``time_mix`` on CPU
tensors. Both sides compute in fp32 and differ only in the summation order
of the per-step contraction over i (XLA's dot vs torch's einsum):
``atol = rtol = 1e-5`` for the recurrence, the figure the JAX package's own
kernel test uses (``tests/test_kernels.py:33-34``), and ``atol 1e-4`` for
the time-mix, the figure of ``tests/test_kernels.py:121-122``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as C
import repro.kernels.ops as ops
import repro.kernels.ref as ref
from repro.models import rwkv6 as jrw
from repro_torch import configs as TC
from repro_torch.kernels import dispatch
from repro_torch.kernels import wkv6 as wk
from repro_torch.models import rwkv6 as rw

ATOL = RTOL = 1e-5
TM_ATOL = 1e-4

# The largest |port - JAX| each comparison reached; ``python <this file>``
# runs the tests and prints them (PERF.md records them).
REACHED = {}


def _close(what, got, want, atol, rtol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    REACHED[what] = max(REACHED.get(what, 0.0),
                        float(np.abs(got.astype(np.float64) - want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _inputs(b, t, h, d, seed, state_scale=0.1):
    """r, k, v ~ 0.5 N(0, 1); w in (0.45, 0.95) as the JAX test draws it;
    u ~ 0.5 N(0, 1); a nonzero initial state."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.5 * rng.standard_normal(s)).astype(np.float32)
    r, k, v = f(b, t, h, d), f(b, t, h, d), f(b, t, h, d)
    w = (1.0 / (1.0 + np.exp(-f(b, t, h, d))) * 0.5 + 0.45).astype(np.float32)
    u = f(h, d)
    s0 = (state_scale * rng.standard_normal((b, h, d, d))).astype(np.float32)
    return r, k, v, w, u, s0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,t,h,d,chunk", [
    (1, 8, 1, 8, 4),
    (2, 32, 3, 16, 8),
    (2, 64, 2, 64, 16),
    (1, 24, 4, 32, 24),
    (3, 20, 2, 16, 8),
    (2, 1, 2, 64, 1),       # one decode step
    (4, 1, 3, 64, 256),     # one step, T below the chunk
    (1, 7, 2, 64, 7),       # odd T
    (1, 9, 1, 64, 9),       # one head, one step past 8
    (1, 33, 3, 64, 11),     # three heads, one step past 32
])
def test_wkv6_plain_matches_pallas_interpret_and_ref(b, t, h, d, chunk):
    arrs = _inputs(b, t, h, d, seed=b * 100 + t + h)
    y_p, s_p = ops.wkv6(*map(jnp.asarray, arrs), chunk=chunk, interpret=True)
    y_r, s_r = ref.wkv6_ref(*map(jnp.asarray, arrs))
    y, s = wk.wkv6_plain(*_t(*arrs))
    for want_y, want_s in ((y_p, s_p), (y_r, s_r)):
        _close("wkv6 y", y.numpy(), want_y, ATOL, RTOL)
        _close("wkv6 state", s.numpy(), want_s, ATOL, RTOL)


@pytest.mark.parametrize("in_place", [False, True])
def test_dispatch_wkv6_on_cpu_is_the_plain_loop(in_place):
    arrs = _inputs(2, 9, 2, 64, seed=3)
    r, k, v, w, u, s0 = _t(*arrs)
    y_want, s_want = wk.wkv6_plain(r, k, v, w, u, s0)
    state = s0.clone()
    out = state if in_place else torch.empty_like(state)
    y, s = dispatch.wkv6(r, k, v, w, u, state, state_out=out)
    assert s is out
    assert torch.equal(y, y_want) and torch.equal(s, s_want)
    if not in_place:
        assert torch.equal(state, s0)
    y2, s2 = dispatch.wkv6(r, k, v, w, u, s0)
    assert torch.equal(y2, y_want) and torch.equal(s2, s_want)


def test_wkv6_state_chaining():
    """Two halves with the state carried equal one run, on both sides."""
    r, k, v, w, u, _ = _inputs(1, 32, 2, 16, seed=7)
    s0 = np.zeros((1, 2, 16, 16), np.float32)
    y_full, s_full = wk.wkv6_plain(*_t(r, k, v, w, u, s0))
    h1 = [a[:, :16] for a in (r, k, v, w)]
    h2 = [a[:, 16:] for a in (r, k, v, w)]
    y1, s_mid = wk.wkv6_plain(*_t(*h1, u, s0))
    y2, s_end = wk.wkv6_plain(*_t(*h2, u), s_mid)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, atol=ATOL,
                               rtol=RTOL)
    torch.testing.assert_close(s_end, s_full, atol=ATOL, rtol=RTOL)
    jy1, jmid = ops.wkv6(*map(jnp.asarray, (*h1, u, s0)), chunk=8,
                         interpret=True)
    jy2, jend = ops.wkv6(*map(jnp.asarray, h2), jnp.asarray(u), jmid,
                         chunk=8, interpret=True)
    _close("wkv6 state", s_end.numpy(), jend, ATOL, RTOL)
    _close("wkv6 y", y2.numpy(), jy2, ATOL, RTOL)


def test_wkv6_plain_in_float64_is_the_fp32_loop_to_rounding():
    """The float64 evaluation the card checks use as the reference."""
    arrs = _inputs(2, 40, 2, 64, seed=11)
    y32, s32 = wk.wkv6_plain(*_t(*arrs))
    y64, s64 = wk.wkv6_plain(*[x.double() for x in _t(*arrs)])
    assert y64.dtype == torch.float64
    torch.testing.assert_close(y32.double(), y64, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(s32.double(), s64, atol=ATOL, rtol=RTOL)


def _tm_case(seed, b=2, s=16):
    cfg = C.get_arch("rwkv6-1.6b").reduced()
    tcfg = TC.get_arch("rwkv6-1.6b").reduced()
    p = jrw.init_time_mix(jax.random.key(seed), cfg)
    p = jax.tree.map(lambda l: np.array(l.value), p,
                     is_leaf=lambda x: hasattr(x, "axes"))
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((b, s, cfg.d_model))).astype(np.float32)
    h, hd = cfg.d_model // cfg.wkv_head_dim, cfg.wkv_head_dim
    shift = (0.5 * rng.standard_normal((b, cfg.d_model))).astype(np.float32)
    wkv = (0.1 * rng.standard_normal((b, h, hd, hd))).astype(np.float32)
    return cfg, tcfg, p, x, {"shift": shift, "wkv": wkv}


@pytest.mark.parametrize("jax_impl", ["scan", "pallas-interpret"])
@pytest.mark.parametrize("s", [16, 1])
def test_time_mix_matches_jax(jax_impl, s):
    """The port's time_mix (dispatch.wkv6 -> plain loop on the CPU) against
    JAX's, with JAX's default scan and with its Pallas kernel in interpret
    mode plugged in as ``wkv_impl``; nonzero carried state."""
    cfg, tcfg, p, x, st = _tm_case(seed=s, s=s)
    impl = None
    if jax_impl == "pallas-interpret":
        impl = lambda *a: ops.wkv6(*a, chunk=8, interpret=True)
    y_j, st_j = jrw.time_mix(p, jnp.asarray(x), cfg,
                             jax.tree.map(jnp.asarray, st), wkv_impl=impl)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    y, new = rw.time_mix(tp, torch.from_numpy(x), tcfg, tst)
    for k in st:                      # the state given is only read
        np.testing.assert_array_equal(tst[k].numpy(), st[k])
    _close("time_mix y", y.numpy(), y_j, TM_ATOL)
    _close("time_mix state", new["wkv"].numpy(), st_j["wkv"], TM_ATOL)
    np.testing.assert_array_equal(new["shift"].numpy(),
                                  np.asarray(st_j["shift"]))


def test_time_mix_takes_a_wkv_impl_like_jax():
    """``wkv_impl`` replaces the dispatched recurrence; the plain loop gives
    the dispatched result bit for bit on the CPU."""
    _, tcfg, p, x, st = _tm_case(seed=5)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    outs = []
    for impl in (None, wk.wkv6_plain):
        tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
        y, tst = rw.time_mix(tp, torch.from_numpy(x), tcfg, tst, wkv_impl=impl)
        outs.append((y, tst["wkv"]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_channel_mix_matches_jax():
    cfg = C.get_arch("rwkv6-1.6b").reduced()
    tcfg = TC.get_arch("rwkv6-1.6b").reduced()
    p = jrw.init_channel_mix(jax.random.key(2), cfg)
    p = jax.tree.map(lambda l: np.array(l.value), p,
                     is_leaf=lambda x: hasattr(x, "axes"))
    rng = np.random.default_rng(2)
    x = (0.5 * rng.standard_normal((2, 9, cfg.d_model))).astype(np.float32)
    shift = (0.5 * rng.standard_normal((2, cfg.d_model))).astype(np.float32)
    y_j, sh_j = jrw.channel_mix(p, jnp.asarray(x), cfg, jnp.asarray(shift))
    y, sh = rw.channel_mix({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), tcfg, torch.from_numpy(shift))
    _close("channel_mix y", y.numpy(), y_j, 1e-6, 1e-5)
    np.testing.assert_array_equal(sh.numpy(), np.asarray(sh_j))


def test_dispatch_wkv6_raises_on_mismatched_shapes():
    r, k, v, w, u, s0 = _t(*_inputs(2, 3, 2, 64, seed=0))
    with pytest.raises(ValueError, match="r must be"):
        dispatch.wkv6(r[0], k, v, w, u, s0)
    with pytest.raises(ValueError, match="k must match"):
        dispatch.wkv6(r, k[:, :2], v, w, u, s0)
    with pytest.raises(ValueError, match="u must be"):
        dispatch.wkv6(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="state must be"):
        dispatch.wkv6(r, k, v, w, u, s0[:1])


def test_wkv6_cuda_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only; nothing falls back."""
    r, k, v, w, u, s0 = _t(*_inputs(1, 2, 1, 64, seed=0))
    before = wk.launches
    with pytest.raises(ValueError, match="CUDA device"):
        wk.wkv6_cuda(r, k, v, w, u, s0)
    assert wk.launches == before


if __name__ == "__main__":
    import sys

    rc = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    mod = next(m for m in list(sys.modules.values())
               if getattr(m, "__file__", None) == __file__
               and m.__name__ != "__main__")
    for what, err in sorted(mod.REACHED.items()):
        print(f"{what}: {err:.3g}")
    sys.exit(rc)
