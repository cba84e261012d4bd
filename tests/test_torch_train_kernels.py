"""Port parity: the gradients slice 16 adds, on the CPU, against the JAX
package.

* ``swa_attention_bwd_plain`` at D = 256 (gemma-7b, recurrentgemma-9b)
  against ``jax.vjp`` of the JAX model's ``flash_attention`` (K/V repeated
  by ``_repeat_kv``; the port's dk / dv are its sums over each KV group):
  fp32 ``atol 1e-5`` (summation order), bf16 within 2^-6 of each
  gradient's largest |value| (two bf16 ulps: the two sides round the
  products' inputs and outputs at other places);
* ``wkv6_bwd_plain`` against ``jax.grad`` of ``wkv_scan`` (through its
  ``lax.scan``), with a nonzero initial state and a nonzero gradient of the
  final state: within ``1e-5`` of each gradient's largest |value| (fp32,
  summation order); and against float64 autograd of ``wkv6_plain``
  (``1e-12``), which also holds ``dispatch.Wkv6`` to ``gradcheck``;
* ``rglru_scan``'s gradient (autograd through the port's log-depth scan)
  against ``jax.grad`` of JAX's: within ``1e-5`` of each gradient's
  largest |value|; the ``clip`` of ``1 - a^2`` takes JAX's gradient at its
  bounds (half, where ``torch.clamp`` passes all);
* the wrappers of the two backward kernels take D = 256 and the shapes of
  wkv6 and raise on CPU tensors before any launch; ``wkv6_bwd_cuda``'s
  scratch follows its 32-step chunks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.rglru as jr
from repro.models.attention import _repeat_kv as jax_repeat_kv
from repro.models.attention import flash_attention
from repro.models.rwkv6 import wkv_scan
from repro_torch.kernels import dispatch
from repro_torch.kernels import swa_attention as sw
from repro_torch.kernels import swa_attention_bwd as swb
from repro_torch.kernels import wkv6 as wk
from repro_torch.models import rglru as tr

LEAF_REL = 1e-5
BWD_ATOL = 1e-5
BF16_LEAF_REL = 2.0 ** -6


def _rng_arrays(seed, *shapes, scale=0.5):
    rng = np.random.default_rng(seed)
    return [scale * rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _leaf_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale


# --- swa_attention_bwd at D = 256 ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,window,chunk", [
    (1, 19, 4, 1, 5, 8),          # recurrentgemma's MQA, windowed
    (2, 13, 2, 2, None, 8),       # gemma's one KV head a query head
])
def test_d256_plain_backward_matches_jax_flash_vjp(b, s, h, kv, window, chunk,
                                                   dtype):
    q, k, v, do = _rng_arrays(s * h, (b, s, h, 256), (b, s, kv, 256),
                              (b, s, kv, 256), (b, s, h, 256))
    jdt = getattr(jnp, dtype)
    jq = jnp.asarray(q, jdt)
    jk, jv = (jax_repeat_kv(jnp.asarray(x, jdt), h) for x in (k, v))
    _, vjp = jax.vjp(lambda a, b_, c: flash_attention(a, b_, c, True, window,
                                                      chunk, 0), jq, jk, jv)
    gq, gk, gv = (np.asarray(jnp.asarray(g, jnp.float32))
                  for g in vjp(jnp.asarray(do, jdt)))
    fold = lambda g: g.reshape(b, s, kv, h // kv, 256).sum(3)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    o, lse = sw.swa_attention_plain(tq, tk, tv, window=window, with_lse=True)
    got = swb.swa_attention_bwd_plain(tq, tk, tv, o, tdo, lse, window=window)
    assert got[1].shape == (b, s, kv, 256) and got[0].dtype == tdt
    for x, want in zip(got, (gq, fold(gk), fold(gv))):
        if dtype == "float32":
            np.testing.assert_allclose(x.numpy(), want, atol=BWD_ATOL, rtol=0)
        else:
            _leaf_close(x.float().numpy(), want, BF16_LEAF_REL)
    # the differentiable function runs the same backward at D = 256
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    again = torch.autograd.grad(dispatch.swa_attention(*leaves, window=window),
                                leaves, tdo)
    assert all(torch.equal(x, y) for x, y in zip(again, got))


# --- wkv6_bwd ---------------------------------------------------------------------

def _wkv_inputs(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.standard_normal((b, t, h, d), dtype=np.float32)
                   for _ in range(4))
    w = np.exp(-np.exp(0.5 * rng.standard_normal((b, t, h, d)))).astype(
        np.float32)
    u = 0.5 * rng.standard_normal((h, d), dtype=np.float32)
    s0, dsT = (0.3 * rng.standard_normal((b, h, d, d), dtype=np.float32)
               for _ in range(2))
    return r, k, v, w, u, s0, dy, dsT


# the last four: the edges of the kernel's 32-step chunks (31, 32, 33) and
# a ragged last chunk of 3 steps (131), as the card tests take them
@pytest.mark.parametrize("b,t,h,d", [(2, 37, 2, 16), (1, 1, 3, 8),
                                     (1, 20, 1, 64), (1, 31, 1, 8),
                                     (2, 32, 1, 8), (1, 33, 2, 8),
                                     (1, 131, 1, 8)])
def test_wkv6_plain_backward_matches_jax_grad_of_wkv_scan(b, t, h, d):
    r, k, v, w, u, s0, dy, dsT = _wkv_inputs(b, t, h, d, seed=t * h + d)

    def loss(*args):
        y, sT = wkv_scan(*args)
        return jnp.sum(y * dy) + jnp.sum(sT * dsT)
    want = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(x) for x in (r, k, v, w, u, s0)))
    got = wk.wkv6_bwd_plain(*(torch.from_numpy(x)
                              for x in (r, k, v, w, u, s0, dy, dsT)))
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == torch.float32
        _leaf_close(x.numpy(), y, LEAF_REL)


@pytest.mark.parametrize("with_dsT", [True, False])
def test_wkv6_plain_backward_is_float64_autograd_of_the_loop(with_dsT):
    r, k, v, w, u, s0, dy, dsT = (torch.from_numpy(x).double() for x in
                                  _wkv_inputs(2, 23, 3, 8, seed=7))
    ins = [x.clone().requires_grad_() for x in (r, k, v, w, u, s0)]
    y, sT = wk.wkv6_plain(*ins)
    ((y * dy).sum() + ((sT * dsT).sum() if with_dsT else 0)).backward()
    got = wk.wkv6_bwd_plain(r, k, v, w, u, s0, dy, dsT if with_dsT else None)
    for x, leaf in zip(got, ins):
        np.testing.assert_allclose(x.numpy(), leaf.grad.numpy(), rtol=0,
                                   atol=1e-12)


def test_wkv6_function_passes_gradcheck_and_refuses_an_inplace_state():
    r, k, v, w, u, s0, _, _ = (torch.from_numpy(x).double() for x in
                               _wkv_inputs(1, 5, 2, 3, seed=3))
    args = [x.clone().requires_grad_() for x in (r, k, v, w, u, s0)]
    assert torch.autograd.gradcheck(dispatch.Wkv6.apply, args)
    with pytest.raises(ValueError, match="state_out must be None"):
        dispatch.wkv6(*args, state_out=s0.clone())
    # unrecorded (serving) calls still write the state in place
    out = s0.clone()
    y, s = dispatch.wkv6(r, k, v, w, u, s0, state_out=out)
    assert s is out and torch.equal(s, wk.wkv6_plain(r, k, v, w, u, s0)[1])


@pytest.mark.parametrize("t,n", [(1, 1), (31, 1), (32, 1), (33, 2),
                                 (131, 5), (1024, 32)])
def test_wkv6_bwd_scratch_is_sized_by_32_step_chunks(t, n):
    """``wkv6_bwd_cuda``'s scratch, without a launch: the states at the
    inner edges of ceil(T / 32) chunks (none for one chunk, where the bound
    pass is not launched) and du's part of every (b, chunk)."""
    assert wk.BWD_CHUNK == 32
    got = wk.bwd_scratch_shapes(2, t, 3)
    assert got == {"sck": (2, 3, n - 1, 64, 64), "gck": (2, 3, n - 1, 64, 64),
                   "du_part": (2, n, 3, 64)}


def test_backward_kernels_take_d256_and_raise_on_cpu_tensors():
    assert sw.HEAD_DIMS == (64, 120, 128, 256)
    before = (swb.launches, wk.bwd_launches)
    q = torch.zeros(1, 4, 2, 256)
    k = torch.zeros(1, 4, 1, 256)
    with pytest.raises(ValueError, match="CUDA device"):
        swb.swa_attention_bwd_cuda(q, k, k, q, q, torch.zeros(1, 2, 4))
    with pytest.raises(ValueError, match="head sizes"):
        swb.swa_attention_bwd_cuda(*(torch.zeros(1, 4, n, 32)
                                     for n in (2, 1, 1, 2, 2)),
                                   torch.zeros(1, 2, 4))
    x = torch.zeros(1, 3, 2, 64)
    s0 = torch.zeros(1, 2, 64, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        wk.wkv6_bwd_cuda(x, x, x, x, torch.zeros(2, 64), s0, x)
    with pytest.raises(ValueError, match="dy must match"):
        wk.wkv6_bwd_plain(x, x, x, x, torch.zeros(2, 64), s0, x[:, :2])
    assert (swb.launches, wk.bwd_launches) == before


# --- the RG-LRU scan's gradient ----------------------------------------------------

def test_clip_takes_jax_gradient_at_its_bounds():
    x = np.array([1e-12, 1.0, 0.5, 2.0, 0.0, 1e-13], np.float32)
    want = jax.grad(lambda a: jnp.sum(jnp.clip(a, 1e-12, 1.0)))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    tr._clip(t, 1e-12, 1.0).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    assert list(t.grad.numpy()[:2]) == [0.5, 0.5]


@pytest.mark.parametrize("kind", ["mixed", "edges"])
def test_rglru_scan_gradient_matches_jax(kind):
    rng = np.random.default_rng(11)
    b, s, w = 2, 23, 16
    a_log = -8.0 * np.log1p(np.exp(rng.standard_normal(w))) \
        * rng.random((b, s, w))
    if kind == "edges":
        # 1 - a^2 exactly 1 (a_log far below -8.3) and exactly 0 (a_log 0):
        # the clip's upper and lower bounds
        a_log[:, ::3, ::2] = -30.0
        a_log[:, 1::5, 1::4] = 0.0
    a_log = a_log.astype(np.float32)
    gate_in, g = (rng.standard_normal((b, s, w), dtype=np.float32)
                  for _ in range(2))
    h0, g_last = (rng.standard_normal((b, w), dtype=np.float32)
                  for _ in range(2))

    def loss(a, x, h):
        hs, last = jr.rglru_scan(a, x, h)
        return jnp.sum(hs * g) + jnp.sum(last * g_last)
    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (a_log, gate_in, h0)))
    leaves = [torch.from_numpy(x).requires_grad_()
              for x in (a_log, gate_in, h0)]
    hs, last = tr.rglru_scan(*leaves)
    ((hs * torch.from_numpy(g)).sum()
     + (last * torch.from_numpy(g_last)).sum()).backward()
    for leaf, y in zip(leaves, want):
        _leaf_close(leaf.grad.numpy(), y, LEAF_REL)
