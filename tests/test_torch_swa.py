"""Port parity: the sliding-window attention function on the CPU.

The same numpy inputs go through the JAX package (the Pallas kernel
``swa_attention_pallas`` in interpret mode and its oracle
``swa_attention_ref``, both given K/V repeated to the query heads by the
JAX ``_repeat_kv``) and through the port's ``swa_attention_plain`` /
``dispatch.swa_attention``, which take K/V un-repeated. Tolerances:

* fp32: ``atol 2e-6``, the figure of the JAX package's own kernel test
  (``tests/test_kernels.py:51-80``); the sides differ only in summation
  order;
* bf16 against the Pallas kernel: both keep everything in fp32 and round
  the output once, so they may land one bf16 ulp apart (``rtol 2^-7``);
* bf16 against ``swa_attention_ref``: the oracle rounds the softmax
  weights to bf16 before ``p @ v``, the port (like the Pallas kernel) does
  not: ``atol 2e-2``, the JAX test's own bf16 figure;
* the backward (``swa_attention_bwd_plain``) and the forward's log-sum-exp
  against ``jax.vjp`` of the JAX model's ``flash_attention`` (its
  ``_flash_bwd``) and ``_flash_fwd``'s lse, on K/V repeated by
  ``_repeat_kv`` (the port's dk / dv are the sums over each KV group's
  query heads): fp32 ``atol 1e-5`` (summation order, gradients of size
  ~1); ``SwaAttention`` against finite differences in float64
  (``torch.autograd.gradcheck``).

Lengths that do not divide the Pallas block sizes are held against the
oracle only (the Pallas kernel refuses them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ref as ref
from repro.kernels.swa_attention import swa_attention_pallas
from repro.models.attention import _flash_fwd_impl, flash_attention
from repro.models.attention import _repeat_kv as jax_repeat_kv
from repro_torch.kernels import dispatch
from repro_torch.kernels import swa_attention as sw
from repro_torch.kernels import swa_attention_bwd as swb

ATOL = 2e-6
BF16_REL = 2.0 ** -7
BF16_REF_ATOL = 2e-2

# The largest |port - JAX| each comparison reached; ``python <this file>``
# runs the tests and prints them (PERF.md records them).
REACHED = {}


def _close(what, got, want, atol, rtol=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    REACHED[what] = max(REACHED.get(what, 0.0), float(np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _inputs(b, sq, sk, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    q = 0.5 * rng.standard_normal((b, sq, h, d), dtype=np.float32)
    k = 0.5 * rng.standard_normal((b, sk, kv, d), dtype=np.float32)
    v = 0.5 * rng.standard_normal((b, sk, kv, d), dtype=np.float32)
    return q, k, v


def _jax(q, k, v, h, dtype):
    """The JAX side's inputs: K/V repeated to ``h`` heads."""
    return (jnp.asarray(q, dtype), jax_repeat_kv(jnp.asarray(k, dtype), h),
            jax_repeat_kv(jnp.asarray(v, dtype), h))


def _torch(q, k, v, dtype):
    return tuple(torch.from_numpy(x).to(dtype) for x in (q, k, v))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


# (Sq = Sk, window, Pallas blocks) — tests/test_kernels.py:51-56 — then the
# same at head size 120 and with grouped queries (4 heads on 2 KV heads).
PALLAS_CASES = [
    # s, window, bq, bk, h, kv, d
    (32, None, 16, 16, 2, 2, 32),
    (64, 24, 16, 16, 2, 2, 32),
    (64, 8, 32, 16, 2, 2, 32),      # window smaller than a block
    (128, 48, 32, 32, 2, 2, 32),
    (64, 24, 16, 16, 2, 2, 120),
    (64, 8, 32, 16, 4, 2, 32),
    (64, None, 32, 32, 4, 1, 120),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,window,bq,bk,h,kv,d", PALLAS_CASES)
def test_plain_matches_pallas_kernel_and_oracle(s, window, bq, bk, h, kv, d,
                                                dtype):
    q, k, v = _inputs(2, s, s, h, kv, d, seed=s + (window or 0) + h + d)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jq, jk, jv = _jax(q, k, v, h, jdt)
    o_pallas = swa_attention_pallas(jq, jk, jv, window=window, block_q=bq,
                                    block_kv=bk, interpret=True)
    o_ref = ref.swa_attention_ref(jq, jk, jv, window=window)
    got = sw.swa_attention_plain(*_torch(q, k, v, tdt), window=window)
    assert got.dtype == tdt and got.shape == (2, s, h, d)
    if dtype == "float32":
        _close("fp32 vs pallas", got.numpy(), o_pallas, ATOL)
        _close("fp32 vs ref", got.numpy(), o_ref, ATOL)
    else:
        _close("bf16 vs pallas", _f32(got), _f32(o_pallas), 1e-6, BF16_REL)
        _close("bf16 vs ref", _f32(got), _f32(o_ref), BF16_REF_ATOL)


@pytest.mark.parametrize("window", [16, 17, 31, 33])
def test_block_skip_boundaries_match_the_pallas_kernel(window):
    """tests/test_kernels.py:69-77: every (window, block) alignment."""
    q, k, v = _inputs(1, 64, 64, 1, 1, 16, seed=window)
    jq, jk, jv = _jax(q, k, v, 1, jnp.float32)
    o_pallas = swa_attention_pallas(jq, jk, jv, window=window, block_q=16,
                                    block_kv=16, interpret=True)
    got = sw.swa_attention_plain(*_torch(q, k, v, torch.float32),
                                 window=window)
    _close("fp32 vs pallas", got.numpy(), o_pallas, ATOL)


# Lengths no block divides, Sq != Sk, no causal mask, W = 1: the oracle only.
RAGGED_CASES = [
    # sq, sk, window, causal, h, kv, d
    (7, 7, None, True, 4, 2, 32),
    (37, 37, 16, True, 4, 1, 120),
    (45, 45, 1, True, 2, 2, 16),
    (13, 29, 8, True, 2, 2, 32),
    (29, 13, None, True, 2, 1, 32),
    (20, 13, 8, True, 4, 2, 32),
    (33, 33, None, False, 2, 2, 32),
    (33, 50, 5, False, 4, 2, 128),
]


@pytest.mark.parametrize("sq,sk,window,causal,h,kv,d", RAGGED_CASES)
def test_ragged_lengths_match_the_oracle(sq, sk, window, causal, h, kv, d):
    q, k, v = _inputs(2, sq, sk, h, kv, d, seed=sq * sk + d)
    jq, jk, jv = _jax(q, k, v, h, jnp.float32)
    want = ref.swa_attention_ref(jq, jk, jv, window=window, causal=causal)
    args = _torch(q, k, v, torch.float32)
    got = sw.swa_attention_plain(*args, window=window, causal=causal)
    _close("fp32 vs ref (ragged)", got.numpy(), want, ATOL)
    # the dispatched function is the plain version on CPU tensors, bit for bit
    assert torch.equal(dispatch.swa_attention(*args, window=window,
                                              causal=causal), got)


def test_float64_inputs_compute_in_float64():
    q, k, v = _inputs(1, 20, 20, 2, 1, 8, seed=1)
    args = _torch(q, k, v, torch.float64)
    got = sw.swa_attention_plain(*args, window=6)
    assert got.dtype == torch.float64
    jq, jk, jv = _jax(q, k, v, 2, jnp.float32)
    _close("float64 vs ref", got.numpy(),
           ref.swa_attention_ref(jq, jk, jv, window=6), ATOL)


@pytest.mark.parametrize("bad,match", [
    (dict(q=(2, 8, 3, 16)), "not a multiple"),
    (dict(k=(2, 8, 2, 8)), "k must be"),
    (dict(v=(2, 9, 2, 16)), "v must match"),
    (dict(q=(2, 8, 16)), "q must be"),
    (dict(k=(2, 0, 2, 16), v=(2, 0, 2, 16)), "Sk >= 1"),
    (dict(window=0), "window must be"),
    (dict(window=2.5), "window must be"),
    (dict(causal=None), "causal must be"),
    (dict(q=(2, 12, 4, 16), window=4), "no key in their window"),
])
def test_shapes_the_function_refuses(bad, match):
    shapes = {"q": (2, 8, 4, 16), "k": (2, 8, 2, 16), "v": (2, 8, 2, 16)}
    shapes.update({n: bad[n] for n in ("q", "k", "v") if n in bad})
    q, k, v = (torch.zeros(shapes[n]) for n in ("q", "k", "v"))
    kw = {"window": bad.get("window"), "causal": bad.get("causal", True)}
    with pytest.raises(ValueError, match=match):
        dispatch.swa_attention(q, k, v, **kw)


def test_the_kernel_wrapper_refuses_cpu_tensors_and_the_dispatch_meta():
    q, k, v = torch.zeros(1, 4, 2, 120), torch.zeros(1, 4, 1, 120), \
        torch.zeros(1, 4, 1, 120)
    before = sw.launches
    with pytest.raises(ValueError, match="CUDA device"):
        sw.swa_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="unsupported device"):
        dispatch.swa_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert sw.launches == before


def _kernel_numerics(q, k, v, window, causal, split):
    """The bf16 kernel's arithmetic in plain torch: fp32 scores and softmax
    weights ``p`` (normalised by their fp32 sum), ``p @ v`` with bf16 ``v``
    and ``p`` as ``bf16(p) + bf16(p - bf16(p))`` (``split``) or as one
    ``bf16(p)``; the tensor cores' exact products and fp32 sums stand in
    float64 here. ``q``, ``k``, ``v`` hold bf16 values."""
    B, Sq, H, D = q.shape
    Sk, rep = k.shape[1], H // k.shape[2]
    kr, vr = (t.repeat_interleave(rep, dim=2).double() for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kr).float() * D ** -0.5
    qp, kp = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    s = torch.where(ok, s, torch.tensor(sw.NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.bfloat16()
    parts = [hi, (p - hi.float()).bfloat16()] if split else [hi]
    o = sum(torch.einsum("bhqk,bkhd->bqhd", x.double(), vr) for x in parts)
    return o / p.sum(-1).double().transpose(1, 2)[..., None]


@pytest.mark.parametrize("sq,sk,h,kv,window,causal", [
    (160, 160, 4, 1, None, True),
    (200, 200, 4, 2, 40, True),
    (130, 260, 2, 2, None, False),
])
def test_split_p_keeps_fp32_accuracy_and_one_bf16_p_does_not(sq, sk, h, kv,
                                                              window, causal):
    """Why the bf16 kernel splits p: with p_hi + p_lo against bf16 v, the
    attention matches the plain version in float64 within 1e-5 of its
    largest output (p to about 2^-17 relative); with one bf16 p it does not
    (p to 2^-9)."""
    q, k, v = (x.bfloat16() for x in _torch(*_inputs(2, sq, sk, h, kv, 120,
                                                     seed=sq + h),
                                            torch.float32))
    want = sw.swa_attention_plain(q.double(), k.double(), v.double(),
                                  window=window, causal=causal)
    scale = float(want.abs().max())
    err = {split: float((_kernel_numerics(q, k, v, window, causal, split)
                         - want).abs().max()) / scale
           for split in (True, False)}
    REACHED["split p vs float64 (relative)"] = max(
        REACHED.get("split p vs float64 (relative)", 0.0), err[True])
    REACHED["one bf16 p vs float64 (relative)"] = max(
        REACHED.get("one bf16 p vs float64 (relative)", 0.0), err[False])
    assert err[True] <= 1e-5
    assert err[False] > 1e-5


@pytest.mark.parametrize("b,sq,sk,h,kv,window,causal", [
    (2, 512, 512, 8, 2, 96, True),
    (1, 130, 77, 6, 3, None, True),
    (3, 7, 7, 2, 1, 5, False),
    (1, 255, 129, 4, 4, None, True),
    (3, 200, 200, 8, 2, 100, True),
])
def test_mean_error_rule_passes_the_split_and_fails_one_bf16_p(
        b, sq, sk, h, kv, window, causal):
    """The card's mean-error rule for the bf16 kernel (its mean |err|
    against float64 within 1.1x the plain version's, fp32 p and o rounded
    once to bf16) on the kernel's arithmetic: p_hi + p_lo keeps it, one
    bf16 p breaks it, at card-test shapes with W > 1."""
    q, k, v = (x.bfloat16() for x in _torch(*_inputs(b, sq, sk, h, kv, 120,
                                                     seed=sq * 7 + h),
                                            torch.float32))
    kw = dict(window=window, causal=causal)
    want = sw.swa_attention_plain(q.double(), k.double(), v.double(), **kw)
    mean = lambda x: float((x.bfloat16().double() - want).abs().mean())
    lim = 1.1 * mean(sw.swa_attention_plain(q, k, v, **kw))
    split = mean(_kernel_numerics(q, k, v, window, causal, True))
    one = mean(_kernel_numerics(q, k, v, window, causal, False))
    REACHED["split p mean err / limit"] = max(
        REACHED.get("split p mean err / limit", 0.0), split / lim)
    REACHED["one bf16 p mean err / limit (smallest)"] = min(
        REACHED.get("one bf16 p mean err / limit (smallest)", np.inf),
        one / lim)
    assert split <= lim < one


# (b, s, h, kv, d, window, chunk of the JAX scan): GQA with a window; an
# odd length that pads the last chunk, 3 query heads a KV head, no window;
# W = 1 at another odd length; lengths past two chunks with windows that
# divide neither the length nor the chunk.
BWD_CASES = [
    (2, 32, 4, 2, 32, 8, 8),
    (1, 37, 6, 2, 16, None, 8),
    (1, 29, 2, 2, 24, 1, 16),
    (2, 40, 4, 1, 24, 12, 16),
    (1, 50, 3, 3, 16, 7, 16),
]
BWD_ATOL = 1e-5


@pytest.mark.parametrize("b,s,h,kv,d,window,chunk", BWD_CASES)
def test_plain_backward_and_lse_match_jax_flash_vjp(b, s, h, kv, d, window,
                                                    chunk):
    q, k, v = _inputs(b, s, s, h, kv, d, seed=s * h + d)
    do = np.random.default_rng(s).standard_normal((b, s, h, d),
                                                  dtype=np.float32)
    jq, jk, jv = _jax(q, k, v, h, jnp.float32)
    _, jlse = _flash_fwd_impl(jq, jk, jv, True, window, chunk, 0)
    _, vjp = jax.vjp(lambda a, b_, c: flash_attention(a, b_, c, True, window,
                                                      chunk, 0), jq, jk, jv)
    gq, gk, gv = vjp(jnp.asarray(do))
    fold = lambda g: np.asarray(g).reshape(b, s, kv, h // kv, d).sum(3)
    tq, tk, tv = _torch(q, k, v, torch.float32)
    o, lse = sw.swa_attention_plain(tq, tk, tv, window=window, with_lse=True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    _close("lse vs _flash_fwd", lse.numpy(), jlse, BWD_ATOL)
    dq, dk, dv = swb.swa_attention_bwd_plain(tq, tk, tv, o, torch.from_numpy(do),
                                             lse, window=window)
    assert dk.shape == (b, s, kv, d) and dq.dtype == torch.float32
    _close("bwd dq vs _flash_bwd", dq.numpy(), gq, BWD_ATOL)
    _close("bwd dk vs _flash_bwd", dk.numpy(), fold(gk), BWD_ATOL)
    _close("bwd dv vs _flash_bwd", dv.numpy(), fold(gv), BWD_ATOL)
    # autograd through the dispatched function runs the same backward
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    got = torch.autograd.grad(dispatch.swa_attention(*leaves, window=window),
                              leaves, torch.from_numpy(do))
    assert all(torch.equal(x, y) for x, y in zip(got, (dq, dk, dv)))


def _bwd_kernel_numerics(q, k, v, o, do, lse, window, split):
    """The bf16 backward kernel's arithmetic in plain torch: fp32 scores
    ``s = q k^T`` and ``dp = do v^T`` (bf16 operands, exact products, fp32
    sums), ``p = exp(s D^-1/2 - lse)`` (0 where masked), ``delta`` the fp32
    row sums of ``do * o`` and ``ds = p (dp - delta) D^-1/2`` in fp32; then
    ``dv = p^T do``, ``dq = ds k`` and ``dk = ds^T q`` with ``p`` and ``ds``
    as ``bf16(x) + bf16(x - bf16(x))`` (``split``) or as one ``bf16(x)``,
    fp32 sums (float64 here, as the tensor cores' exact products and wide
    sums) and bf16 outputs. ``q``, ``k``, ``v``, ``o``, ``do`` hold bf16
    values; ``lse`` is fp32 ``(B, H, Sq)``; causal."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    kr, vr = (t.repeat_interleave(rep, dim=2).double() for t in (k, v))
    scale = D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kr).float()
    dp = torch.einsum("bqhd,bkhd->bhqk", do.double(), vr).float()
    ok = sw.swa_mask(Sq, Sk, window, True, q.device)
    p = torch.where(ok, torch.exp(s * scale - lse[..., None]),
                    torch.zeros(()))
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    ds = p * (dp - delta[..., None]) * scale

    def product(eq, x, y):
        hi = x.bfloat16()
        parts = [hi, (x - hi.float()).bfloat16()] if split else [hi]
        return sum(torch.einsum(eq, a.double(), y) for a in parts)

    fold = lambda g: g.reshape(B, Sk, KV, rep, D).sum(3)
    dq = product("bhqk,bkhd->bqhd", ds, kr)
    dk = fold(product("bhqk,bqhd->bkhd", ds, q.double()))
    dv = fold(product("bhqk,bqhd->bkhd", p, do.double()))
    return tuple(x.float().bfloat16() for x in (dq, dk, dv))


@pytest.mark.parametrize("s,window,h,kv,d", [
    (129, None, 4, 1, 120),
    (200, 100, 6, 2, 128),
    (255, 1, 3, 3, 120),
    (129, 100, 3, 1, 128),
    (255, None, 4, 4, 120),
    (200, 1, 8, 2, 120),
])
def test_bwd_error_rule_passes_the_split_and_fails_one_bf16_p_and_ds(
        s, window, h, kv, d):
    """The card's rule for the bf16 backward (each of dq, dk, dv against
    float64 within 2x the plain version's largest and 1.1x its mean error,
    + 1e-6 of the largest |gradient|) on the kernel's arithmetic: p and ds
    as bf16 hi + lo keep it; one bf16 rounding of each breaks the mean rule
    wherever W > 1 (with W = 1, p is exactly 1 and dq, dk are 0)."""
    gen = torch.Generator().manual_seed(s * h + d)
    rnd = lambda *sh: torch.randn(sh, generator=gen).bfloat16()
    q, k, v, do = rnd(1, s, h, d), rnd(1, s, kv, d), rnd(1, s, kv, d), \
        rnd(1, s, h, d)
    o, lse = sw.swa_attention_plain(q, k, v, window=window, with_lse=True)
    plain = swb.swa_attention_bwd_plain(q, k, v, o, do, lse, window=window)
    x64 = [t.double() for t in (q, k, v, do)]
    o64, lse64 = sw.swa_attention_plain(*x64[:3], window=window, with_lse=True)
    want = swb.swa_attention_bwd_plain(*x64[:3], o64, x64[3], lse64,
                                       window=window)
    G = max(float(w.abs().max()) for w in want)
    ratios = {}
    for split in (True, False):
        got = _bwd_kernel_numerics(q, k, v, o, do, lse, window, split)
        for name, x, p, w in zip(("dq", "dk", "dv"), got, plain, want):
            ex, ep = (x.double() - w).abs(), (p.double() - w).abs()
            ratios[split, name] = (
                (float(ex.max()) - 1e-6 * G) / max(float(ep.max()), 1e-30),
                (float(ex.mean()) - 1e-6 * G) / max(float(ep.mean()), 1e-30))
    for name in ("dq", "dk", "dv"):
        mx, mean = ratios[True, name]
        REACHED["bwd split max err / plain's"] = max(
            REACHED.get("bwd split max err / plain's", 0.0), mx)
        REACHED["bwd split mean err / plain's"] = max(
            REACHED.get("bwd split mean err / plain's", 0.0), mean)
        assert mx <= 2.0 and mean <= 1.1, (name, mx, mean)
    if window != 1:
        one = max(ratios[False, n][1] for n in ("dq", "dk", "dv"))
        REACHED["bwd one bf16 p, ds mean err / plain's (smallest)"] = min(
            REACHED.get("bwd one bf16 p, ds mean err / plain's (smallest)",
                        np.inf), one)
        assert one > 1.1


@pytest.mark.parametrize("b,s,h,kv,d,window,causal", [
    (2, 6, 4, 2, 3, 3, True),
    (1, 7, 2, 1, 5, None, True),
    (1, 6, 2, 2, 4, 4, False),
])
def test_swa_attention_function_passes_gradcheck(b, s, h, kv, d, window,
                                                 causal):
    gen = torch.Generator().manual_seed(s + h)
    args = [torch.randn(shape, generator=gen, dtype=torch.float64,
                        requires_grad=True)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]
    fn = lambda q, k, v: dispatch.SwaAttention.apply(q, k, v, window, causal)
    assert torch.autograd.gradcheck(fn, args)


def test_backward_wrappers_refuse_bad_residuals():
    q, k, v = torch.zeros(1, 4, 2, 120), torch.zeros(1, 4, 1, 120), \
        torch.zeros(1, 4, 1, 120)
    with pytest.raises(ValueError, match="lse must be"):
        swb.swa_attention_bwd_plain(q, k, v, q, q, torch.zeros(1, 4, 2))
    with pytest.raises(ValueError, match="o and do must be"):
        swb.swa_attention_bwd_plain(q, k, v, q[:, :2], q, torch.zeros(1, 2, 4))
    before = swb.launches
    with pytest.raises(ValueError, match="CUDA device"):
        swb.swa_attention_bwd_cuda(q, k, v, q, q, torch.zeros(1, 2, 4))
    assert swb.launches == before


if __name__ == "__main__":
    import sys

    rc = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    mod = next(m for m in list(sys.modules.values())
               if getattr(m, "__file__", None) == __file__
               and m.__name__ != "__main__")
    for what, err in sorted(mod.REACHED.items()):
        print(f"{what}: {err:.3g}")
    sys.exit(rc)
