"""Port parity: the Griffin recurrent block (``models/rglru.py``) on the CPU,
against the JAX package's ``repro.models.rglru``.

The same numpy inputs (fp32) go through both. Tolerances:

* ``_causal_conv1d``: ``atol 1e-6`` — the same taps added in the same
  order; XLA may fuse a product and a sum into one FMA where torch rounds
  twice;
* the scan itself (``_scan``) on the same ``(a, b)``: bitwise
  ``jax.lax.associative_scan`` — the port runs JAX's recursion, so every
  product and sum is taken in JAX's order;
* ``rglru_scan``: ``rtol 1e-5``, ``atol 1e-6``, plus where ``a`` is near 1
  the cancellation in ``sqrt(1 - exp(2 log a))``: XLA's and torch's fp32
  ``exp`` differ by an ulp, which that difference turns into a relative
  error of up to ``2^-23 / (1 - a^2)`` in each input term, summed along
  the sequence (:func:`_cancellation_atol`);
* ``apply_rglru_block``: ``atol 2e-6`` for outputs of size ~0.1 (three
  matrix products and the gates around the scan);
* prefill then decode against one pass over the whole sequence, in the
  port alone: ``atol 2e-6`` (the scan's order differs between the two, and
  the CPU's matrix products round a row differently by row count).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as C
import repro.models.rglru as jr
from repro.models.layers import split_leaves
from repro_torch import configs as TC
from repro_torch.models import rglru as tr

SCAN_RTOL, SCAN_ATOL = 1e-5, 1e-6
CONV_ATOL = 1e-6
BLOCK_ATOL = 2e-6
RG = "recurrentgemma-9b"

# The largest |port - JAX| each comparison reached; ``python <this file>``
# runs the tests and prints them (PERF.md records them).
REACHED = {}


def _close(what, got, want, atol, rtol=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    REACHED[what] = max(REACHED.get(what, 0.0), float(np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _rand(shape, seed, scale=0.5):
    return scale * np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)


def _cfgs(**kw):
    kw = dict(dict(d_model=64, lru_width=48, n_layers=3), **kw)
    return (dataclasses.replace(C.get_arch(RG).reduced(), **kw),
            dataclasses.replace(TC.get_arch(RG).reduced(), **kw))


@pytest.fixture(scope="module")
def block():
    cfg, tcfg = _cfgs()
    p, _ = split_leaves(jr.init_rglru_block(jax.random.key(2), cfg))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    return cfg, tcfg, p, tp


def test_block_leaves_and_shapes_are_jax_s(block):
    cfg, tcfg, p, _ = block
    want = {k: tuple(v.shape) for k, v in p.items()}
    assert {k: tuple(v.shape) for k, v in
            tr.init_rglru_block(None, tcfg).items()} == want
    gen = torch.Generator().manual_seed(0)
    drawn = tr.init_rglru_block(gen, tcfg)
    assert {k: tuple(v.shape) for k, v in drawn.items()} == want
    for name in ("conv_b", "ba", "bx"):
        assert not bool(drawn[name].any())
    st, tst = jr.init_rglru_state(cfg, 3), tr.init_rglru_state(tcfg, 3)
    for k in st:
        assert tuple(tst[k].shape) == st[k].shape and not bool(tst[k].any())
    assert tst["h"].dtype == torch.float32
    assert tr.init_rglru_state(tcfg, 2, torch.bfloat16)["conv"].dtype == \
        torch.bfloat16


@pytest.mark.parametrize("s", [1, 3, 9])
def test_causal_conv1d_with_a_carry_matches_jax(s):
    x, w = _rand((2, s, 48), seed=s), _rand((4, 48), seed=10 + s)
    b, carry = _rand((48,), seed=20 + s), _rand((2, 3, 48), seed=30 + s)
    out, st = jr._causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), jnp.asarray(carry))
    tout, tst = tr._causal_conv1d(*(torch.from_numpy(a)
                                    for a in (x, w, b, carry)))
    _close("causal conv1d", tout.numpy(), out, CONV_ATOL)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(st))


def _scan_inputs(b, s, w, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "near_zero":            # a_t ~ 1: long memory
        a_log = -(1.0 + rng.random((b, s, w))) * 1e-3
    elif kind == "very_negative":      # a_t ~ 0: the input passes through
        a_log = -20.0 - 30.0 * rng.random((b, s, w))
    else:                              # the block's own range, -8 softplus r
        a_log = -8.0 * np.log1p(np.exp(rng.standard_normal(w))) \
            * rng.random((b, s, w))
    gate_in = rng.standard_normal((b, s, w))
    h0 = rng.standard_normal((b, w))
    return (a_log.astype(np.float32), gate_in.astype(np.float32),
            h0.astype(np.float32))


def _cancellation_atol(a_log, gate_in):
    """SCAN_ATOL plus, per position, the sum along the sequence of each
    input term's bound ``2^-23 / (1 - a^2) |sqrt(1 - a^2) i x|`` (one ulp of
    ``exp`` through the cancellation; ``a <= 1`` carries it undamped)."""
    one_m = -np.expm1(2.0 * a_log.astype(np.float64))
    term = 2.0 ** -23 / one_m * np.sqrt(one_m) * np.abs(gate_in)
    return SCAN_ATOL + np.cumsum(term, axis=1)


@pytest.mark.parametrize("s", [1, 2, 7, 64, 65])
def test_scan_order_is_jax_associative_scan_bitwise(s):
    rng = np.random.default_rng(s)
    a = rng.random((2, s, 8)).astype(np.float32)
    b = rng.standard_normal((2, s, 8)).astype(np.float32)
    comb = lambda c1, c2: (c1[0] * c2[0], c2[0] * c1[1] + c2[1])
    ja, jb = jax.lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(b)),
                                      axis=1)
    ta, tb = tr._scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("kind", ["near_zero", "very_negative", "mixed"])
@pytest.mark.parametrize("s", [1, 7, 64])
def test_rglru_scan_matches_jax(s, kind):
    a_log, gate_in, h0 = _scan_inputs(2, s, 16, seed=s, kind=kind)
    h, last = jr.rglru_scan(jnp.asarray(a_log), jnp.asarray(gate_in),
                            jnp.asarray(h0))
    th, tlast = tr.rglru_scan(*(torch.from_numpy(a)
                                for a in (a_log, gate_in, h0)))
    assert th.shape == (2, s, 16) and th.dtype == torch.float32
    atol = _cancellation_atol(a_log, gate_in)
    REACHED[f"rglru scan ({kind}), err / tolerance"] = max(
        REACHED.get(f"rglru scan ({kind}), err / tolerance", 0.0),
        float((np.abs(th.numpy() - np.asarray(h))
               / (atol + SCAN_RTOL * np.abs(np.asarray(h)))).max()))
    np.testing.assert_array_less(np.abs(th.numpy() - np.asarray(h)),
                                 atol + SCAN_RTOL * np.abs(np.asarray(h)))
    np.testing.assert_array_less(np.abs(tlast.numpy() - np.asarray(last)),
                                 atol[:, -1] + SCAN_RTOL
                                 * np.abs(np.asarray(last)))


def test_rglru_scan_is_the_recurrence_in_float64():
    """The scan against the recurrence written out step by step in
    float64: the associative form computes the same function."""
    a_log, gate_in, h0 = _scan_inputs(3, 37, 8, seed=5, kind="mixed")
    th, _ = tr.rglru_scan(*(torch.from_numpy(a).double()
                            for a in (a_log, gate_in, h0)))
    a = np.exp(a_log.astype(np.float64))
    x = np.sqrt(np.clip(1 - a * a, 1e-12, 1)) * gate_in
    h, want = h0.astype(np.float64), []
    for t in range(37):
        h = a[:, t] * h + x[:, t]
        want.append(h)
    np.testing.assert_allclose(th.numpy(), np.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


def test_rglru_scan_takes_log_depth_not_a_loop_over_s():
    """The scan's torch calls grow with log2 S, not S: no host loop over
    the sequence (a 1 x 8192 prefill would otherwise launch ~10^6
    kernels)."""
    from torch.overrides import TorchFunctionMode

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    calls = {}
    for s in (64, 4096):
        a_log, gate_in, h0 = (torch.from_numpy(a) for a in _scan_inputs(
            1, s, 4, seed=1, kind="mixed"))
        Count.n = 0
        with Count():
            tr.rglru_scan(a_log, gate_in, h0)
        calls[s] = Count.n
    assert calls[4096] < 2.5 * calls[64] < 1000, calls


def test_apply_rglru_block_matches_jax(block):
    cfg, tcfg, p, tp = block
    x = _rand((2, 11, cfg.d_model), seed=3, scale=1.0)
    st = {"h": _rand((2, 48), seed=4), "conv": _rand((2, 3, 48), seed=5)}
    out, new = jr.apply_rglru_block(p, jnp.asarray(x), cfg,
                                    {k: jnp.asarray(v) for k, v in st.items()})
    tout, tnew = tr.apply_rglru_block(
        tp, torch.from_numpy(x), tcfg,
        {k: torch.from_numpy(v) for k, v in st.items()})
    _close("rglru block", tout.numpy(), out, BLOCK_ATOL)
    _close("rglru block state", tnew["h"].numpy(), new["h"], BLOCK_ATOL)
    _close("rglru block state", tnew["conv"].numpy(), new["conv"],
           BLOCK_ATOL)


def test_prefill_then_decode_equals_one_pass(block):
    """The block over 12 tokens from zeros, against 8 tokens and then 4
    one-token steps carrying ``h`` and the conv inputs (the JAX block's
    own decode form, checked against JAX at every step)."""
    cfg, tcfg, p, tp = block
    x = _rand((2, 12, cfg.d_model), seed=6, scale=1.0)
    zero = tr.init_rglru_state(tcfg, 2)
    full, fst = tr.apply_rglru_block(tp, torch.from_numpy(x), tcfg, zero)
    out, st = tr.apply_rglru_block(tp, torch.from_numpy(x[:, :8]), tcfg, zero)
    jout, jst = jr.apply_rglru_block(p, jnp.asarray(x[:, :8]), cfg,
                                     jr.init_rglru_state(cfg, 2))
    outs = [out]
    step = jax.jit(lambda x_t, s_: jr.apply_rglru_block(p, x_t, cfg, s_))
    for t in range(8, 12):
        out, st = tr.apply_rglru_block(tp, torch.from_numpy(x[:, t:t + 1]),
                                       tcfg, st)
        jout, jst = step(jnp.asarray(x[:, t:t + 1]), jst)
        _close("rglru block decode", out.numpy(), jout, BLOCK_ATOL)
        outs.append(out)
    _close("rglru prefill + decode vs one pass",
           torch.cat(outs, 1).numpy(), full.numpy(), BLOCK_ATOL)
    _close("rglru prefill + decode vs one pass", st["h"].numpy(),
           fst["h"].numpy(), BLOCK_ATOL)
    _close("rglru prefill + decode vs one pass", st["conv"].numpy(),
           fst["conv"].numpy(), BLOCK_ATOL)


if __name__ == "__main__":
    import sys

    rc = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    mod = next(m for m in list(sys.modules.values())
               if getattr(m, "__file__", None) == __file__
               and m.__name__ != "__main__")
    for what, err in sorted(mod.REACHED.items()):
        print(f"{what}: {err:.3g}")
    sys.exit(rc)
