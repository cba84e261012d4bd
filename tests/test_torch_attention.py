"""Port parity: attention, the attention LMs and their serving entry points
on the CPU, against the JAX package.

The reduced ``h2o-danube-3-4b`` (2 ``local`` layers, d 128, 4 heads of 32,
window 16, vocab 512, fp32) and the reduced ``phi4-mini-3.8b`` (2 global
``attn`` layers, tied embeddings) are initialised by the JAX package and
carried into the port with ``params_from_jax`` (or restored from a
checkpoint the JAX package saved). The JAX side runs its default ``flash``
path unless a test names another. Tolerances:

* the cache (``build_cache``, ``write_cache``): bitwise, positions
  included — both sides only move values;
* one attention layer: ``atol 2e-6`` (fp32 summation order, the figure of
  the JAX kernel test);
* fp32 logits: ``atol 2e-4``, the figure of the JAX package's own
  prefill/decode consistency tests (``tests/test_decode_consistency.py``);
* bf16 (parameters and compute in bfloat16): logits within ``BF16_ATOL`` =
  8 x 2^-8. The port keeps the softmax weights in fp32 for ``p @ v`` (the
  TPU kernel's function), where the JAX ``flash`` form rounds them to bf16
  first (``models/attention.py:204-205``): each attention output moves by
  up to a bf16 ulp of its own, on top of the bf16 rounding of the chains
  around it that the two frameworks place differently;
* greedy tokens are compared exactly, with the weights scaled x4 so that
  the context decides them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as C
import repro.models.attention as ja
from repro.checkpoint import save as jax_save
from repro.launch.serve import make_prefill_step as jax_prefill_step
from repro.launch.serve import make_serve_step as jax_serve_step
from repro.launch.serving_loop import Request as JaxRequest
from repro.launch.serving_loop import ServingLoop as JaxServingLoop
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.layers import apply_mlp as jax_apply_mlp
from repro.models.layers import apply_rope as jax_apply_rope
from repro.models.layers import init_mlp as jax_init_mlp
from repro.models.layers import split_leaves
from repro_torch import configs as TC
from repro_torch import models as TM
from repro_torch.checkpoint import restore
from repro_torch.kernels import swa_attention as sw
from repro_torch.launch import (
    Request,
    ServingLoop,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl

ATOL = 2e-4
LAYER_ATOL = 2e-6
BF16_ATOL = 8 * 2.0 ** -8
DANUBE, PHI4 = "h2o-danube-3-4b", "phi4-mini-3.8b"

# The largest |port - JAX| each comparison reached; ``python <this file>``
# runs the tests and prints them (PERF.md records them).
REACHED = {}


def _close(what, got, want, atol, rtol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    REACHED[what] = max(REACHED.get(what, 0.0),
                        float(np.abs(got.astype(np.float64) - want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _np_tree(params):
    return jax.tree.map(np.array, params)


def _cfgs(arch, **kw):
    return (dataclasses.replace(C.get_arch(arch).reduced(), **kw),
            dataclasses.replace(TC.get_arch(arch).reduced(), **kw))


def _model(arch, scale=1.0, **kw):
    cfg, tcfg = _cfgs(arch, **kw)
    params = jax_init_params(cfg, jax.random.key(0))
    if scale != 1.0:
        params = jax.tree.map(lambda x: x * scale, params)
    return cfg, tcfg, params, TM.params_from_jax(tcfg, _np_tree(params),
                                                 device="cpu")


@pytest.fixture(scope="module")
def danube():
    return _model(DANUBE)


@pytest.fixture(scope="module")
def scaled():
    """Weights x4: greedy tokens then depend on the context."""
    return _model(DANUBE, scale=4.0)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.int64))


def _rand(shape, seed, scale=0.5):
    return scale * np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)


# --- configs and trees --------------------------------------------------------------

@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("arch", [DANUBE, PHI4])
def test_config_is_a_copy_of_the_jax_config(arch, reduce):
    cfg, tcfg = C.get_arch(arch), TC.get_arch(arch)
    if reduce:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert tcfg.n_params() == cfg.n_params()
    assert tcfg.is_subquadratic == cfg.is_subquadratic


@pytest.mark.parametrize("arch,n", [(DANUBE, 3_961_839_360),
                                    (PHI4, 3_836_021_760)])
def test_full_width_tree_matches_jax_shapes_and_counts(arch, n):
    cfg, tcfg = C.get_arch(arch), TC.get_arch(arch)
    jtree = jax.eval_shape(lambda: jax_init_params(cfg, jax.random.key(0)))
    want = TM.param_shapes(tcfg)
    assert len(want["blocks"]) == cfg.n_layers
    assert ("unembed" in want) == (not cfg.tie_embeddings)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jtree["cycles"][0])[0]:
        node = want["blocks"][3]
        for p in path:
            node = node[p.key]
        assert leaf.shape[0] == cfg.n_layers
        assert tuple(node.shape) == tuple(leaf.shape[1:]), path
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jtree))
    assert TM.count_params(want) == n_jax == n


def test_decode_state_layout():
    _, tcfg = _cfgs(DANUBE)
    st = TM.init_decode_state(tcfg, 3, max_seq=40, device="cpu")
    c = st["cache"]
    assert c["k"].shape == c["v"].shape == (2, 3, 16, 4, 32)
    assert c["pos"].shape == (2, 3, 16) and c["pos"].dtype == torch.int32
    assert bool((c["pos"] == -1).all()) and not bool(c["k"].any())
    assert TM.init_decode_state(tcfg, 1, max_seq=5,
                                device="cpu")["cache"]["k"].shape[2] == 5
    assert TM.init_decode_state(tcfg, 1, max_seq=5, mode="train",
                                device="cpu") == {}
    _, pcfg = _cfgs(PHI4)
    assert TM.init_decode_state(pcfg, 2, max_seq=40, dtype=torch.bfloat16,
                                device="cpu")["cache"]["k"].shape == \
        (2, 2, 40, 4, 32)
    with pytest.raises(ValueError, match="max_seq"):
        TM.init_decode_state(tcfg, 1, device="cpu")


# --- layers -----------------------------------------------------------------------

@pytest.mark.parametrize("hd", [32, 120, 128])
def test_rope_matches_jax(hd):
    x = _rand((2, 9, 3, hd), seed=hd)
    pos = np.arange(100, 109)[None].repeat(2, 0)
    want = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    _close("rope", got.numpy(), want, LAYER_ATOL)
    # the same formula; XLA's and torch's fp32 pow may differ by one ulp
    np.testing.assert_allclose(
        tl.rope_frequencies(hd, 1e4).numpy(),
        np.asarray(1.0 / (1e4 ** (jnp.arange(hd // 2, dtype=jnp.float32)
                                  / (hd // 2)))), rtol=2.0 ** -23, atol=0)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(act):
    p, _ = split_leaves(jax_init_mlp(jax.random.key(1), 64, 96, act))
    x = _rand((2, 5, 64), seed=2, scale=2.0)
    want = jax_apply_mlp(p, jnp.asarray(x), act)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    assert set(tp) == set(tl.init_mlp(None, 64, 96, act))
    _close("mlp", tl.apply_mlp(tp, torch.from_numpy(x), act).numpy(), want,
           LAYER_ATOL)


# --- the attention module ----------------------------------------------------------

def _attn_layer(gqa=False):
    kw = {"n_kv_heads": 2} if gqa else {}
    cfg, tcfg = _cfgs(DANUBE, **kw)
    p, _ = split_leaves(ja.init_attention(jax.random.key(3), cfg))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in ta.init_attention(None, tcfg).items()}
    return cfg, tcfg, p, tp


def test_repeat_kv_and_mask_bias_match_jax():
    k = _rand((2, 5, 3, 4), seed=12)
    np.testing.assert_array_equal(
        ta._repeat_kv(torch.from_numpy(k), 6).numpy(),
        np.asarray(ja._repeat_kv(jnp.asarray(k), 6)))
    qp = np.array([[3, 4, 5], [9, 10, 11]])
    kp = np.array([[0, 1, 2, 3, 4, 5], [-1, 7, 8, 9, 10, 11]])
    for causal, window in ((True, None), (True, 2), (False, 3)):
        np.testing.assert_array_equal(
            ta._mask_bias(torch.from_numpy(qp), torch.from_numpy(kp),
                          causal=causal, window=window).numpy(),
            np.asarray(ja._mask_bias(jnp.asarray(qp), jnp.asarray(kp),
                                     causal=causal, window=window)))


@pytest.mark.parametrize("s", [10, 40])               # below / above W = 16
def test_build_cache_is_bitwise_jax(s):
    k, v = _rand((2, s, 2, 8), seed=s), _rand((2, s, 2, 8), seed=s + 1)
    pos = np.broadcast_to(np.arange(s), (2, s))
    for w in (16, s, s + 3):
        want = ja.build_cache(jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos), w)
        got = ta.build_cache(torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(pos.copy()), w)
        out = ta.build_cache(torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(pos.copy()), w,
                             out={n: torch.full_like(t, 7)
                                  for n, t in got.items()})
        for name in ("k", "v", "pos"):
            np.testing.assert_array_equal(got[name].numpy(), want[name])
            assert torch.equal(out[name], got[name])
        assert got["pos"].dtype == torch.int32


@pytest.mark.parametrize("impl", ["scatter", "onehot"])
def test_write_cache_is_bitwise_jax(impl):
    k, v = _rand((3, 6, 2, 8), seed=4), _rand((3, 6, 2, 8), seed=5)
    pos0 = np.array([[0, 1, 2, 3, 4, 5], [6, 7, 8, 9, 10, 11],
                     [-1, -1, -1, -1, -1, -1]], np.int32)
    kn, vn = _rand((3, 2, 8), seed=6), _rand((3, 2, 8), seed=7)
    pos = np.array([6, 15, 0])
    want = ja.write_cache({"k": jnp.asarray(k), "v": jnp.asarray(v),
                           "pos": jnp.asarray(pos0)}, jnp.asarray(kn),
                          jnp.asarray(vn), jnp.asarray(pos, jnp.int32),
                          impl=impl)
    cache = {"k": torch.from_numpy(k), "v": torch.from_numpy(v),
             "pos": torch.from_numpy(pos0)}
    got = ta.write_cache(cache, torch.from_numpy(kn), torch.from_numpy(vn),
                         torch.from_numpy(pos), impl=impl)
    assert got is cache
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[name].numpy(), want[name])
    with pytest.raises(ValueError, match="cache_update"):
        ta.write_cache(cache, torch.from_numpy(kn), torch.from_numpy(vn),
                       torch.from_numpy(pos), impl="ring")


@pytest.mark.parametrize("gqa", [False, True])
@pytest.mark.parametrize("impl", ["flash", "chunked", "einsum"])
@pytest.mark.parametrize("s", [10, 40])
def test_attention_and_prefill_match_jax(s, impl, gqa):
    cfg, tcfg, p, tp = _attn_layer(gqa)
    x = _rand((2, s, cfg.d_model), seed=s, scale=1.0)
    pos = np.broadcast_to(np.arange(s), (2, s)).copy()
    want = ja.attention(p, jnp.asarray(x), cfg, kind="local",
                        positions=jnp.asarray(pos), impl=impl)
    got = ta.attention(tp, torch.from_numpy(x), tcfg, kind="local",
                       positions=torch.from_numpy(pos), impl=impl)
    _close("attention layer", got.numpy(), want, LAYER_ATOL)
    o, cache = ja.attention_prefill(p, jnp.asarray(x), cfg, kind="local",
                                    positions=jnp.asarray(pos), cache_len=s + 2,
                                    impl=impl)
    to, tcache = ta.attention_prefill(tp, torch.from_numpy(x), tcfg,
                                      kind="local",
                                      positions=torch.from_numpy(pos),
                                      cache_len=s + 2, impl=impl)
    _close("attention layer", to.numpy(), o, LAYER_ATOL)
    assert tcache["k"].shape[1] == min(16, s + 2)
    np.testing.assert_array_equal(tcache["pos"].numpy(), cache["pos"])
    _close("attention cache", tcache["k"].numpy(), cache["k"], LAYER_ATOL)
    _close("attention cache", tcache["v"].numpy(), cache["v"], LAYER_ATOL)


def test_unknown_attn_impl_raises():
    cfg, tcfg, p, tp = _attn_layer()
    x = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(ValueError, match="attn_impl"):
        ta.attention(tp, x, tcfg, kind="local",
                     positions=torch.arange(4)[None], impl="pallas")


@pytest.mark.parametrize("gqa", [False, True])
def test_attention_decode_beyond_the_window_matches_jax(gqa):
    """Prefill 30 tokens into a ring of W = 16, then 4 decode steps (the ring
    wraps), against the JAX decode path step by step."""
    cfg, tcfg, p, tp = _attn_layer(gqa)
    s = 30
    x = _rand((2, s + 4, cfg.d_model), seed=11, scale=1.0)
    pos = np.broadcast_to(np.arange(s), (2, s)).copy()
    _, cache = ja.attention_prefill(p, jnp.asarray(x[:, :s]), cfg,
                                    kind="local", positions=jnp.asarray(pos),
                                    cache_len=s + 4)
    _, tcache = ta.attention_prefill(tp, torch.from_numpy(x[:, :s]), tcfg,
                                     kind="local",
                                     positions=torch.from_numpy(pos),
                                     cache_len=s + 4)
    for i in range(4):
        pi = np.full((2,), s + i)
        o, cache = ja.attention_decode(p, jnp.asarray(x[:, s + i:s + i + 1]),
                                       cache, cfg, kind="local",
                                       pos=jnp.asarray(pi, jnp.int32))
        to, tc = ta.attention_decode(tp, torch.from_numpy(
            x[:, s + i:s + i + 1]), tcache, tcfg, kind="local",
            pos=torch.from_numpy(pi))
        assert tc is tcache
        _close("attention decode", to.numpy(), o, LAYER_ATOL)
        np.testing.assert_array_equal(tc["pos"].numpy(), cache["pos"])


# --- the model against JAX ---------------------------------------------------------

def _decode_beyond_window(cfg, tcfg, params, tp, extra):
    """JAX's test_ring_buffer_decode_beyond_window geometry: prefill
    S = 2W - 2 tokens (30 for global attention) into a cache of S + extra
    positions, then decode ``extra`` tokens; each step against the JAX
    decode step and the JAX forward over the whole sequence."""
    s = 2 * cfg.sliding_window - 2 if cfg.sliding_window else 30
    toks = _tokens(cfg, (2, s + extra), seed=3)
    full, _, _ = jax_forward(cfg, params, jnp.asarray(toks), mode="train")
    tfull, _, aux = TM.forward(tcfg, tp, _t(toks), mode="train")
    assert float(aux) == 0.0
    _close("fp32 logits", tfull.numpy(), full, ATOL)
    lg, st = jax_prefill(cfg, params, jnp.asarray(toks[:, :s]),
                         cache_len=s + extra)
    tlg, tst = TM.prefill(tcfg, tp, _t(toks[:, :s]), cache_len=s + extra)
    _close("fp32 logits", tlg.numpy(), lg, ATOL)
    for i in range(extra):
        tok = toks[:, s + i:s + i + 1]
        lg, st = jax_decode_step(cfg, params, jnp.asarray(tok), st,
                                 jnp.full((2,), s + i))
        k_buf = tst["cache"]["k"]
        tlg, tst = TM.decode_step(tcfg, tp, _t(tok), tst,
                                  torch.full((2,), s + i))
        assert tst["cache"]["k"] is k_buf                      # in place
        _close("fp32 logits", tlg.numpy(), lg, ATOL)
        _close("fp32 decode vs forward", tlg[:, 0].numpy(), full[:, s + i],
               3e-4)
    np.testing.assert_array_equal(
        tst["cache"]["pos"].numpy(), np.asarray(st["cycles"][0]["cache"]["pos"]))


def test_forward_prefill_decode_beyond_the_window_match_jax(danube):
    _decode_beyond_window(*danube, extra=4)


@pytest.mark.parametrize("kv", [4, 2])
def test_phi4_mini_reduced_matches_jax(kv):
    """Global attention (window None through the same kernel), tied
    embeddings, head size 128 at full width; here reduced, with and without
    grouped queries."""
    cfg, tcfg, params, tp = _model(PHI4, n_kv_heads=kv)
    assert "unembed" not in tp
    _decode_beyond_window(cfg, tcfg, params, tp, extra=3)


def test_jax_saved_checkpoint_restores_into_the_port(danube, tmp_path):
    cfg, tcfg, params, tp = danube
    jax_save(str(tmp_path), 5, params, {"arch": DANUBE})
    tree, meta = restore(str(tmp_path))
    assert meta["step"] == 5 and meta["arch"] == DANUBE
    tp2 = TM.params_from_jax(tcfg, tree, device="cpu")
    for a, b in zip(TM.transformer.tree_leaves(tp2),
                    TM.transformer.tree_leaves(tp)):
        assert torch.equal(a, b)
    toks = _tokens(cfg, (2, 21), seed=4)
    lg, _ = jax_prefill(cfg, params, jnp.asarray(toks))
    tlg, _ = TM.prefill(tcfg, tp2, _t(toks))
    _close("fp32 logits (checkpoint)", tlg.numpy(), lg, ATOL)


def test_params_from_jax_checks_the_tree(danube):
    _, tcfg, params, _ = danube
    tree = _np_tree(params)
    tree["cycles"][0]["attn"]["wk"] = tree["cycles"][0]["attn"]["wk"][..., :64]
    with pytest.raises(ValueError, match="wk has shape"):
        TM.params_from_jax(tcfg, tree, device="cpu")
    tree = _np_tree(params)
    del tree["cycles"][0]["mlp"]["w_up"]
    with pytest.raises(ValueError, match="mlp has keys"):
        TM.params_from_jax(tcfg, tree, device="cpu")


def test_bf16_reduced_run_matches_jax_to_bf16_rounding():
    cfg, tcfg, params, tp = _model(DANUBE, param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
    leaf = tp["blocks"][1]["attn"]["wq"]
    assert leaf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        leaf.float().numpy(),
        np.asarray(params["cycles"][0]["attn"]["wq"][1], np.float32))
    s = 24
    toks = _tokens(cfg, (2, s + 1), seed=6)
    lg, st = jax_prefill(cfg, params, jnp.asarray(toks[:, :s]))
    tlg, tst = TM.prefill(tcfg, tp, _t(toks[:, :s]))
    assert tst["cache"]["k"].dtype == torch.bfloat16
    _close("bf16 logits", tlg.numpy(), lg, BF16_ATOL)
    lg2, _ = jax_decode_step(cfg, params, jnp.asarray(toks[:, s:]), st,
                             jnp.full((2,), s))
    tlg2, _ = TM.decode_step(tcfg, tp, _t(toks[:, s:]), tst,
                             torch.full((2,), s))
    _close("bf16 logits", tlg2.numpy(), lg2, BF16_ATOL)


def test_the_model_runs_the_dispatched_attention(danube):
    """Every attention layer of a prefill goes through the dispatched
    function (here the plain version: CPU tensors); ``swa_impl`` replaces
    it, and the plain version given outright changes nothing."""
    cfg, tcfg, params, tp = danube
    calls = []

    def spy(q, k, v, *, window, causal):
        calls.append((tuple(q.shape), tuple(k.shape), window, causal))
        return sw.swa_attention_plain(q, k, v, window=window, causal=causal)

    toks = _t(_tokens(cfg, (2, 20), seed=7))
    a, _ = TM.prefill(tcfg, tp, toks)
    b, _ = TM.prefill(tcfg, tp, toks, swa_impl=spy)
    assert torch.equal(a, b)
    assert calls == [((2, 20, 4, 32), (2, 20, 4, 32), 16, True)] * 2


def test_prefill_and_serve_steps_match_jax(danube):
    cfg, tcfg, params, tp = danube
    s = 20                                      # longer than the window
    toks = _tokens(cfg, (3, s), seed=5)
    lg, st = jax_prefill_step(cfg)(params, {"tokens": jnp.asarray(toks)})
    tlg, tst = make_prefill_step(tcfg)(tp, {"tokens": _t(toks)})
    assert tlg.shape == (3, 1, TM.padded_vocab(tcfg))
    assert tst["cache"]["k"].shape[2] == 16
    _close("fp32 serve steps", tlg.numpy(), lg, ATOL)
    serve, tserve = jax_serve_step(cfg), make_serve_step(tcfg)
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    ttok = tlg.argmax(-1)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(tok))
    for i in range(3):
        lg, st = serve(params, tok, st, jnp.full((3,), s + i))
        tlg, tst = tserve(tp, ttok, tst, torch.full((3,), s + i))
        _close("fp32 serve steps", tlg.numpy(), lg, ATOL)
        tok, ttok = jnp.argmax(lg, -1).astype(jnp.int32), tlg.argmax(-1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(tok))


# --- the serving loop --------------------------------------------------------------

def _greedy(tcfg, tp, prompt, n_new, max_seq=64):
    """Single-request greedy decoding: prefill, then decode_step."""
    lg, st = TM.prefill(tcfg, tp, _t(np.asarray(prompt)[None]),
                        cache_len=max_seq)
    tok = lg[:, -1:].argmax(-1)
    out = [int(tok)]
    for i in range(n_new - 1):
        lg, st = TM.decode_step(tcfg, tp, tok, st,
                                torch.tensor([len(prompt) + i]))
        tok = lg[:, -1:].argmax(-1)
        out.append(int(tok))
    return out


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


@pytest.mark.parametrize("n_slots,lens,n_new", [
    (2, (22, 5, 30), 6),             # prompts longer than the window (16)
    (3, (4, 19, 9, 26, 2), 5),       # recycling in every slot
])
def test_serving_loop_matches_jax_loop_and_single_request_greedy(
        scaled, n_slots, lens, n_new):
    cfg, tcfg, params, tp = scaled
    prompts = _prompts(cfg, lens, seed=len(lens))
    reqs = [(i, p, n_new) for i, p in enumerate(prompts)]
    got = {c.rid: c.tokens for c in ServingLoop(
        tcfg, tp, n_slots=n_slots, max_seq=64).run([Request(*r) for r in reqs])}
    jax_got = {c.rid: c.tokens for c in JaxServingLoop(
        cfg, params, n_slots=n_slots, max_seq=64).run(
            [JaxRequest(*r) for r in reqs])}
    oracle = [_greedy(tcfg, tp, p, n_new) for p in prompts]
    assert [got[i] for i in range(len(prompts))] == oracle
    assert [jax_got[i] for i in range(len(prompts))] == oracle


def test_one_token_prompt_in_a_recycled_slot(scaled):
    """A recycled slot's cache must come back with every position at -1: a
    1-token prompt runs no prefill, and its first decode step would
    otherwise attend to the previous request's K/V (or to zeros at position
    0, had the reset zeroed the positions)."""
    cfg, tcfg, _, tp = scaled
    long_, short = _prompts(cfg, (12, 1), seed=8)
    loop = ServingLoop(tcfg, tp, n_slots=1, max_seq=64)
    done = loop.run([Request(0, long_, 5), Request(1, short, 5)])
    assert [c.rid for c in done] == [0, 1]
    assert done[1].tokens == _greedy(tcfg, tp, short, 5)
    assert done[0].tokens == _greedy(tcfg, tp, long_, 5)
    loop._admit(Request(2, long_, 1), 0)
    loop._admit(Request(3, short, 1), 0)
    assert bool((loop.state["cache"]["pos"][:, 0] == -1).all())
    assert not bool(loop.state["cache"]["k"][:, 0].any())


def test_admission_writes_only_its_own_slot(scaled):
    cfg, tcfg, _, tp = scaled
    loop = ServingLoop(tcfg, tp, n_slots=3, max_seq=64)
    a, b = _prompts(cfg, (20, 9), seed=9)
    loop._admit(Request(0, a, 2), 0)
    before = {k: t.clone() for k, t in loop.state["cache"].items()}
    assert bool((before["pos"][:, 0] >= 0).all())          # the ring is full
    loop._admit(Request(1, b, 2), 2)
    after = loop.state["cache"]
    for k in before:
        assert torch.equal(after[k][:, :2], before[k][:, :2]), k
    _, st = TM.prefill(tcfg, tp, _t(b[None, :-1]), cache_len=64)
    for k in before:
        assert torch.equal(after[k][:, 2], st["cache"][k][:, 0]), k
    assert loop.slots[2].pos == len(b) - 1 and loop._tok[2, 0] == b[-1]


def test_serving_loop_stops_at_max_seq(scaled):
    cfg, tcfg, _, tp = scaled
    (p,) = _prompts(cfg, (5,), seed=4)
    done = ServingLoop(tcfg, tp, n_slots=2, max_seq=8).run([Request(0, p, 10)])
    assert len(done[0].tokens) == 8 - 1 - (len(p) - 1)
    assert done[0].tokens == _greedy(tcfg, tp, p, len(done[0].tokens),
                                     max_seq=8)


if __name__ == "__main__":
    import sys

    rc = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    mod = next(m for m in list(sys.modules.values())
               if getattr(m, "__file__", None) == __file__
               and m.__name__ != "__main__")
    for what, err in sorted(mod.REACHED.items()):
        print(f"{what}: {err:.3g}")
    sys.exit(rc)
