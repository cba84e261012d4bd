"""Port parity: head-256 serving on the CPU (``gemma-7b``, ``recurrentgemma-
9b``), against the JAX package.

* ``swa_attention_plain`` at D = 256 against the Pallas kernel
  ``swa_attention_pallas`` in interpret mode (K/V repeated by JAX's
  ``_repeat_kv``), with grouped and single KV heads and a window: fp32
  ``atol 2e-6`` (summation order), bf16 one bf16 ulp (``rtol 2^-7``), as
  ``tests/test_torch_swa.py`` holds D = 120 and 128;
* the models at reduced size but head 256 (``gemma``: 2 ``attn`` layers,
  d 128, 2 heads of 256; ``recurrentgemma``: 5 layers of ``(rglru, rglru,
  local)``, so cycles and a tail of 2 appear, d 128, 4 query heads on 1 KV
  head of 256, window 8, so the ring wraps), vocab 512, fp32, initialised
  by the JAX package and carried by ``params_from_jax``: logits ``atol
  2e-4`` (the rule of PERF.md §2) through ``forward``, ``prefill``,
  ``decode_step`` and the serve steps;
* the port's ``ServingLoop`` on the reduced ``recurrentgemma`` (weights x4,
  so that the context decides the greedy tokens) against single-request
  greedy decoding, exactly; an admission leaves the other slots' rows of
  every state leaf bitwise unchanged; a recycled slot starts from zeros
  (``h``, conv inputs, K/V) and positions -1;
* the backward kernels take D = 256 (slice 16) and still raise on CPU
  tensors before any launch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as C
from repro.kernels.swa_attention import swa_attention_pallas
from repro.launch.serve import make_prefill_step as jax_prefill_step
from repro.launch.serve import make_serve_step as jax_serve_step
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.attention import _repeat_kv as jax_repeat_kv
from repro_torch import configs as TC
from repro_torch import models as TM
from repro_torch.kernels import dispatch
from repro_torch.kernels import swa_attention as sw
from repro_torch.kernels import swa_attention_bwd as swb
from repro_torch.launch import (
    Request,
    ServingLoop,
    make_prefill_step,
    make_serve_step,
)

ATOL = 2e-4
KERNEL_ATOL = 2e-6
BF16_REL = 2.0 ** -7
GEMMA, RG = "gemma-7b", "recurrentgemma-9b"
REDUCED = {
    GEMMA: dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
                head_dim=256, d_ff=256, vocab_size=512),
    RG: dict(n_layers=5, d_model=128, n_heads=4, n_kv_heads=1, head_dim=256,
             d_ff=256, vocab_size=512, lru_width=128, sliding_window=8),
}
F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)

# The largest |port - JAX| each comparison reached; ``python <this file>``
# runs the tests and prints them (PERF.md records them).
REACHED = {}


def _close(what, got, want, atol, rtol=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    REACHED[what] = max(REACHED.get(what, 0.0), float(np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _cfgs(arch, **kw):
    kw = dict(REDUCED[arch], **F32, **kw)
    return (dataclasses.replace(C.get_arch(arch), **kw),
            dataclasses.replace(TC.get_arch(arch), **kw))


def _model(arch, scale=1.0):
    cfg, tcfg = _cfgs(arch)
    params = jax_init_params(cfg, jax.random.key(0))
    if scale != 1.0:
        params = jax.tree.map(lambda x: x * scale, params)
    return cfg, tcfg, params, TM.params_from_jax(
        tcfg, jax.tree.map(np.array, params), device="cpu")


@pytest.fixture(scope="module")
def gemma():
    return _model(GEMMA)


@pytest.fixture(scope="module")
def rgemma():
    return _model(RG)


@pytest.fixture(scope="module")
def scaled():
    """recurrentgemma with weights x4 (the port's tree only: the loop is
    held to the port's own single-request decoding)."""
    _, tcfg = _cfgs(RG)
    tp = TM.init_params(tcfg, seed=3, device="cpu")
    return tcfg, TM.transformer.tree_map(lambda t: t * 4.0, tp)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.int64))


# --- configs and trees --------------------------------------------------------------

@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("arch", [GEMMA, RG])
def test_config_is_a_copy_of_the_jax_config(arch, reduce):
    cfg, tcfg = C.get_arch(arch), TC.get_arch(arch)
    if reduce:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert tcfg.n_params() == cfg.n_params()
    assert arch in TC.list_archs()


# (arch, the tree's count, cfg.n_params()), a record of ROADMAP Queue C 3's
# miscount: n_params() leaves out the final norm (d), and for an rglru
# block counts 3 d W + K W + 3 W where the tree also holds the two W x W
# gate matrices wa and wx and a fourth W-vector (lam). gemma-7b: 3,072
# short; recurrentgemma-9b: 26 x (2 x 4096^2 + 4096) + 4096 = 872,525,824.
COUNTS = [(GEMMA, 8_537_680_896, 8_537_677_824),
          (RG, 9_396_408_320, 8_523_882_496)]


@pytest.mark.parametrize("arch,n_tree,n_cfg", COUNTS)
def test_full_width_tree_matches_jax_shapes_and_counts(arch, n_tree, n_cfg):
    cfg, tcfg = C.get_arch(arch), TC.get_arch(arch)
    jtree = jax.eval_shape(lambda: jax_init_params(cfg, jax.random.key(0)))
    want = TM.param_shapes(tcfg)
    assert len(want["blocks"]) == cfg.n_layers
    assert "unembed" not in want                   # tied embeddings
    plan = TM.layer_plan(tcfg)
    for j, kind in enumerate(plan.cycle_kinds):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                jtree["cycles"][j])[0]:
            node = want["blocks"][j]
            for p in path:
                node = node[p.key]
            assert leaf.shape[0] == plan.n_cycles
            assert tuple(node.shape) == tuple(leaf.shape[1:]), (kind, path)
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jtree))
    assert TM.count_params(want) == n_jax == n_tree
    assert tcfg.n_params() == n_cfg


def test_init_params_casts_each_block_as_drawn_to_the_same_numbers():
    """A bf16 tree drawn leaf by leaf and cast block by block holds the
    numbers of the whole fp32 draw cast afterwards (the generator's
    sequence does not change)."""
    _, tcfg = _cfgs(RG)
    tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16")
    got = TM.init_params(tcfg, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(5)
    want = TM.transformer._build_tree(tcfg, gen)
    for a, b in zip(TM.transformer.tree_leaves(got),
                    TM.transformer.tree_leaves(want)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.bfloat16())


# --- the attention function at D = 256 ----------------------------------------------

# s, window, block_q, block_kv, h, kv: MHA, MQA with a window, GQA with a
# window smaller than a block
PALLAS_CASES = [(32, None, 16, 16, 2, 2), (64, 24, 16, 16, 4, 1),
                (64, 8, 32, 16, 4, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,window,bq,bk,h,kv", PALLAS_CASES)
def test_plain_at_d256_matches_the_pallas_kernel(s, window, bq, bk, h, kv,
                                                 dtype):
    rng = np.random.default_rng(s + h + kv)
    q, k, v = (0.5 * rng.standard_normal((2, s, n, 256), dtype=np.float32)
               for n in (h, kv, kv))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = swa_attention_pallas(
        jnp.asarray(q, jdt), jax_repeat_kv(jnp.asarray(k, jdt), h),
        jax_repeat_kv(jnp.asarray(v, jdt), h), window=window, block_q=bq,
        block_kv=bk, interpret=True)
    tdt = getattr(torch, dtype)
    got = sw.swa_attention_plain(*(torch.from_numpy(x).to(tdt)
                                   for x in (q, k, v)), window=window)
    assert got.dtype == tdt and got.shape == (2, s, h, 256)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        _close("D = 256 fp32 vs pallas", got.numpy(), want, KERNEL_ATOL)
    else:
        _close("D = 256 bf16 vs pallas", got.float().numpy(), want, 1e-6,
               BF16_REL)


def test_the_kernel_takes_d256_and_the_backward_refuses_it_first():
    """The forward's and the backward's head sizes both hold 256 (slice
    16): a D = 256 call passes the head check, and on CPU tensors the
    wrapper raises at its device check, before any launch."""
    assert 256 in sw.HEAD_DIMS and sw.HEAD_DIMS == (64, 120, 128, 256)
    q = torch.zeros(1, 4, 2, 256)
    k = v = torch.zeros(1, 4, 1, 256)
    lse = torch.zeros(1, 2, 4)
    before = (sw.launches, swb.launches)
    with pytest.raises(ValueError, match="CUDA device"):
        swb.swa_attention_bwd_cuda(q, k, v, q, q, lse)
    with pytest.raises(ValueError, match="CUDA device"):
        swb.swa_attention_bwd_cuda(*(torch.zeros(1, 4, n, 128)
                                     for n in (2, 1, 1, 2, 2)), lse)
    with pytest.raises(ValueError, match="CUDA device"):
        sw.swa_attention_cuda(q, k, v)                 # 256 passes its check
    assert (sw.launches, swb.launches) == before
    # on the CPU the differentiable function still trains at D = 256
    q.requires_grad_(True)
    dispatch.swa_attention(q, k, v).sum().backward()
    assert q.grad.shape == q.shape


# --- the models against JAX ---------------------------------------------------------

def _against_jax(cfg, tcfg, params, tp, s, extra):
    """forward over S + extra tokens; prefill of S into a cache of S +
    extra; ``extra`` decode steps, each against JAX's (jitted) step and
    JAX's forward over the whole sequence."""
    toks = _tokens(cfg, (2, s + extra), seed=3)
    full, _, _ = jax_forward(cfg, params, jnp.asarray(toks), mode="train")
    tfull, _, _ = TM.forward(tcfg, tp, _t(toks), mode="train")
    _close("fp32 logits", tfull.numpy(), full, ATOL)
    lg, st = jax_prefill(cfg, params, jnp.asarray(toks[:, :s]),
                         cache_len=s + extra)
    tlg, tst = TM.prefill(tcfg, tp, _t(toks[:, :s]), cache_len=s + extra)
    _close("fp32 logits", tlg.numpy(), lg, ATOL)
    step = jax.jit(lambda t, st_, p_: jax_decode_step(cfg, params, t, st_, p_))
    for i in range(extra):
        tok = toks[:, s + i:s + i + 1]
        lg, st = step(jnp.asarray(tok), st, jnp.full((2,), s + i))
        tlg, tst = TM.decode_step(tcfg, tp, _t(tok), tst,
                                  torch.full((2,), s + i))
        _close("fp32 logits", tlg.numpy(), lg, ATOL)
        _close("fp32 decode vs forward", tlg[:, 0].numpy(), full[:, s + i],
               3e-4)
    return st, tst


def test_gemma_reduced_matches_jax(gemma):
    """Global MHA at head 256, GeGLU, tied embeddings scaled by sqrt(d)."""
    cfg, tcfg, params, tp = gemma
    assert "unembed" not in tp
    assert tp["blocks"][0]["attn"]["wq"].shape == (128, 2 * 256)
    st, tst = _against_jax(cfg, tcfg, params, tp, s=12, extra=3)
    assert tst["cache"]["k"].shape == (2, 2, 15, 2, 256)
    np.testing.assert_array_equal(tst["cache"]["pos"].numpy(),
                                  np.asarray(st["cycles"][0]["cache"]["pos"]))


def test_recurrentgemma_reduced_matches_jax(rgemma):
    """The mixed pattern: 1 cycle of (rglru, rglru, local) and a tail of 2
    rglru, MQA at head 256 with window 8: a prefill of 14 tokens wraps the
    ring, 4 decode steps wrap it again."""
    cfg, tcfg, params, tp = rgemma
    plan = TM.layer_plan(tcfg)
    assert (plan.n_cycles, plan.tail) == (1, (3, 4))
    st, tst = _against_jax(cfg, tcfg, params, tp, s=14, extra=4)
    assert set(tst) == {"rglru", "local"}
    cache = tst["local"]["cache"]
    assert cache["k"].shape == (1, 2, 8, 1, 256)
    np.testing.assert_array_equal(cache["pos"][0].numpy(),
                                  np.asarray(st["cycles"][2]["cache"]["pos"][0]))
    # the recurrent states: layers 0, 1 (cycle 0) and 3, 4 (the tail)
    h = tst["rglru"]["rec"]["h"]
    jh = [st["cycles"][0]["rec"]["h"][0], st["cycles"][1]["rec"]["h"][0],
          st["tail"][0]["rec"]["h"], st["tail"][1]["rec"]["h"]]
    assert h.shape == (4, 2, 128) and h.dtype == torch.float32
    for j, want in enumerate(jh):
        _close("fp32 rglru state", h[j].numpy(), want, 1e-5)


def test_serve_steps_match_jax(rgemma):
    cfg, tcfg, params, tp = rgemma
    s = 11                                      # longer than the window
    toks = _tokens(cfg, (3, s), seed=5)
    lg, st = jax_prefill_step(cfg)(params, {"tokens": jnp.asarray(toks)})
    tlg, tst = make_prefill_step(tcfg)(tp, {"tokens": _t(toks)})
    assert tlg.shape == (3, 1, TM.padded_vocab(tcfg))
    _close("fp32 serve steps", tlg.numpy(), lg, ATOL)
    serve = jax.jit(jax_serve_step(cfg))
    tserve = make_serve_step(tcfg)
    tok, ttok = jnp.argmax(lg, -1).astype(jnp.int32), tlg.argmax(-1)
    for i in range(2):
        lg, st = serve(params, tok, st, jnp.full((3,), s + i))
        tlg, tst = tserve(tp, ttok, tst, torch.full((3,), s + i))
        _close("fp32 serve steps", tlg.numpy(), lg, ATOL)
        tok, ttok = jnp.argmax(lg, -1).astype(jnp.int32), tlg.argmax(-1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(tok))


def test_mixed_decode_state_layout(rgemma):
    _, tcfg, _, _ = rgemma
    assert TM.transformer.state_index(tcfg) == [
        ("rglru", 0), ("rglru", 1), ("local", 0), ("rglru", 2), ("rglru", 3)]
    st = TM.init_decode_state(tcfg, 3, max_seq=40, dtype=torch.bfloat16,
                              device="cpu")
    rec, cache = st["rglru"]["rec"], st["local"]["cache"]
    assert rec["h"].shape == (4, 3, 128) and rec["h"].dtype == torch.float32
    assert rec["conv"].shape == (4, 3, 3, 128)
    assert rec["conv"].dtype == torch.bfloat16
    assert cache["k"].shape == (1, 3, 8, 1, 256)
    assert bool((cache["pos"] == -1).all()) and not bool(rec["h"].any())
    train = TM.init_decode_state(tcfg, 2, mode="train", device="cpu")
    assert train["local"] == {} and train["rglru"]["rec"]["h"].shape[0] == 4
    with pytest.raises(ValueError, match="max_seq"):
        TM.init_decode_state(tcfg, 1, device="cpu")
    # the mixed pattern trains (slice 16)
    assert torch.isfinite(TM.lm_loss(
        tcfg, TM.init_params(tcfg, device="cpu"),
        {"tokens": torch.zeros(1, 4, dtype=torch.long)}))


# --- the serving loop ---------------------------------------------------------------

def _greedy(tcfg, tp, prompt, n_new, max_seq=48):
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
    (2, (13, 5, 20), 5),             # prompts past the window (8)
    (3, (4, 17, 1, 9, 2), 4),        # recycling, a 1-token prompt
])
def test_serving_loop_is_single_request_greedy(scaled, n_slots, lens, n_new):
    tcfg, tp = scaled
    prompts = _prompts(tcfg, lens, seed=len(lens))
    got = {c.rid: c.tokens for c in ServingLoop(
        tcfg, tp, n_slots=n_slots, max_seq=48).run(
            [Request(i, p, n_new) for i, p in enumerate(prompts)])}
    assert [got[i] for i in range(len(prompts))] == \
        [_greedy(tcfg, tp, p, n_new) for p in prompts]


def test_admission_leaves_the_other_slots_bitwise(scaled):
    tcfg, tp = scaled
    leaves = TM.transformer.tree_leaves
    loop = ServingLoop(tcfg, tp, n_slots=3, max_seq=48)
    a, b, c = _prompts(tcfg, (12, 9, 6), seed=9)
    loop._admit(Request(0, a, 2), 0)
    loop._admit(Request(1, b, 2), 1)
    assert bool(loop.state["rglru"]["rec"]["h"][:, :2].any())
    assert bool((loop.state["local"]["cache"]["pos"][:, 0] >= 0).all())
    before = [t.clone() for t in leaves(loop.state)]
    loop._admit(Request(2, c, 2), 2)
    after = leaves(loop.state)
    for x, y in zip(after, before):
        assert torch.equal(x[:, :2], y[:, :2])
    _, st = TM.prefill(tcfg, tp, _t(c[None, :-1]), cache_len=48)
    for x, y in zip(after, leaves(st)):
        assert torch.equal(x[:, 2:], y)
    assert loop.slots[2].pos == len(c) - 1 and loop._tok[2, 0] == c[-1]


def test_a_recycled_slot_starts_from_zeros(scaled):
    """After a long request, a 1-token prompt (no prefill) in the same
    slot finds ``h``, the conv inputs and the K/V zero and every cache
    position -1, and decodes as it would alone."""
    tcfg, tp = scaled
    long_, short = _prompts(tcfg, (15, 1), seed=8)
    loop = ServingLoop(tcfg, tp, n_slots=1, max_seq=48)
    done = loop.run([Request(0, long_, 4), Request(1, short, 4)])
    assert [c.rid for c in done] == [0, 1]
    assert done[1].tokens == _greedy(tcfg, tp, short, 4)
    loop._admit(Request(2, long_, 1), 0)
    loop._admit(Request(3, short, 1), 0)
    rec, cache = loop.state["rglru"]["rec"], loop.state["local"]["cache"]
    assert not bool(rec["h"].any()) and not bool(rec["conv"].any())
    assert not bool(cache["k"].any()) and not bool(cache["v"].any())
    assert bool((cache["pos"] == -1).all())


if __name__ == "__main__":
    import sys

    rc = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    mod = next(m for m in list(sys.modules.values())
               if getattr(m, "__file__", None) == __file__
               and m.__name__ != "__main__")
    for what, err in sorted(mod.REACHED.items()):
        print(f"{what}: {err:.3g}")
    sys.exit(rc)
