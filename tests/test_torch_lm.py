"""Port parity: the RWKV6 language model and its serving entry points on the
CPU, against the JAX package.

The reduced ``rwkv6-1.6b`` (2 layers, d 128, 2 WKV heads of 64, vocab 512,
fp32) is initialised by the JAX package and carried into the port with
``params_from_jax`` (or restored from a checkpoint the JAX package saved).
Tolerances:

* fp32 logits: ``atol 2e-4``, the figure of the JAX package's own
  prefill/decode consistency tests (``tests/test_decode_consistency.py``);
  the two sides differ only in summation order;
* bf16 (parameters and compute in bfloat16): logits within ``BF16_ATOL``
  = 4 x 2^-8, four bf16 ulp of the logits' magnitude (below 1 here): the
  logits are a bf16 product rounded once, and the two frameworks round the
  bf16 elementwise chains before it at other places (XLA's CPU keeps fused
  chains in fp32);
* greedy tokens are compared exactly, with the weights scaled x6 so that
  the recurrent state decides them (at the init scale the next token barely
  depends on the state).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as C
from repro.checkpoint import save as jax_save
from repro.launch.serve import make_prefill_step as jax_prefill_step
from repro.launch.serve import make_serve_step as jax_serve_step
from repro.launch.serving_loop import Request as JaxRequest
from repro.launch.serving_loop import ServingLoop as JaxServingLoop
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro_torch import configs as TC
from repro_torch import models as TM
from repro_torch.checkpoint import restore
from repro_torch.launch import (
    Request,
    ServingLoop,
    make_prefill_step,
    make_serve_step,
)

ATOL = 2e-4
BF16_ATOL = 4 * 2.0 ** -8
ARCH = "rwkv6-1.6b"

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


@pytest.fixture(scope="module")
def reduced():
    cfg = C.get_arch(ARCH).reduced()
    tcfg = TC.get_arch(ARCH).reduced()
    params = jax_init_params(cfg, jax.random.key(0))
    return cfg, tcfg, params, TM.params_from_jax(tcfg, _np_tree(params),
                                                 device="cpu")


@pytest.fixture(scope="module")
def scaled():
    """Weights x6: greedy tokens then depend on the recurrent state."""
    cfg = C.get_arch(ARCH).reduced()
    tcfg = TC.get_arch(ARCH).reduced()
    params = jax.tree.map(lambda x: x * 6,
                          jax_init_params(cfg, jax.random.key(0)))
    return cfg, tcfg, params, TM.params_from_jax(tcfg, _np_tree(params),
                                                 device="cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.int64))


# --- configs ---------------------------------------------------------------------

@pytest.mark.parametrize("reduce", [False, True])
def test_config_is_a_copy_of_the_jax_config(reduce):
    cfg, tcfg = C.get_arch(ARCH), TC.get_arch(ARCH)
    if reduce:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert tcfg.n_params() == cfg.n_params()
    assert tcfg.n_active_params() == cfg.n_active_params()
    assert tcfg.is_subquadratic == cfg.is_subquadratic
    assert [tcfg.block_kind(i) for i in range(tcfg.n_layers)] == \
        [cfg.block_kind(i) for i in range(cfg.n_layers)]


def test_config_registry_and_checks_follow_the_jax_package():
    assert ARCH in TC.list_archs()
    with pytest.raises(ValueError, match="duplicate"):
        TC.register_arch(TC.get_arch(ARCH))
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_arch("no-such-model")
    base = dict(name="x", family="dense", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=3, head_dim=16, d_ff=128, vocab_size=256)
    for kw, msg in ((dict(), "divisible"),
                    (dict(n_kv_heads=4, layer_pattern=("mamba",)), "unknown"),
                    (dict(n_kv_heads=4, layer_pattern=("local",)), "sliding")):
        with pytest.raises(ValueError, match=msg):
            TC.ModelConfig(**{**base, **kw})
        with pytest.raises(ValueError, match=msg):
            C.ModelConfig(**{**base, **kw})
    assert TC.get_shape("decode_32k") == TC.InputShape(
        *dataclasses.astuple(C.get_shape("decode_32k")))


def test_full_width_tree_matches_jax_shapes_and_counts():
    """rwkv6-1.6b at full width: every leaf of the port's tree has the shape
    of the JAX tree's leaf (cycles unstacked), 1,584,144,384 parameters;
    ``n_params()`` says 1,734,541,312 on both sides (it miscounts RWKV)."""
    cfg, tcfg = C.get_arch(ARCH), TC.get_arch(ARCH)
    jtree = jax.eval_shape(lambda: jax_init_params(cfg, jax.random.key(0)))
    want = TM.param_shapes(tcfg)
    assert len(jtree["cycles"]) == 1 and len(want["blocks"]) == 24
    for key in ("embed", "final_norm", "unembed", "ln0"):
        for name, leaf in jtree[key].items():
            assert tuple(want[key][name].shape) == tuple(leaf.shape), key
    flat_j = jax.tree_util.tree_flatten_with_path(jtree["cycles"][0])[0]
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        node = want["blocks"][5]
        for k in keys:
            node = node[k]
        assert leaf.shape[0] == 24
        assert tuple(node.shape) == tuple(leaf.shape[1:]), keys
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jtree))
    assert TM.count_params(want) == n_jax == 1_584_144_384
    assert tcfg.n_params() == cfg.n_params() == 1_734_541_312


# --- the model against JAX -------------------------------------------------------------

def _wkv_state(jax_states):
    return np.asarray(jax_states["cycles"][0]["wkv"]["tm"]["wkv"])


def test_forward_prefill_decode_match_jax(reduced):
    cfg, tcfg, params, tp = reduced
    s = 12
    toks = _tokens(cfg, (2, s + 1), seed=1)
    full, _, _ = jax_forward(cfg, params, jnp.asarray(toks), mode="train")
    tfull, _, aux = TM.forward(tcfg, tp, _t(toks), mode="train")
    assert tfull.dtype == torch.float32 and float(aux) == 0.0
    assert tfull.shape == (2, s + 1, TM.padded_vocab(tcfg))
    _close("fp32 logits", tfull.numpy(), full, ATOL)

    lg, st = jax_prefill(cfg, params, jnp.asarray(toks[:, :s]),
                         cache_len=s + 2)
    tlg, tst = TM.prefill(tcfg, tp, _t(toks[:, :s]))
    _close("fp32 logits", tlg.numpy(), lg, ATOL)
    _close("fp32 wkv state", tst["tm"]["wkv"].numpy(), _wkv_state(st), ATOL)
    lg2, _ = jax_decode_step(cfg, params, jnp.asarray(toks[:, s:s + 1]), st,
                             jnp.full((2,), s))
    wkv_buf = tst["tm"]["wkv"]
    tlg2, tst2 = TM.decode_step(tcfg, tp, _t(toks[:, s:s + 1]), tst,
                                torch.full((2,), s))
    assert tst2 is tst and tst2["tm"]["wkv"] is wkv_buf     # in place
    _close("fp32 logits", tlg2.numpy(), lg2, ATOL)
    np.testing.assert_allclose(tlg2[:, 0].numpy(), tfull[:, s].numpy(),
                               atol=ATOL)


def test_multi_token_decode_chain_matches_jax_forward(reduced):
    cfg, tcfg, params, tp = reduced
    s, extra = 8, 4
    toks = _tokens(cfg, (1, s + extra), seed=2)
    full, _, _ = jax_forward(cfg, params, jnp.asarray(toks), mode="train")
    _, st = TM.prefill(tcfg, tp, _t(toks[:, :s]))
    for i in range(extra):
        lg, st = TM.decode_step(tcfg, tp, _t(toks[:, s + i:s + i + 1]), st,
                                torch.full((1,), s + i))
        _close("fp32 decode chain", lg[:, 0].numpy(), full[:, s + i], 3e-4)


def test_jax_saved_checkpoint_restores_into_the_port(reduced, tmp_path):
    cfg, tcfg, params, tp = reduced
    jax_save(str(tmp_path), 3, params, {"arch": ARCH})
    tree, meta = restore(str(tmp_path))
    assert meta["step"] == 3 and meta["arch"] == ARCH
    tp2 = TM.params_from_jax(tcfg, tree, device="cpu")
    for a, b in zip(TM.transformer.tree_leaves(tp2),
                    TM.transformer.tree_leaves(tp)):
        assert torch.equal(a, b)
    toks = _tokens(cfg, (2, 9), seed=3)
    lg, _ = jax_prefill(cfg, params, jnp.asarray(toks))
    tlg, _ = TM.prefill(tcfg, tp2, _t(toks))
    _close("fp32 logits (checkpoint)", tlg.numpy(), lg, ATOL)


def test_bf16_reduced_run_matches_jax_to_bf16_rounding():
    cfg = dataclasses.replace(C.get_arch(ARCH).reduced(),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    tcfg = dataclasses.replace(TC.get_arch(ARCH).reduced(),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    params = jax_init_params(cfg, jax.random.key(0))
    tp = TM.params_from_jax(tcfg, _np_tree(params), device="cpu")
    leaf = tp["blocks"][0]["tm"]["wr"]
    assert leaf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        leaf.float().numpy(),
        np.asarray(params["cycles"][0]["tm"]["wr"][0], np.float32))
    s = 10
    toks = _tokens(cfg, (2, s + 1), seed=4)
    lg, st = jax_prefill(cfg, params, jnp.asarray(toks[:, :s]))
    tlg, tst = TM.prefill(tcfg, tp, _t(toks[:, :s]))
    assert tst["tm"]["shift"].dtype == torch.bfloat16
    assert tst["tm"]["wkv"].dtype == torch.float32
    _close("bf16 logits", tlg.numpy(), lg, BF16_ATOL)
    lg2, _ = jax_decode_step(cfg, params, jnp.asarray(toks[:, s:]), st,
                             jnp.full((2,), s))
    tlg2, _ = TM.decode_step(tcfg, tp, _t(toks[:, s:]), tst,
                             torch.full((2,), s))
    _close("bf16 logits", tlg2.numpy(), lg2, BF16_ATOL)


def test_prefill_and_serve_steps_match_jax(reduced):
    cfg, tcfg, params, tp = reduced
    toks = _tokens(cfg, (3, 11), seed=5)
    lg, st = jax_prefill_step(cfg)(params, {"tokens": jnp.asarray(toks)})
    tlg, tst = make_prefill_step(tcfg)(tp, {"tokens": _t(toks)})
    assert tlg.shape == (3, 1, TM.padded_vocab(tcfg))
    _close("fp32 serve steps", tlg.numpy(), lg, ATOL)
    serve, tserve = jax_serve_step(cfg), make_serve_step(tcfg)
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    ttok = tlg.argmax(-1)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(tok))
    for i in range(3):
        lg, st = serve(params, tok, st, jnp.full((3,), 11 + i))
        tlg, tst = tserve(tp, ttok, tst, torch.full((3,), 11 + i))
        _close("fp32 serve steps", tlg.numpy(), lg, ATOL)
        tok, ttok = jnp.argmax(lg, -1).astype(jnp.int32), tlg.argmax(-1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(tok))


# --- the serving loop --------------------------------------------------------------------

def _greedy(tcfg, tp, prompt, n_new):
    """Single-request greedy decoding: prefill, then decode_step."""
    lg, st = TM.prefill(tcfg, tp, _t(np.asarray(prompt)[None]))
    tok = lg[:, -1:].argmax(-1)
    out = [int(tok)]
    for i in range(n_new - 1):
        lg, st = TM.decode_step(tcfg, tp, tok, st,
                                torch.tensor([len(prompt) + i]))
        tok = lg[:, -1:].argmax(-1)
        out.append(int(tok))
    return out


def _jax_greedy(cfg, params, prompt, n_new):
    lg, st = jax_prefill(cfg, params, jnp.asarray(prompt)[None], cache_len=64)
    tok = jnp.argmax(lg[:, -1:], -1).astype(jnp.int32)
    out = [int(tok[0, 0])]
    for i in range(n_new - 1):
        lg, st = jax_decode_step(cfg, params, tok, st,
                                 jnp.asarray([len(prompt) + i]))
        tok = jnp.argmax(lg[:, -1:], -1).astype(jnp.int32)
        out.append(int(tok[0, 0]))
    return out


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


@pytest.mark.parametrize("n_slots,lens,n_new", [
    (1, (6, 6, 1), 3),                 # one slot recycled twice; 1-token prompt
    (2, (5, 3, 7), 4),
    (2, (4, 9, 2, 6, 3), 3),           # recycling in both slots
])
def test_serving_loop_matches_single_request_greedy(scaled, n_slots, lens,
                                                    n_new):
    cfg, tcfg, params, tp = scaled
    prompts = _prompts(cfg, lens, seed=len(lens) + n_slots)
    loop = ServingLoop(tcfg, tp, n_slots=n_slots, max_seq=64)
    done = loop.run([Request(i, p, n_new) for i, p in enumerate(prompts)])
    got = {c.rid: c.tokens for c in done}
    assert sorted(got) == list(range(len(prompts)))
    for i, p in enumerate(prompts):
        assert got[i] == _greedy(tcfg, tp, p, n_new), f"request {i}"


def test_jax_serving_loop_advances_other_slots_where_the_port_does_not(scaled):
    """ROADMAP Queue C: ``repro.launch.serving_loop.ServingLoop._admit``
    feeds each prompt token through ``decode_step`` over all slots, so the
    other active slot's WKV state advances once per prompt token. With 2
    slots and prompts of 5, 3 and 7 tokens, request 0 leaves single-request
    greedy decoding in the JAX loop and stays on it in the port's loop."""
    cfg, tcfg, params, tp = scaled
    prompts = _prompts(cfg, (5, 3, 7), seed=0)
    reqs = [(i, p, 4) for i, p in enumerate(prompts)]
    oracle = [_jax_greedy(cfg, params, p, 4) for p in prompts]
    assert oracle == [_greedy(tcfg, tp, p, 4) for p in prompts]
    jax_got = {c.rid: c.tokens for c in JaxServingLoop(
        cfg, params, n_slots=2, max_seq=64).run([JaxRequest(*r) for r in reqs])}
    got = {c.rid: c.tokens for c in ServingLoop(
        tcfg, tp, n_slots=2, max_seq=64).run([Request(*r) for r in reqs])}
    assert [got[i] for i in range(3)] == oracle
    assert jax_got[0] != oracle[0]
    assert [jax_got[1], jax_got[2]] == oracle[1:]


def test_admission_writes_only_its_own_slot(scaled):
    cfg, tcfg, _, tp = scaled
    loop = ServingLoop(tcfg, tp, n_slots=3, max_seq=64)
    a, b = _prompts(cfg, (6, 5), seed=9)
    loop._admit(Request(0, a, 2), 0)
    before = {k: t.clone() for k, t in (("shift", loop.state["tm"]["shift"]),
                                        ("wkv", loop.state["tm"]["wkv"]),
                                        ("cm", loop.state["cm_shift"]))}
    assert before["wkv"][:, 0].abs().sum() > 0
    loop._admit(Request(1, b, 2), 2)
    after = {"shift": loop.state["tm"]["shift"], "wkv": loop.state["tm"]["wkv"],
             "cm": loop.state["cm_shift"]}
    for k in before:
        assert torch.equal(after[k][:, :2], before[k][:, :2]), k
    _, st = TM.prefill(tcfg, tp, _t(b[None, :-1]))
    torch.testing.assert_close(after["wkv"][:, 2], st["tm"]["wkv"][:, 0],
                               atol=0, rtol=0)
    assert loop.slots[2].pos == len(b) - 1 and loop._tok[2, 0] == b[-1]


def test_serving_loop_stops_at_max_seq(scaled):
    cfg, tcfg, _, tp = scaled
    (p,) = _prompts(cfg, (5,), seed=4)
    done = ServingLoop(tcfg, tp, n_slots=2, max_seq=8).run([Request(0, p, 10)])
    assert len(done[0].tokens) == 8 - 1 - (len(p) - 1)
    assert done[0].tokens == _greedy(tcfg, tp, p, len(done[0].tokens))


# --- what the port does not run yet ------------------------------------------------------

@pytest.mark.parametrize("arch,match", [
    ("recurrentgemma-9b", "rglru"),
    ("kimi-k2-1t-a32b", "MoE"),
    ("whisper-small", "encoder-decoder"),
    ("internvl2-26b", "frontend"),
])
def test_other_models_raise_naming_their_slice(arch, match):
    fields = dataclasses.asdict(C.get_arch(arch).reduced())
    tcfg = TC.ModelConfig(**fields)
    if arch == "whisper-small":
        # served since slice 18 (models/encdec.py) through the serve steps,
        # trained since slice 19 (encdec_loss); the decoder-only entry
        # points raise
        assert tcfg.is_encoder_decoder
        params = TM.init_params(tcfg, device="cpu")
        toks = torch.zeros(2, 3, dtype=torch.long)
        frames = torch.zeros(2, tcfg.n_frontend_tokens, tcfg.d_model)
        lg, st = make_prefill_step(tcfg)(params, {"tokens": toks,
                                                  "frames": frames})
        state = TM.init_encdec_decode_state(tcfg, 2, 4, frames.shape[1],
                                            device="cpu")
        state.update(self=st["cache"], cross_k=st["cross"]["k"],
                     cross_v=st["cross"]["v"])
        lg2, _ = make_serve_step(tcfg)(params, lg.argmax(-1), state,
                                       torch.full((2,), 3))
        assert lg.shape == lg2.shape == (2, 1, TM.padded_vocab(tcfg))
        assert bool(torch.isfinite(lg2).all())
        TM.transformer.check_trainable(tcfg)
        with pytest.raises(NotImplementedError, match=match):
            TM.init_decode_state(tcfg, 1, device="cpu")
        return
    if arch == "kimi-k2-1t-a32b":
        # served since slice 20 (models/moe.py) through the serve steps;
        # lm_loss refuses it, naming MoE
        params = TM.init_params(tcfg, device="cpu")
        lg, st = make_prefill_step(tcfg)(params, {"tokens": torch.zeros(
            2, 3, dtype=torch.long)})
        lg2, _ = make_serve_step(tcfg)(params, lg.argmax(-1), st,
                                       torch.full((2,), 3))
        assert bool(torch.isfinite(lg2).all())
        with pytest.raises(NotImplementedError, match=match):
            TM.lm_loss(tcfg, params, {"tokens": torch.zeros(
                1, 4, dtype=torch.long)})
        return
    if arch == "recurrentgemma-9b":
        # served since slice 15, trained since slice 16: its rglru blocks
        # differentiate (the name of the kind is in its layer pattern)
        assert match in tcfg.layer_pattern
        params = TM.init_params(tcfg, device="cpu")
        assert torch.isfinite(TM.lm_loss(tcfg, params, {"tokens": torch.zeros(
            1, 4, dtype=torch.long)}))
        return
    # internvl2-26b: served and trained since slice 21 with the vision
    # frontend's patch embeddings before the tokens (tests/test_torch_vlm.py
    # holds it against JAX); no entry point raises for it
    assert match == "frontend" and tcfg.frontend == "vision"
    params = TM.init_params(tcfg, device="cpu")
    F = tcfg.n_frontend_tokens
    emb = torch.zeros(2, F, tcfg.d_model)
    lg, st = make_prefill_step(tcfg)(params, {"tokens": torch.zeros(
        2, 3, dtype=torch.long), "patch_embeds": emb})
    assert st["cache"]["k"].shape[2] == F + 3
    lg2, _ = make_serve_step(tcfg)(params, lg.argmax(-1), st,
                                   torch.full((2,), F + 3))
    assert bool(torch.isfinite(lg2).all())
    TM.transformer.check_trainable(tcfg)
    assert torch.isfinite(TM.lm_loss(tcfg, params, {"tokens": torch.zeros(
        2, 4, dtype=torch.long), "patch_embeds": emb}))
    st = TM.init_decode_state(tcfg, 1, max_seq=F + 4, device="cpu")
    assert tuple(st["cache"]["k"].shape[:3]) == (tcfg.n_layers, 1, F + 4)


def test_chunked_wkv_is_not_ported(reduced):
    _, tcfg, _, tp = reduced
    cfg = dataclasses.replace(tcfg, wkv_impl="chunked")
    with pytest.raises(NotImplementedError, match="wkv_chunked"):
        TM.forward(cfg, tp, _t([[1, 2, 3]]))


def test_init_params_is_seeded_and_typed():
    tcfg = TC.get_arch(ARCH).reduced()
    a = TM.init_params(tcfg, seed=3, device="cpu")
    b = TM.init_params(tcfg, seed=3, device="cpu")
    c = TM.init_params(tcfg, seed=4, device="cpu")
    la, lb, lc = (TM.transformer.tree_leaves(t) for t in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not torch.equal(a["unembed"]["w"], c["unembed"]["w"])
    assert TM.count_params(a) == TM.count_params(TM.param_shapes(tcfg))
    assert all(x.dtype == torch.float32 for x in la)
    torch.testing.assert_close(a["blocks"][1]["tm"]["gn_scale"],
                               torch.ones(tcfg.d_model))
    bf = TM.init_params(dataclasses.replace(tcfg, param_dtype="bfloat16"),
                        seed=3, device="cpu")
    assert bf["embed"]["table"].dtype == torch.bfloat16


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    tcfg = TC.get_arch(ARCH).reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.init_params(tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.init_decode_state(tcfg, 2)


def test_params_from_jax_checks_the_tree(reduced):
    cfg, tcfg, params, _ = reduced
    tree = _np_tree(params)
    tree["cycles"][0]["tm"]["wr"] = tree["cycles"][0]["tm"]["wr"][:, :, :64]
    with pytest.raises(ValueError, match="wr has shape"):
        TM.params_from_jax(tcfg, tree, device="cpu")
    tree = _np_tree(params)
    del tree["ln0"]
    with pytest.raises(ValueError, match="ln0"):
        TM.params_from_jax(tcfg, tree, device="cpu")


if __name__ == "__main__":
    import sys

    rc = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    mod = next(m for m in list(sys.modules.values())
               if getattr(m, "__file__", None) == __file__
               and m.__name__ != "__main__")
    for what, err in sorted(mod.REACHED.items()):
        print(f"{what}: {err:.3g}")
    sys.exit(rc)
