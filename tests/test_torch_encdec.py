"""Port parity: whisper-small serving on the CPU (``models/encdec.py``),
against the JAX package.

The JAX package's ``whisper-small.reduced()`` (2 encoder and 2 decoder
layers, d 128, 4 heads of 32, 8 frames, vocab 512, fp32), and the same at
head 64 (``dataclasses.replace``), so that the shapes of the card's D = 64
kernel run through the plain path. JAX initialises the weights and
``params_from_jax`` carries them; frames and tokens are numpy draws.
Tolerances:

* ``sinusoidal_for_positions`` over positions 0-447 at d 768: ``atol
  1e-6`` (the denominators are the same fp32 numbers; sin / cos differ in
  their last bits);
* ``cross_kv`` + ``cross_attention``: ``atol 2e-5``; ``encode``, the
  train-mode logits, ``make_prefill_step``'s logits and caches and a decode
  step after a ``cache_len`` prefill: ``atol 2e-4`` (the rule of PERF.md
  §2), the caches' positions exact;
* inside the port, prefill + 2 decode steps against one forward: ``atol
  3e-4``, JAX's own bound (``tests/test_decode_consistency.py:79``);
* ``swa_attention_plain`` at D = 64 with causal off and Sq != Sk against
  the Pallas kernel in interpret mode: fp32 ``atol 2e-6``, bf16 one bf16
  ulp (``rtol 2^-7``), as ``tests/test_torch_swa.py`` holds D = 120.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as C
from repro.kernels.swa_attention import swa_attention_pallas
from repro.launch.serve import make_prefill_step as jax_prefill_step
from repro.launch.serve import make_serve_step as jax_serve_step
from repro.models import init_params as jax_init_params
from repro.models.attention import _repeat_kv as jax_repeat_kv
from repro.models.attention import cross_attention as jax_cross_attention
from repro.models.attention import cross_kv as jax_cross_kv
from repro.models.encdec import encdec_forward as jax_encdec_forward
from repro.models.encdec import encode as jax_encode
from repro.models.encdec import init_encdec_decode_state as jax_init_state
from repro.models.layers import sinusoidal_for_positions as jax_sinusoidal
from repro_torch import configs as TC
from repro_torch import models as TM
from repro_torch.kernels import dispatch
from repro_torch.kernels import swa_attention as sw
from repro_torch.kernels import swa_attention_bwd as swb
from repro_torch.launch import make_prefill_step, make_serve_step
from repro_torch.models import attention as TA
from repro_torch.models import encdec as TE
from repro_torch.models.layers import (
    sinusoidal_for_positions,
    sinusoidal_positions,
)

ARCH = "whisper-small"
ATOL = 2e-4
CROSS_ATOL = 2e-5
KERNEL_ATOL = 2e-6
BF16_REL = 2.0 ** -7
S = 10                   # prompt tokens; the forward runs S + 2
HEADS = (32, 64)

# The largest |port - JAX| each comparison reached; ``python <this file>``
# runs the tests and prints them (PERF.md records them).
REACHED = {}


def _close(what, got, want, atol, rtol=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    REACHED[what] = max(REACHED.get(what, 0.0), float(np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _cfgs(head):
    return (dataclasses.replace(C.get_arch(ARCH).reduced(), head_dim=head),
            dataclasses.replace(TC.get_arch(ARCH).reduced(), head_dim=head))


def _t(a):
    a = np.asarray(a)
    return torch.as_tensor(a.astype(np.int64) if a.dtype.kind in "iu" else a)


def _layer0(tree):
    return jax.tree.map(lambda x: x[0], tree)


@pytest.fixture(scope="module", params=HEADS, ids=lambda h: f"head{h}")
def model(request):
    """The reduced model at one head size and every JAX result the tests
    hold the port to, each JAX function run once."""
    cfg, tcfg = _cfgs(request.param)
    params = jax_init_params(cfg, jax.random.key(0))
    tp = TM.params_from_jax(tcfg, jax.tree.map(np.array, params),
                            device="cpu")
    rng = np.random.default_rng(request.param)
    f = cfg.n_frontend_tokens
    frames = (0.1 * rng.standard_normal((2, f, cfg.d_model))).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, S + 2))
    jf, jt = jnp.asarray(frames), jnp.asarray(toks)
    want = types.SimpleNamespace()
    want.enc = np.asarray(jax_encode(cfg, params, jf))
    want.full = np.asarray(jax_encdec_forward(cfg, params, jt, jf)[0])
    lg, st = jax_prefill_step(cfg)(params, {"tokens": jt[:, :S],
                                            "frames": jf})
    want.step_logits, want.step_states = np.asarray(lg), jax.tree.map(
        np.asarray, st)
    _, st = jax_encdec_forward(cfg, params, jt[:, :S], jf, mode="prefill",
                               cache_len=S + 2)
    state = jax_init_state(cfg, 2, max_seq=S + 2, n_frames=f,
                           dtype=jnp.float32)
    state["self"] = st["cache"]
    state["cross_k"], state["cross_v"] = st["cross"]["k"], st["cross"]["v"]
    lg, state = jax_serve_step(cfg)(params, jt[:, S:S + 1], state,
                                    jnp.full((2,), S))
    want.decode_logits = np.asarray(lg)
    want.decode_self = jax.tree.map(np.asarray, state["self"])
    # cross-attention of decoder layer 0 on random queries and encoder output
    px = _layer0(params["dec_blocks"]["xattn"])
    want.x = (0.5 * rng.standard_normal((2, 5, cfg.d_model))).astype(
        np.float32)
    want.enc_out = (0.5 * rng.standard_normal((2, f, cfg.d_model))).astype(
        np.float32)
    k, v = jax_cross_kv(px, jnp.asarray(want.enc_out), cfg)
    want.cross_k, want.cross_v = np.asarray(k), np.asarray(v)
    want.cross = np.asarray(jax_cross_attention(px, jnp.asarray(want.x), k,
                                                v, cfg))
    return types.SimpleNamespace(cfg=cfg, tcfg=tcfg, tp=tp, frames=frames,
                                 toks=toks, want=want)


# --- configs, trees, positions ------------------------------------------------------

@pytest.mark.parametrize("reduce", [False, True])
def test_config_is_a_copy_of_the_jax_config(reduce):
    cfg, tcfg = C.get_arch(ARCH), TC.get_arch(ARCH)
    if reduce:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert tcfg.n_params() == cfg.n_params()
    assert ARCH in TC.list_archs()


def test_full_size_tree_matches_jax_shapes_and_count():
    """The meta-device tree at full size has the JAX tree's keys and shapes
    (blocks stacked over 12 + 12 layers) and 238,270,464 parameters, which
    ``count_params`` gives as the sum over the tree."""
    cfg, tcfg = C.get_arch(ARCH), TC.get_arch(ARCH)
    jtree = jax.eval_shape(lambda: jax_init_params(cfg, jax.random.key(0)))
    want = TM.param_shapes(tcfg)
    jflat = {tuple(k.key for k in path): leaf.shape for path, leaf in
             jax.tree_util.tree_flatten_with_path(jtree)[0]}
    got = {}

    def walk(node, path=()):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            assert node.device.type == "meta"
            got[path] = tuple(node.shape)

    walk(want)
    assert got == {k: tuple(v) for k, v in jflat.items()}
    assert got[("enc_blocks", "attn", "wq")] == (12, 768, 768)
    assert got[("dec_blocks", "xattn", "bk")] == (12, 768)
    n = TM.count_params(want)
    assert n == sum(int(np.prod(s)) for s in got.values()) == 238_270_464


def test_init_params_is_seeded_and_cast_as_drawn():
    _, tcfg = _cfgs(64)
    a = TM.init_params(dataclasses.replace(tcfg, param_dtype="bfloat16"),
                       seed=5, device="cpu")
    b = TE.build_encdec_leaf_tree(tcfg, torch.Generator().manual_seed(5))
    la, lb = (TM.transformer.tree_leaves(t) for t in (a, b))
    assert len(la) == len(lb) == 40          # 1 + 13 + 2 + 22 + 2
    assert all(x.dtype == torch.bfloat16 and torch.equal(x, y.bfloat16())
               for x, y in zip(la, lb))


def test_sinusoidal_positions_match_jax():
    want = np.asarray(jax_sinusoidal(jnp.arange(448), 768))
    got = sinusoidal_for_positions(torch.arange(448), 768)
    assert got.dtype == torch.float32 and got.shape == (448, 768)
    _close("sinusoidal d 768", got.numpy(), want, 1e-6)
    pos = np.array([[3], [447]])
    _close("sinusoidal d 768", sinusoidal_for_positions(_t(pos), 768).numpy(),
           np.asarray(jax_sinusoidal(jnp.asarray(pos), 768)), 1e-6)
    assert torch.equal(sinusoidal_positions(448, 768), got)


# --- the model against JAX ----------------------------------------------------------

def test_cross_kv_and_cross_attention_match_jax(model):
    w = model.want
    px = TM.transformer.layer_state(model.tp["dec_blocks"]["xattn"], 0)
    k, v = TA.cross_kv(px, torch.from_numpy(w.enc_out), model.tcfg)
    _close("cross k / v", k.numpy(), w.cross_k, CROSS_ATOL)
    _close("cross k / v", v.numpy(), w.cross_v, CROSS_ATOL)
    got = TA.cross_attention(px, torch.from_numpy(w.x), k, v, model.tcfg)
    _close("cross_attention", got.numpy(), w.cross, CROSS_ATOL)


def test_encode_matches_jax(model):
    got = TE.encode(model.tcfg, model.tp, torch.from_numpy(model.frames))
    _close("encode", got.numpy(), model.want.enc, ATOL)


def test_train_forward_logits_match_jax(model):
    lg, st = TM.encdec_forward(model.tcfg, model.tp, _t(model.toks),
                               torch.from_numpy(model.frames))
    assert st == {} and lg.dtype == torch.float32
    _close("train logits", lg.numpy(), model.want.full, ATOL)


def test_prefill_step_logits_and_states_match_jax(model):
    """The serve step: the last position's logits, the self-attention
    caches (k / v, positions exact) and the cross K/V of every layer."""
    lg, st = make_prefill_step(model.tcfg)(model.tp, {
        "tokens": _t(model.toks[:, :S]),
        "frames": torch.from_numpy(model.frames)})
    want = model.want.step_states
    assert lg.shape == (2, 1, 512)
    _close("prefill step logits", lg.numpy(), model.want.step_logits, ATOL)
    assert set(st) == set(want) == {"cache", "cross"}
    for key in ("k", "v"):
        _close("prefill caches", st["cache"][key].numpy(),
               want["cache"][key], ATOL)
        _close("prefill cross k / v", st["cross"][key].numpy(),
               want["cross"][key], ATOL)
    np.testing.assert_array_equal(st["cache"]["pos"].numpy(),
                                  want["cache"]["pos"])


def test_decode_step_after_a_sized_prefill_matches_jax(model):
    tcfg, tp = model.tcfg, model.tp
    frames = torch.from_numpy(model.frames)
    _, st = TM.encdec_forward(tcfg, tp, _t(model.toks[:, :S]), frames,
                              mode="prefill", cache_len=S + 2)
    state = TM.init_encdec_decode_state(tcfg, 2, max_seq=S + 2,
                                        n_frames=frames.shape[1],
                                        device="cpu")
    state["self"] = st["cache"]
    state["cross_k"], state["cross_v"] = st["cross"]["k"], st["cross"]["v"]
    lg, new = make_serve_step(tcfg)(tp, _t(model.toks[:, S:S + 1]), state,
                                    torch.full((2,), S))
    assert new is state
    _close("decode logits", lg.numpy(), model.want.decode_logits, ATOL)
    for key in ("k", "v"):
        _close("decode caches", state["self"][key].numpy(),
               model.want.decode_self[key], ATOL)
    np.testing.assert_array_equal(state["self"]["pos"].numpy(),
                                  model.want.decode_self["pos"])


def test_prefill_then_two_decode_steps_match_one_forward(model):
    tcfg, tp = model.tcfg, model.tp
    frames, toks = torch.from_numpy(model.frames), _t(model.toks)
    full, _ = TM.encdec_forward(tcfg, tp, toks, frames)
    lg, st = TM.encdec_forward(tcfg, tp, toks[:, :S], frames, mode="prefill",
                               cache_len=S + 2)
    _close("prefill vs forward", lg.numpy(), full[:, :S].numpy(), 3e-4)
    state = TM.init_encdec_decode_state(tcfg, 2, S + 2, frames.shape[1],
                                        device="cpu")
    state.update(self=st["cache"], cross_k=st["cross"]["k"],
                 cross_v=st["cross"]["v"])
    for i in range(2):
        lg, state = TM.encdec_decode_step(tcfg, tp, toks[:, S + i:S + i + 1],
                                          state, torch.full((2,), S + i))
        _close("decode vs forward", lg[:, 0].numpy(),
               full[:, S + i].numpy(), 3e-4)


def test_every_attention_goes_through_the_dispatched_function(model):
    """Per layer, the encoder's attention is bidirectional at Sq = Sk =
    frames, the decoder's self-attention causal and its cross-attention
    bidirectional at Sq != Sk; a decode step dispatches only the
    cross-attention (its self-attention reads the ring cache)."""
    tcfg, tp = model.tcfg, model.tp
    calls = []

    def spy(q, k, v, *, window, causal):
        calls.append((q.shape[1], k.shape[1], q.shape[-1], window, causal))
        return sw.swa_attention_plain(q, k, v, window=window, causal=causal)

    f, hd = model.frames.shape[1], tcfg.head_dim
    frames = torch.from_numpy(model.frames)
    _, st = TE.encdec_forward(tcfg, tp, _t(model.toks[:, :S]), frames,
                              mode="prefill", cache_len=S + 1, swa_impl=spy)
    assert calls == ([(f, f, hd, None, False)] * tcfg.n_encoder_layers
                     + [(S, S, hd, None, True), (S, f, hd, None, False)]
                     * tcfg.n_layers)
    calls.clear()
    state = TE.init_encdec_decode_state(tcfg, 2, S + 1, f, device="cpu")
    state.update(self=st["cache"], cross_k=st["cross"]["k"],
                 cross_v=st["cross"]["v"])
    TE.encdec_decode_step(tcfg, tp, _t(model.toks[:, S:S + 1]), state,
                          torch.full((2,), S), swa_impl=spy)
    assert calls == [(1, f, hd, None, False)] * tcfg.n_layers


# --- the attention function at D = 64 -----------------------------------------------

# sq, sk, block_q, block_kv, h, kv, causal: cross-attention shapes (causal
# off, Sq < Sk as in prefill and Sq = 1 as in a decode step) and the
# decoder's causal self-attention
PALLAS_CASES = [(16, 48, 8, 16, 4, 4, False), (1, 32, 1, 16, 4, 2, False),
                (32, 32, 16, 8, 4, 4, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,bq,bk,h,kv,causal", PALLAS_CASES)
def test_plain_at_d64_matches_the_pallas_kernel(sq, sk, bq, bk, h, kv, causal,
                                                dtype):
    rng = np.random.default_rng(sq + 3 * sk + h + kv)
    q, k, v = (0.5 * rng.standard_normal((2, s, n, 64), dtype=np.float32)
               for s, n in ((sq, h), (sk, kv), (sk, kv)))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = swa_attention_pallas(
        jnp.asarray(q, jdt), jax_repeat_kv(jnp.asarray(k, jdt), h),
        jax_repeat_kv(jnp.asarray(v, jdt), h), causal=causal, block_q=bq,
        block_kv=bk, interpret=True)
    tdt = getattr(torch, dtype)
    got = sw.swa_attention_plain(*(torch.from_numpy(x).to(tdt)
                                   for x in (q, k, v)), causal=causal)
    assert got.dtype == tdt and got.shape == (2, sq, h, 64)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        _close("D = 64 fp32 vs pallas", got.numpy(), want, KERNEL_ATOL)
    else:
        _close("D = 64 bf16 vs pallas", got.float().numpy(), want, 1e-6,
               BF16_REL)


def test_the_forward_takes_d64_and_the_backward_refuses_it():
    """The forward's and, since slice 19 (whisper-small training), the
    backward's head sizes hold 64: a D = 64 backward passes the head check
    and on CPU tensors raises at its device check, before any launch; a
    head size neither kernel takes is refused first."""
    assert 64 in sw.HEAD_DIMS
    for d in sw.HEAD_DIMS:
        swb.check_head_dim("swa_attention_bwd_cuda", d)
    swb.check_head_dim("swa_attention_bwd_cuda", 64)
    with pytest.raises(ValueError, match="got 32"):
        swb.check_head_dim("swa_attention_bwd_cuda", 32)
    q = torch.zeros(1, 4, 2, 64)
    k = torch.zeros(1, 6, 1, 64)
    before = (sw.launches, swb.launches)
    with pytest.raises(ValueError, match="CUDA device"):
        swb.swa_attention_bwd_cuda(q, k, k, q, q, torch.zeros(1, 2, 4),
                                   causal=False)
    with pytest.raises(ValueError, match=r"head sizes \(64, 120, 128, 256\)"):
        swb.swa_attention_bwd_cuda(q[..., :32], k[..., :32], k[..., :32],
                                   q[..., :32], q[..., :32],
                                   torch.zeros(1, 2, 4))
    with pytest.raises(ValueError, match="CUDA device"):
        sw.swa_attention_cuda(q, k, k)                 # 64 passes its check
    assert (sw.launches, swb.launches) == before
    # on the CPU the differentiable function runs its plain backward
    q.requires_grad_(True)
    dispatch.swa_attention(q, k, k, causal=False).sum().backward()
    assert q.grad.shape == q.shape


def test_decoder_only_entry_points_and_training_refuse_the_encdec(model):
    """The decoder-only entry points still refuse an encoder-decoder model;
    training no longer does (slice 19): ``check_trainable`` passes and
    ``lm_loss`` goes to ``encdec_loss``."""
    tcfg, tp = model.tcfg, model.tp
    toks = _t(model.toks[:, :4])
    for call in (lambda: TM.forward(tcfg, tp, toks),
                 lambda: TM.init_decode_state(tcfg, 1, 8, device="cpu")):
        with pytest.raises(NotImplementedError, match="encdec"):
            call()
    TM.transformer.check_trainable(tcfg)
    frames = torch.zeros(toks.shape[0], tcfg.n_frontend_tokens, tcfg.d_model)
    loss = TM.lm_loss(tcfg, tp, {"tokens": toks, "frames": frames})
    assert loss.shape == () and bool(torch.isfinite(loss))


if __name__ == "__main__":
    import sys

    rc = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    mod = next(m for m in list(sys.modules.values())
               if getattr(m, "__file__", None) == __file__
               and m.__name__ != "__main__")
    for what, err in sorted(mod.REACHED.items()):
        print(f"{what}: {err:.3g}")
    sys.exit(rc)
