"""Port parity: whisper-small training on the CPU (``encdec_loss`` through
``lm_loss``, the enc-dec ``ParamLayout``, ``train()``), against the JAX
package.

The JAX package's ``whisper-small.reduced()`` (2 encoder and 2 decoder
layers, d 128, 4 heads, 8 frames, vocab 512, fp32) at head 64, the card's
D = 64 backward's head size (``dataclasses.replace``); ``train()`` runs the
registered reduced config (head 32) on both sides. JAX initialises the
weights and ``params_from_jax`` / ``train_state_from_jax`` carry them;
frames and tokens are numpy draws. JAX's loss and gradients are computed
once, in a module fixture, by one jitted program for both cross-entropy
branches. Tolerances, as ``tests/test_torch_lm_train.py`` holds the
decoder-only model:

* the loss: ``rtol 1e-5, atol 1e-6``; every gradient within ``1e-5`` of
  its leaf's largest |gradient| (fp32, summation order), but the key
  biases': those are zero in exact arithmetic (a bias on every key adds
  one number to all of a query row's scores, which the softmax drops),
  so both sides hold rounding noise there, each held under ``1e-5`` of
  the largest |gradient| of the whole tree;
* ``swa_attention_bwd_plain`` at D = 64 against ``jax.vjp`` of JAX's
  ``flash_attention`` on repeated K/V: ``atol 1e-5``;
* at frames off JAX's attention chunk (12 frames, chunk 8), ``encode``
  and the cross-attention against JAX's exact paths (``attn_impl
  "einsum"`` and ``cross_attention``): ``atol 1e-5``, the encoder's
  gradient with respect to the frames too; JAX's flash paths must differ
  there by more than ``OFF_CHUNK_GAP``, their padded keys' weight in the
  softmax;
* two steps of ``train()``: losses ``rtol 1e-5, atol 1e-6``, parameters
  ``atol 5e-5`` (Adam near zero-gradient components);
* the layout against ``ravel_pytree`` and remat on against off: bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import repro.configs as JC
import repro.optim as JO
from repro.launch import fedtrain as JF
from repro.launch import train as JT
from repro.models import init_params as jax_init_params
from repro.models import encdec as JE
from repro.models import lm_loss as jax_lm_loss
from repro.models.attention import _flash_fwd_impl, flash_attention
from repro.models.attention import _repeat_kv as jax_repeat_kv
from repro_torch import configs as TC
from repro_torch import models as TM
from repro_torch import optim as TO
from repro_torch.kernels import dispatch
from repro_torch.kernels import swa_attention as sw
from repro_torch.kernels import swa_attention_bwd as swb
from repro_torch.launch import fedtrain as TF
from repro_torch.launch import train as TT
from repro_torch.models import attention as TA
from repro_torch.models import encdec as TE

ARCH = "whisper-small"
RTOL, ATOL = 1e-5, 1e-6
GRAD_REL = 1e-5
BWD_ATOL = 1e-5
PARAM_ATOL = 5e-5
OFF_CHUNK_ATOL, OFF_CHUNK_GAP = 1e-5, 1e-3
A, B, S, TAU = 2, 2, 12, 2


def _cfgs(**kw):
    kw = dict(head_dim=64, **kw)
    return (dataclasses.replace(JC.get_arch(ARCH).reduced(), **kw),
            dataclasses.replace(TC.get_arch(ARCH).reduced(), **kw))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    frames = 0.5 * rng.standard_normal((B, cfg.n_frontend_tokens,
                                        cfg.d_model), dtype=np.float32)
    return toks, frames


def _tbatch(toks, frames):
    return {"tokens": torch.from_numpy(toks).long(),
            "frames": torch.from_numpy(frames)}


@pytest.fixture(scope="module")
def jax_side():
    """JAX's tree and, from one jitted program, the loss and gradient with
    ``ce_chunks`` 0 (the logits materialised) and 2 (B split in two)."""
    jc, _ = _cfgs()
    tree = jax.device_get(jax_init_params(jc, jax.random.key(0)))
    toks, frames = _batch(jc)
    vg = jax.jit(lambda p, t, f: [jax.value_and_grad(
        lambda q: jax_lm_loss(dataclasses.replace(jc, ce_chunks=c), q,
                              {"tokens": t, "frames": f}))(p)
        for c in (0, 2)])
    out = jax.device_get(vg(tree, jnp.asarray(toks), jnp.asarray(frames)))
    return {"tree": tree, "tokens": toks, "frames": frames, "loss_grad": out}


def _leaves(tc, tree):
    params = TM.params_from_jax(tc, tree, device="cpu")
    return TM.transformer.tree_map(lambda t: t.requires_grad_(), params)


@pytest.mark.parametrize("branch", [0, 1], ids=["logits", "chunked"])
def test_encdec_loss_and_gradients_match_jax(jax_side, branch):
    """``lm_loss`` goes to ``encdec_loss`` for an encoder-decoder config, as
    JAX's does; its value and every gradient against JAX's, in both CE
    branches (``cfg.ce_chunks``, the one JAX's ``encdec_loss`` reads)."""
    _, tc = _cfgs(ce_chunks=(0, 2)[branch])
    leaves = _leaves(tc, jax_side["tree"])
    loss = TM.lm_loss(tc, leaves, _tbatch(jax_side["tokens"],
                                          jax_side["frames"]))
    loss.backward()
    want_loss, want_grad = jax_side["loss_grad"][branch]
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=RTOL, atol=ATOL)
    want = TM.params_from_jax(tc, want_grad, device="cpu")
    paths = dispatch.tree_paths(leaves)
    got_l = dispatch.tree_leaves(leaves)
    want_l = dispatch.tree_leaves(want)
    assert paths == dispatch.tree_paths(want)
    assert len(got_l) == len(want_l) == len(jax.tree.leaves(want_grad))
    top = max(float(w.abs().max()) for w in want_l)
    for path, got, w in zip(paths, got_l, want_l):
        if path[-1] == "bk":
            assert max(float(got.grad.abs().max()),
                       float(w.abs().max())) <= GRAD_REL * top
            continue
        scale = max(float(w.abs().max()), 1e-30)
        assert float((got.grad - w).abs().max()) <= GRAD_REL * scale


# (Sq, Sk, causal): the cross-attention's Sq < Sk and Sq > Sk with the mask
# off, and the decoder's causal self-attention; 4 query heads on 2 KV heads
# (Sk a multiple of the chunk: JAX's flash_attention pads the keys to whole
# chunks and, with the mask off, keeps the zero padding in the softmax)
@pytest.mark.parametrize("sq,sk,causal", [(5, 24, False), (21, 8, False),
                                          (13, 13, True)])
def test_plain_backward_at_d64_matches_jax_flash_vjp(sq, sk, causal):
    b, h, kv, d, chunk = 2, 4, 2, 64, 8
    rng = np.random.default_rng(sq * sk)
    q = 0.5 * rng.standard_normal((b, sq, h, d), dtype=np.float32)
    k, v = (0.5 * rng.standard_normal((b, sk, kv, d), dtype=np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    jq = jnp.asarray(q)
    jk, jv = (jax_repeat_kv(jnp.asarray(x), h) for x in (k, v))
    _, jlse = _flash_fwd_impl(jq, jk, jv, causal, None, chunk, 0)
    _, vjp = jax.vjp(lambda a, b_, c: flash_attention(a, b_, c, causal, None,
                                                      chunk, 0), jq, jk, jv)
    gq, gk, gv = vjp(jnp.asarray(do))
    fold = lambda g: np.asarray(g).reshape(b, sk, kv, h // kv, d).sum(3)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = sw.swa_attention_plain(tq, tk, tv, causal=causal, with_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=BWD_ATOL)
    dq, dk, dv = swb.swa_attention_bwd_plain(tq, tk, tv, o,
                                             torch.from_numpy(do), lse,
                                             causal=causal)
    for got, want in ((dq, gq), (dk, fold(gk)), (dv, fold(gv))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=BWD_ATOL)
    swb.check_head_dim("swa_attention_bwd_cuda", 64)


def test_frames_off_the_chunk_match_jax_exact_attention(jax_side):
    """At a frame count that is not a multiple of ``cfg.attn_chunk`` (the
    full-size 1,500 frames against chunk 512), JAX's ``flash_attention``
    keeps its zero-padded keys in the softmax with the mask off; the port
    attends over the real keys only. So the port's encoder (value and
    gradient with respect to the frames) and train-mode cross-attention
    match JAX's exact paths there, and JAX's flash paths differ from both:
    the port departs from JAX only by that padding."""
    jc, tc = _cfgs()
    frames_n = jc.attn_chunk + 4
    assert frames_n % jc.attn_chunk
    tree = jax_side["tree"]
    rng = np.random.default_rng(5)
    frames = 0.5 * rng.standard_normal((B, frames_n, jc.d_model),
                                       dtype=np.float32)
    w = rng.standard_normal(frames.shape, dtype=np.float32)
    exact_cfg = dataclasses.replace(jc, attn_impl="einsum")
    want, vjp = jax.vjp(lambda f: JE.encode(exact_cfg, tree, f),
                        jnp.asarray(frames))
    (want_g,) = vjp(jnp.asarray(w))
    flash = np.asarray(JE.encode(jc, tree, jnp.asarray(frames)))
    params = TM.params_from_jax(tc, tree, device="cpu")
    tf = torch.from_numpy(frames).requires_grad_()
    got = TE.encode(tc, params, tf)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=OFF_CHUNK_ATOL)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_g),
                               atol=OFF_CHUNK_ATOL)
    assert np.abs(flash - np.asarray(want)).max() > OFF_CHUNK_GAP

    jp = jax.tree.map(lambda t: t[0], tree["dec_blocks"]["xattn"])
    tp = TM.transformer.tree_map(lambda t: t[0],
                                 params["dec_blocks"]["xattn"])
    x = 0.5 * rng.standard_normal((B, S, jc.d_model), dtype=np.float32)
    jk, jv = JE.cross_kv(jp, want, jc)
    exact = np.asarray(JE.cross_attention(jp, jnp.asarray(x), jk, jv, jc))
    padded = np.asarray(JE.cross_attention_flash(jp, jnp.asarray(x), jk, jv,
                                                 jc))
    tk, tv = TA.cross_kv(tp, got.detach(), tc)
    cross = TA.cross_attention(tp, torch.from_numpy(x), tk, tv, tc)
    np.testing.assert_allclose(cross.numpy(), exact, atol=OFF_CHUNK_ATOL)
    assert np.abs(padded - exact).max() > OFF_CHUNK_GAP


def test_encdec_layout_is_ravel_pytree_order_and_views_the_row(jax_side):
    """``ParamLayout`` of the enc-dec tree (``dec_blocks``, ``embed``,
    ``enc_blocks``, ``enc_norm``, ``final_norm``): ``ravel`` fills each
    agent's row with ``ravel_pytree``'s bits, ``jax_tree`` reads the same
    tree back, ``model_params`` views the row as the port's tree."""
    _, tc = _cfgs()
    tree = jax_side["tree"]
    layout = TF.ParamLayout(tc)
    assert [p[0] for p in layout.paths][::len(layout.paths) - 1] == \
        ["dec_blocks", "final_norm"]
    want = np.asarray(ravel_pytree(tree)[0])
    stacked = jax.tree.map(lambda x: np.stack([x, 2 * x]), tree)
    out = torch.empty((2, layout.n))
    layout.ravel(stacked, out)
    assert layout.n == want.size
    assert np.array_equal(out[0].numpy(), want)
    assert np.array_equal(out[1].numpy(), 2 * want)
    back = layout.jax_tree(out)
    for x, y in zip(jax.tree.leaves(stacked), dispatch.tree_leaves(back)):
        assert np.array_equal(x, y.numpy())
    mp = layout.model_params(out[0])
    ref = TM.params_from_jax(tc, tree, device="cpu")
    for x, y in zip(TM.transformer.tree_leaves(mp),
                    TM.transformer.tree_leaves(ref)):
        assert torch.equal(x, y)
        assert out[0].data_ptr() <= x.data_ptr() < out[0].data_ptr() + \
            4 * layout.n


def test_encdec_remat_recomputes_and_changes_nothing():
    """``cfg.remat``: the same loss and gradients, bitwise, and each
    attention run twice (every encoder and decoder layer recomputed in the
    backward: 2 encoder + 2 x 2 decoder attentions a forward)."""
    _, tc = _cfgs()
    params = TM.init_params(tc, seed=1, device="cpu")
    toks, frames = _batch(tc, seed=1)
    out, calls = [], []
    real = dispatch.swa_attention_plain
    for remat in (False, True):
        cfg = dataclasses.replace(tc, remat=remat)
        leaves = TM.transformer.tree_map(
            lambda t: t.clone().requires_grad_(), params)
        n = [0]

        def counted(*a, **k):
            n[0] += 1
            return real(*a, **k)
        dispatch.swa_attention_plain = counted
        try:
            loss = TM.lm_loss(cfg, leaves, _tbatch(toks, frames))
            loss.backward()
        finally:
            dispatch.swa_attention_plain = real
        calls.append(n[0])
        out.append([loss.detach()] + [t.grad for t in
                                      TM.transformer.tree_leaves(leaves)])
    per = tc.n_encoder_layers + 2 * tc.n_layers
    assert calls == [per, 2 * per]
    assert all(torch.equal(x, y) for x, y in zip(*out))


def _flat_rows(params_m):
    return np.stack([np.asarray(ravel_pytree(jax.tree.map(lambda x: x[a],
                                                          params_m))[0])
                     for a in range(A)])


def test_train_two_steps_matches_jax_train():
    """``train()`` on the CPU, periodic tau 2 over A 2 agents (one period
    and its sync), from JAX's initial train state, against JAX's
    ``repro.launch.train.train`` on the same batches and stub frames: the
    losses, the synced rows (bitwise equal to each other) and the step
    count."""
    fed = JF.FedTrainConfig(strategy="periodic", tau=TAU, lr=1e-3)
    jstate, jlosses = JT.train(ARCH, reduced=True, steps=TAU, fed=fed,
                               n_agents=A, batch=B, seq=S, log_every=100)
    jc = JC.get_arch(ARCH).reduced()
    init = jax.device_get(JF.init_train_state(
        jc, jax.random.key(0), A, JO.adamw(weight_decay=0.01), fed))
    tc = TC.get_arch(ARCH).reduced()
    st0 = TF.train_state_from_jax(tc, init, device="cpu")
    st, losses = TT.train(ARCH, reduced=True, steps=TAU,
                          fed=TF.FedTrainConfig(**dataclasses.asdict(fed)),
                          n_agents=A, batch=B, seq=S, log_every=100,
                          device="cpu", state=st0)
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    assert torch.equal(st.params[0], st.params[1])
    np.testing.assert_allclose(st.params.numpy(),
                               _flat_rows(jstate["params"]), rtol=0,
                               atol=PARAM_ATOL)
    assert st.step == int(np.asarray(jstate["step"])) == TAU


def test_chip_smoke_launch_formula_counts_the_plain_calls_for_the_encdec():
    """A CPU rehearsal of ``chip_smoke._train_expected`` for an
    encoder-decoder model (phase 22) with remat on: 3 local steps and a
    periodic sync of the reduced whisper at head 64, the dispatch's plain
    calls standing for the kernels' launches."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    c = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c)
    _, tc = _cfgs(remat=True)
    fed = TF.FedTrainConfig(strategy="periodic", tau=TAU)
    names = {"swa_attention": "swa_attention_plain",
             "swa_attention_bwd": "swa_attention_bwd_plain",
             "wkv6": "wkv6_plain", "wkv6_bwd": "wkv6_bwd_plain",
             "adam_update": "adam_update_plain", "row_mean": "row_mean_plain"}
    counts = {k: 0 for k in names}
    real = {k: getattr(dispatch, v) for k, v in names.items()}

    def counting(k):
        def fn(*a, **kw):
            counts[k] += 1
            return real[k](*a, **kw)
        return fn
    opt = TO.adamw(weight_decay=0.01)
    st = TF.init_train_state(tc, 0, A, opt, fed, device="cpu")
    local = TF.make_local_step(tc, opt, fed, n_agents=A)
    sync = TF.make_sync_step(tc, fed, n_agents=A)
    try:
        for k, v in names.items():
            setattr(dispatch, v, counting(k))
        for step in range(3):
            toks, frames = _batch(tc, seed=step)
            local(st, {"tokens": torch.from_numpy(np.stack([toks, toks])),
                       "frames": torch.from_numpy(np.stack([frames, frames]))})
            if (step + 1) % TAU == 0:
                sync(st)
    finally:
        for k, v in names.items():
            setattr(dispatch, v, real[k])
    assert counts == c._train_expected(tc, fed, A, 3)
    assert counts["swa_attention"] == 3 * A * 2 * 6
