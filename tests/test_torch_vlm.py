"""Port parity: the VLM embedding prefix (``internvl2-26b``) and
``qwen2-72b`` on the CPU, against the JAX package.

Reduced configurations in fp32 (``reduced()``: 2 ``attn`` layers, d 128,
heads of 32, vocab 512; ``internvl2-26b`` with 4 query heads on 2 KV heads
and 8 frontend tokens, ``qwen2-72b`` with its QKV bias), initialised by the
JAX package and carried with ``params_from_jax``; the patch embeddings are
seeded random numbers (the stub frontend: no ViT, no image). Checked:

* the full-width trees: the port's count equals the JAX tree's (48 and 2
  layers of ``internvl2-26b``, 80 and 4 of ``qwen2-72b``), and
  ``ModelConfig.n_params()`` falls short of it by what it leaves out (the
  projector, the padded vocabulary's rows, the final norm);
* ``forward`` with a prefix (``embeds``, through the projector), logits
  ``atol 2e-4`` (PERF.md §2), at F + S rows;
* ``prefill`` with a prefix (caches of F + S slots) and decode steps from
  position F + S against JAX's serve steps, and the port's serve steps
  (``batch["patch_embeds"]``) against JAX's, ``atol 2e-4``;
* ``lm_loss`` with ``patch_embeds`` and every gradient (the projector's
  included) in both cross-entropy branches against ``jax.value_and_grad``:
  the loss ``rtol 1e-5``, each gradient within ``1e-5`` of its leaf's
  largest |value|;
* ``train()`` on the vision stub batch (tokens cut to ``seq - F + 1``,
  ``0.1`` patch embeddings) against JAX's ``train()`` from the same state:
  losses ``rtol 1e-5``, parameters ``atol 5e-5`` after two Adam steps and a
  sync (test_torch_lm_train.py's rules);
* ``qwen2-72b``: forward, prefill + decode and the loss with every
  gradient, the QKV biases' among them.

Each JAX function compiles once, in a module fixture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import repro.configs as JC
from repro.launch import fedtrain as JF
from repro.launch import train as JT
from repro.launch.serve import make_prefill_step as jax_prefill_step
from repro.launch.serve import make_serve_step as jax_serve_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import lm_loss as jax_lm_loss
from repro_torch import configs as TC
from repro_torch import models as TM
from repro_torch.launch import fedtrain as TF
from repro_torch.launch import make_prefill_step, make_serve_step
from repro_torch.launch import train as TT
from repro_torch.launch.serving_loop import Request, ServingLoop

VLM, QWEN = "internvl2-26b", "qwen2-72b"
ARCHS = (VLM, QWEN)
B, S, STEPS = 2, 13, 3
ATOL = 2e-4                     # logits (PERF.md §2)
RTOL, LOSS_ATOL = 1e-5, 1e-6
LEAF_REL = 1e-5
PARAM_ATOL = 5e-5
REDUCED = {VLM: dict(n_kv_heads=2), QWEN: {}}
# the JAX init trees' counts (jax.eval_shape of init_params) at full width,
# full depth and at the depths chip_smoke.py runs on the card
TREE_COUNTS = {(VLM, 48): 19_900_471_296, (VLM, 2): 1_956_673_536,
               (QWEN, 80): 72_706_203_648, (QWEN, 4): 6_002_163_712}


def cfgs(arch):
    return (dataclasses.replace(JC.get_arch(arch).reduced(), **REDUCED[arch]),
            dataclasses.replace(TC.get_arch(arch).reduced(), **REDUCED[arch]))


def tokens(cfg, seed=0, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s))


def patch_embeds(cfg, seed=1):
    """The stub frontend's output: seeded N(0, 1) numbers, (B, F, d)."""
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)


def batch_of(cfg, toks, seed=1):
    """A serve / loss batch: the tokens, and a VLM's patch embeddings."""
    out = {"tokens": toks}
    if cfg.frontend == "vision":
        out["patch_embeds"] = patch_embeds(cfg, seed)
    return out


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_side():
    """Per model: JAX's init tree; its forward on a prefixed batch; its
    serve steps (prefill, then STEPS decode steps on its own greedy
    tokens); its loss and gradient in both CE branches, one program."""
    out = {}
    for arch in ARCHS:
        jc, _ = cfgs(arch)
        tree = jax.device_get(jax.jit(lambda k, jc=jc: jax_init_params(
            jc, k))(jax.random.key(0)))
        batch = batch_of(jc, tokens(jc))
        fwd = jax.jit(lambda p, t, e, jc=jc: jax_forward(
            jc, p, t, embeds=e)[0])
        logits = np.asarray(fwd(tree, jnp.asarray(batch["tokens"]),
                                None if "patch_embeds" not in batch
                                else jnp.asarray(batch["patch_embeds"])))
        pre = jax.jit(jax_prefill_step(jc))
        step = jax.jit(jax_serve_step(jc))
        lg, st = pre(tree, _j(batch))
        total = logits.shape[1]
        served, fed = [np.asarray(lg)], []
        for i in range(STEPS):
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            fed.append(np.asarray(tok))
            lg, st = step(tree, tok, st, jnp.full((B,), total + i, jnp.int32))
            served.append(np.asarray(lg))
        vg = jax.jit(lambda p, b, jc=jc: [jax.value_and_grad(
            lambda q: jax_lm_loss(jc, q, b, ce_chunks=c))(p) for c in (0, 2)])
        out[arch] = {"tree": tree, "batch": batch, "logits": logits,
                     "served": served, "fed": fed,
                     "loss_grad": jax.device_get(vg(tree, _j(batch)))}
    return out


def _params(arch, jax_side):
    _, tc = cfgs(arch)
    return tc, TM.params_from_jax(tc, jax_side[arch]["tree"], device="cpu")


# --- the trees ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch,layers", sorted(TREE_COUNTS))
def test_full_width_tree_counts_match_jax(arch, layers):
    jc = dataclasses.replace(JC.get_arch(arch), n_layers=layers)
    tc = dataclasses.replace(TC.get_arch(arch), n_layers=layers)
    shapes = jax.eval_shape(lambda: jax_init_params(jc, jax.random.key(0)))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    want = TM.param_shapes(tc)
    assert TM.count_params(want) == n_jax == TREE_COUNTS[(arch, layers)]
    assert ("projector" in want) == (arch == VLM) == ("projector" in shapes)
    # ModelConfig.n_params() (JAX's, copied) leaves out the projector, the
    # padded vocabulary's rows and the final norm
    d, vp = tc.d_model, TM.padded_vocab(tc)
    missing = 2 * (vp - tc.vocab_size) * d + d + (d * d if arch == VLM else 0)
    assert tc.n_params() == jc.n_params() == n_jax - missing
    if (arch, layers) == (VLM, 48):
        assert (d * d, 2 * (vp - tc.vocab_size) * d) == (37_748_736, 1_462_272)
        assert tc.n_params() == 19_861_254_144
    if (arch, layers) == (QWEN, 80):
        assert missing == 8_192


def test_projector_is_carried_and_drawn_before_the_blocks(jax_side):
    tc, params = _params(VLM, jax_side)
    want = jax_side[VLM]["tree"]["projector"]["w"]
    assert torch.equal(params["projector"]["w"], torch.from_numpy(
        np.array(want)))
    # the port's draw: the projector after the top-level entries, before
    # the blocks; without it the embedding is the same draw and the blocks
    # are not
    mine = TM.init_params(tc, seed=3, device="cpu")
    assert tuple(mine["projector"]["w"].shape) == (tc.d_model, tc.d_model)
    assert 0.015 < float(mine["projector"]["w"].std()) < 0.025
    text = TM.init_params(dataclasses.replace(tc, frontend=None), seed=3,
                          device="cpu")
    assert "projector" not in text
    assert torch.equal(mine["embed"]["table"], text["embed"]["table"])
    assert not torch.equal(mine["blocks"][0]["attn"]["wq"],
                           text["blocks"][0]["attn"]["wq"])
    assert TF.ParamLayout(tc).n == ravel_pytree(jax_side[VLM]["tree"])[0].size


# --- serving ------------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_prefix_matches_jax(jax_side, arch):
    tc, params = _params(arch, jax_side)
    batch = _t(jax_side[arch]["batch"])
    logits, _, aux = TM.forward(tc, params, batch["tokens"],
                                embeds=batch.get("patch_embeds"))
    want = jax_side[arch]["logits"]
    F = tc.n_frontend_tokens if arch == VLM else 0
    assert logits.shape == want.shape == (B, F + S, TM.padded_vocab(tc))
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=ATOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_serve_steps(jax_side, arch):
    tc, params = _params(arch, jax_side)
    batch = _t(jax_side[arch]["batch"])
    total = jax_side[arch]["logits"].shape[1]
    logits, st = TM.prefill(tc, params, batch["tokens"],
                            embeds=batch.get("patch_embeds"))
    assert tuple(st["cache"]["k"].shape[:3]) == (tc.n_layers, B, total)
    assert bool((st["cache"]["pos"] == torch.arange(total)).all())
    np.testing.assert_allclose(logits.numpy(), jax_side[arch]["logits"],
                               rtol=0, atol=ATOL)
    served = jax_side[arch]["served"]
    np.testing.assert_allclose(logits[:, -1:].numpy(), served[0], rtol=0,
                               atol=ATOL)
    for i, tok in enumerate(jax_side[arch]["fed"]):
        lg, st = TM.decode_step(tc, params, torch.from_numpy(np.array(tok)).long(), st,
                                torch.full((B,), total + i))
        np.testing.assert_allclose(lg.numpy(), served[i + 1], rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_serve_steps_match_jax_serve_steps(jax_side, arch):
    tc, params = _params(arch, jax_side)
    batch = _t(jax_side[arch]["batch"])
    total = jax_side[arch]["logits"].shape[1]
    lg, st = make_prefill_step(tc)(params, batch)
    served = jax_side[arch]["served"]
    np.testing.assert_allclose(lg.numpy(), served[0], rtol=0, atol=ATOL)
    assert st["cache"]["k"].shape[2] == total
    step = make_serve_step(tc)
    for i, tok in enumerate(jax_side[arch]["fed"]):
        lg, st = step(params, torch.from_numpy(np.array(tok)).long(), st,
                      torch.full((B,), total + i))
        np.testing.assert_allclose(lg.numpy(), served[i + 1], rtol=0,
                                   atol=ATOL)


def test_prefix_changes_what_follows_and_cache_len_sizes_the_caches(
        jax_side):
    tc, params = _params(VLM, jax_side)
    batch = _t(jax_side[VLM]["batch"])
    toks, emb = batch["tokens"], batch["patch_embeds"]
    F = tc.n_frontend_tokens
    plain, _, _ = TM.forward(tc, params, toks)
    with_prefix, _, _ = TM.forward(tc, params, toks, embeds=emb)
    other, _, _ = TM.forward(tc, params, toks, embeds=emb.flip(1))
    assert not torch.allclose(with_prefix[:, F:], plain, atol=1e-3)
    assert not torch.allclose(other[:, F:], with_prefix[:, F:], atol=1e-3)
    logits, st = TM.prefill(tc, params, toks, embeds=emb, cache_len=F + S + 5)
    assert st["cache"]["k"].shape[2] == F + S + 5
    torch.testing.assert_close(logits, with_prefix, rtol=0, atol=1e-5)


def test_vlm_serving_loop_serves_text_as_single_request_greedy(jax_side):
    """The loop takes no prefix (nor does JAX's): with a VLM config it
    serves text prompts, each completion single-request greedy."""
    tc, params = _params(VLM, jax_side)
    toks = tokens(tc, seed=7, s=9)
    reqs = [Request(0, toks[0], 4), Request(1, toks[1, :5], 6)]
    done = ServingLoop(tc, params, n_slots=2, max_seq=32).run(reqs)
    for c in done:
        prompt = torch.from_numpy(reqs[c.rid].prompt[None])
        lg, st = TM.prefill(tc, params, prompt, cache_len=32)
        want, pos = [int(lg[0, -1].argmax())], prompt.shape[1]
        for _ in range(len(c.tokens) - 1):
            lg, st = TM.decode_step(tc, params, torch.tensor([[want[-1]]]),
                                    st, torch.tensor([pos]))
            want.append(int(lg[0, 0].argmax()))
            pos += 1
        assert c.tokens == want


# --- training -----------------------------------------------------------------------------

def _loss_and_grads(tc, params, batch, **kw):
    leaves = TM.transformer.tree_map(lambda t: t.clone().requires_grad_(),
                                     params)
    loss = TM.lm_loss(tc, leaves, batch, **kw)
    loss.backward()
    return loss.detach(), leaves


@pytest.mark.parametrize("branch", [0, 1], ids=["logits", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_every_gradient_match_jax(jax_side, arch, branch):
    tc, params = _params(arch, jax_side)
    loss, leaves = _loss_and_grads(tc, params, _t(jax_side[arch]["batch"]),
                                   ce_chunks=(0, 2)[branch])
    want_loss, want_grad = jax_side[arch]["loss_grad"][branch]
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL,
                               atol=LOSS_ATOL)
    want = TM.params_from_jax(tc, want_grad, device="cpu")
    named = {"projector": (VLM, lambda t: t["projector"]["w"]),
             "bq": (QWEN, lambda t: t["blocks"][0]["attn"]["bq"])}
    for name, (owner, pick) in named.items():
        if owner == arch:                  # the leaf this model adds
            assert float(pick(want).abs().max()) > 0, name
    grads = [t.grad for t in TM.transformer.tree_leaves(leaves)]
    want = TM.transformer.tree_leaves(want)
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((got - w).abs().max()) <= LEAF_REL * scale


def test_lm_loss_drops_the_prefix_rows(jax_side):
    """The loss reads only the token rows: the hidden rows of the prefix
    predict nothing, so a loss on the prefixed batch equals the mean CE of
    the forward's token rows (F on) against the next tokens."""
    tc, params = _params(VLM, jax_side)
    batch = _t(jax_side[VLM]["batch"])
    toks, F = batch["tokens"], tc.n_frontend_tokens
    logits, _, _ = TM.forward(tc, params, toks[:, :-1],
                              embeds=batch["patch_embeds"])
    want = torch.nn.functional.cross_entropy(
        logits[:, F:].reshape(-1, logits.shape[-1]), toks[:, 1:].reshape(-1))
    torch.testing.assert_close(TM.lm_loss(tc, params, batch, ce_chunks=0),
                               want, rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError, match="frames"):
        TM.lm_loss(tc, params, {"tokens": toks, "frames": batch[
            "patch_embeds"]})


def test_stub_batch_is_jax_trains_batch():
    """``stub_batch`` builds what JAX's ``train()`` hands its local step:
    a vision model's tokens cut to ``seq - F + 1`` and 0.1 patch
    embeddings (A, B, F, d); whisper's frames beside the whole tokens; a
    text model's tokens alone."""
    toks = torch.arange(2 * 3 * 25).reshape(2, 3, 25)
    vlm = TC.get_arch(VLM).reduced()
    got = TT.stub_batch(vlm, toks)
    F = vlm.n_frontend_tokens
    assert torch.equal(got["tokens"], toks[:, :, :25 - F])
    assert got["tokens"].shape[-1] == 24 - F + 1
    assert got["patch_embeds"].shape == (2, 3, F, vlm.d_model)
    assert bool((got["patch_embeds"] == 0.1).all())
    wh = TC.get_arch("whisper-small").reduced()
    got = TT.stub_batch(wh, toks)
    assert torch.equal(got["tokens"], toks) and set(got) == {"tokens",
                                                            "frames"}
    assert TT.stub_batch(TC.get_arch(QWEN).reduced(), toks).keys() == \
        {"tokens"}


def test_train_on_the_vision_stub_batch_matches_jax_train():
    A, TAU, SEQ = 2, 2, 24
    jc = JC.get_arch(VLM).reduced()
    fed = JF.FedTrainConfig(strategy="periodic", tau=TAU, lr=1e-3)
    jstate, jlosses = JT.train(VLM, reduced=True, steps=TAU, fed=fed,
                               n_agents=A, batch=B, seq=SEQ, log_every=100)
    from repro.optim import adamw as jax_adamw
    init = jax.device_get(JF.init_train_state(
        jc, jax.random.key(0), A, jax_adamw(weight_decay=0.01), fed))
    tc = TC.get_arch(VLM).reduced()
    st0 = TF.train_state_from_jax(tc, init, device="cpu")
    st, losses = TT.train(VLM, reduced=True, steps=TAU,
                          fed=TF.FedTrainConfig(**dataclasses.asdict(fed)),
                          n_agents=A, batch=B, seq=SEQ, log_every=100,
                          device="cpu", state=st0)
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=LOSS_ATOL)
    want = np.stack([np.asarray(ravel_pytree(jax.tree.map(
        lambda x: x[a], jstate["params"]))[0]) for a in range(A)])
    np.testing.assert_allclose(st.params.numpy(), want, rtol=0,
                               atol=PARAM_ATOL)
    assert torch.equal(st.params[0], st.params[1])      # after the sync
