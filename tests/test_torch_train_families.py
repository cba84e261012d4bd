"""Port parity: LM training of every served family on the CPU, against the
JAX package (slice 16: ``gemma-7b`` and ``recurrentgemma-9b`` at head 256,
``rwkv6-1.6b``).

Reduced configurations, fp32, initialised by the JAX package and carried
with ``params_from_jax``: ``gemma-7b`` (2 ``attn`` layers, d 128, 2 heads of
256), ``recurrentgemma-9b`` (5 layers of ``(rglru, rglru, local)``: a cycle,
then a tail of two; d 128, 4 query heads on 1 KV head of 256, window 8,
lru 128) and ``rwkv6-1.6b`` (``reduced()``: 2 ``wkv`` layers, d 128),
vocab 512, B 2, S 17. Checked:

* ``lm_loss`` and every parameter's gradient in both cross-entropy
  branches against ``jax.value_and_grad`` of JAX's ``lm_loss``: the loss
  ``rtol 1e-5``, each gradient within ``1e-5`` of its leaf's largest
  |value| (test_torch_lm_train.py's rule; fp32, summation order). The JAX
  programs compile once, in a module fixture;
* the recurrent models trained with ``remat`` forced on (the reduced
  configurations clear it) give the loss and gradients of ``remat`` off,
  bitwise: a layer recomputed in the backward starts from the same initial
  state, which the forward no longer overwrites;
* the flat layout of the mixed pattern is ``ravel_pytree``'s order of
  JAX's tree (the cycle's leaves stacked), and a training forward returns
  its final recurrent states as new tensors;
* the recurrent models serve (``ServingLoop``, the prefill and decode
  steps) with parameters that require grad, as with ones that do not,
  and their states keep no autograd history;
* ``check_trainable`` passes for the three models, the encoder-decoder
  (slice 19) and the VLM (slice 21), and still refuses MoE ones.

The federated steps of the recurrent models: ``test_torch_train_steps.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import repro.configs as JC
import repro.data as JD
from repro.models import init_params as jax_init_params
from repro.models import lm_loss as jax_lm_loss
from repro_torch import configs as TC
from repro_torch import models as TM
from repro_torch.launch import fedtrain as TF
from repro_torch.launch import make_prefill_step, make_serve_step
from repro_torch.launch.serving_loop import Request, ServingLoop

B, S = 2, 17
RTOL, ATOL = 1e-5, 1e-6
LEAF_REL = 1e-5
GEMMA, RG, RWKV = "gemma-7b", "recurrentgemma-9b", "rwkv6-1.6b"
ARCHS = (GEMMA, RG, RWKV)
REDUCED = {
    GEMMA: dict(n_layers=2, n_heads=2, n_kv_heads=2, head_dim=256),
    RG: dict(n_layers=5, n_heads=4, n_kv_heads=1, head_dim=256,
             sliding_window=8),
    RWKV: {},
}
F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)


def cfgs(arch, **kw):
    kw = {**REDUCED[arch], **F32, **kw}
    return (dataclasses.replace(JC.get_arch(arch).reduced(), **kw),
            dataclasses.replace(TC.get_arch(arch).reduced(), **kw))


def tokens(seed=0, agents=None):
    data = JD.SyntheticLM(vocab_size=512, seed=seed)
    if agents is None:
        return data.batch(0, B, S + 1)
    return np.stack([data.batch(0, B, S + 1, agent=a) for a in range(agents)])


@pytest.fixture(scope="module")
def jax_losses():
    """Per model: JAX's init tree and its loss and gradient in both CE
    branches, each model's two branches compiled as one program."""
    out = {}
    toks = jnp.asarray(tokens())
    for arch in ARCHS:
        jc, _ = cfgs(arch)
        tree = jax.device_get(jax_init_params(jc, jax.random.key(0)))
        vg = jax.jit(lambda p, t, jc=jc: [jax.value_and_grad(
            lambda q: jax_lm_loss(jc, q, {"tokens": t}, ce_chunks=c))(p)
            for c in (0, 2)])
        out[arch] = {"tree": tree, "loss_grad": jax.device_get(vg(tree, toks))}
    return out


def _loss_and_grads(tcfg, params, **kw):
    leaves = TM.transformer.tree_map(lambda t: t.clone().requires_grad_(),
                                     params)
    loss = TM.lm_loss(tcfg, leaves, {"tokens": torch.from_numpy(tokens())},
                      **kw)
    loss.backward()
    return loss.detach(), [t.grad for t in TM.transformer.tree_leaves(leaves)]


@pytest.mark.parametrize("branch", [0, 1], ids=["logits", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_every_gradient_match_jax(jax_losses, arch, branch):
    _, tc = cfgs(arch)
    params = TM.params_from_jax(tc, jax_losses[arch]["tree"], device="cpu")
    loss, grads = _loss_and_grads(tc, params, ce_chunks=(0, 2)[branch])
    want_loss, want_grad = jax_losses[arch]["loss_grad"][branch]
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL,
                               atol=ATOL)
    want = TM.transformer.tree_leaves(
        TM.params_from_jax(tc, want_grad, device="cpu"))
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((got - w).abs().max()) <= LEAF_REL * scale


@pytest.mark.parametrize("arch", [RG, RWKV])
def test_recurrent_models_train_bitwise_with_remat_on_and_off(arch):
    _, tc = cfgs(arch)
    params = TM.init_params(tc, seed=3, device="cpu")
    runs = [_loss_and_grads(dataclasses.replace(tc, remat=remat), params)
            for remat in (False, True)]
    assert TM.transformer.remat_layers(tc)      # some layer is recomputed
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(x, y) for x, y in zip(g0, g1))


def test_mixed_layout_is_ravel_pytree_order_and_train_states_are_new(
        jax_losses):
    jc, tc = cfgs(RG)
    tree = jax_losses[RG]["tree"]
    layout = TF.ParamLayout(tc)
    assert layout.n == ravel_pytree(tree)[0].size
    row = torch.empty((1, layout.n))
    layout.ravel(jax.tree.map(lambda x: np.asarray(x)[None], tree), row)
    assert np.array_equal(row[0].numpy(), np.asarray(ravel_pytree(tree)[0]))
    got = TM.transformer.tree_leaves(layout.model_params(row[0]))
    want = TM.transformer.tree_leaves(TM.params_from_jax(tc, tree,
                                                         device="cpu"))
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    # a training forward reads its initial states and hands back new ones
    st = TM.init_decode_state(tc, B, mode="train", device="cpu")
    _, new, _ = TM.forward(tc, TM.params_from_jax(tc, tree, device="cpu"),
                           torch.from_numpy(tokens()[:, :S]), mode="train",
                           states=st)
    assert not bool(st["rglru"]["rec"]["h"].any())
    assert new["rglru"]["rec"]["h"].shape == st["rglru"]["rec"]["h"].shape
    assert bool(new["rglru"]["rec"]["h"].any())


def test_check_trainable_passes_for_every_served_family():
    for arch in ARCHS:
        TM.transformer.check_trainable(TC.get_arch(arch))
    fields = lambda a: dataclasses.asdict(JC.get_arch(a).reduced())
    TM.transformer.check_trainable(TC.ModelConfig(**fields("whisper-small")))
    # the VLM prefix trains since slice 21; MoE training is a later slice
    TM.transformer.check_trainable(TC.ModelConfig(**fields("internvl2-26b")))
    with pytest.raises(NotImplementedError, match="MoE"):
        TM.transformer.check_trainable(TC.ModelConfig(
            **fields("kimi-k2-1t-a32b")))


@pytest.mark.parametrize("arch", [RG, RWKV])
def test_recurrent_models_serve_with_params_that_require_grad(arch):
    _, tc = cfgs(arch)
    params = TM.init_params(tc, seed=5, device="cpu")
    leaves = TM.transformer.tree_map(lambda t: t.detach().requires_grad_(),
                                     params)
    toks = tokens(seed=1)
    reqs = lambda: [Request(0, toks[0, :9], 4), Request(1, toks[1, :5], 6),
                    Request(2, toks[0, 3:7], 3)]
    runs = []
    for p in (params, leaves):
        loop = ServingLoop(tc, p, n_slots=2, max_seq=24)
        runs.append({c.rid: c.tokens for c in loop.run(reqs())})
        assert not any(t.requires_grad
                       for t in TM.transformer.tree_leaves(loop.state))
    assert runs[0] == runs[1] and len(runs[0]) == 3
    steps = []
    for p in (params, leaves):
        logits, st = make_prefill_step(tc)(
            p, {"tokens": torch.from_numpy(toks[:, :S])})
        nxt, st = make_serve_step(tc)(p, logits.argmax(-1), st,
                                      torch.full((B,), S))
        steps.append((logits, nxt, TM.transformer.tree_leaves(st)))
        assert not any(t.requires_grad for t in (logits, nxt, *steps[-1][2]))
    # torch.matmul folds (B, 1, d) @ (d, V) into one mm only for operands
    # that do not require grad, so the logits may differ in the last bit
    for x, y in zip((steps[0][0], steps[0][1], *steps[0][2]),
                    (steps[1][0], steps[1][1], *steps[1][2])):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL, atol=ATOL)
