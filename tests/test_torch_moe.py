"""Port parity: the Mixture-of-Experts FFN and the two MoE models on the
CPU, against the JAX package.

* ``apply_moe`` (``models/moe.py``) against JAX's at reduced width in fp32,
  both variants: GLU experts with a shared expert (``kimi-k2``) and a
  dense residual (``arctic``); the cases: ``reduced()``'s no-drop factor
  (4), ``capacity_factor`` 1.25 with a skewed router (assignments drop), a
  ``moe_group_size`` below S with B * S not a multiple of it (groups pad
  and span sequences), and a zero router (every probability ties; JAX's
  ``top_k`` puts the lower expert first). ``out`` within ``atol 1e-5``,
  ``aux`` within ``1e-6`` (summation order); the routing (experts in
  order, positions) equals ``jax.lax.top_k`` and JAX's cumsum positions on
  the same probabilities exactly;
* the models at reduced size (``kimi``: a dense head layer and an MoE
  layer; ``arctic``: two MoE layers, one scanned cycle each), seeded
  numbers in the layout of JAX's init tree (``jax.eval_shape``) carried by
  ``params_from_jax``: logits ``atol 2e-4`` (PERF.md §2) and the summed aux
  within 1e-6 through ``forward``, ``prefill``, ``decode_step`` and the
  serve steps; prefill + decode equals forward under ``reduced()``'s
  no-drop factor;
* the port's ``ServingLoop`` against single-request greedy decoding in the
  loop's own split (``prompt[:-1]`` prefilled as one group, every later
  token one decode step, routed alone), exactly, also at factor 1.25,
  where a prefill of the whole prompt differs (capacity binds per
  sequence length);
* the full-width trees' counts at 2 layers against ``jax.eval_shape`` of
  JAX's init; serving is accepted and training refused;
* ``chip_smoke.py``'s route-flip rule (phase 23's kernel vs plain
  attention) on the CPU with a stand-in kernel, and its control; its
  gaps (``moe_route_gaps``) on hand-made routings, with an expert taken
  from far down the ranking at a tied rank as a second control.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as C
from repro.launch.serve import make_prefill_step as jax_prefill_step
from repro.launch.serve import make_serve_step as jax_serve_step
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.layers import split_leaves
from repro.models.moe import apply_moe as jax_apply_moe
from repro.models.moe import init_moe as jax_init_moe
from repro_torch import configs as TC
from repro_torch import models as TM
from repro_torch.launch import (
    Request,
    ServingLoop,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.models import moe

ATOL = 2e-4
MOE_ATOL = 1e-5
AUX_ATOL = 1e-6
KIMI, ARCTIC = "kimi-k2-1t-a32b", "arctic-480b"
ARCHS = (KIMI, ARCTIC)

# The largest |port - JAX| each comparison reached; ``python <this file>``
# runs the tests and prints them.
REACHED = {}


def _close(what, got, want, atol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    REACHED[what] = max(REACHED.get(what, 0.0), float(np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0.0)


def _cfgs(arch, **kw):
    return (dataclasses.replace(C.get_arch(arch).reduced(), **kw),
            dataclasses.replace(TC.get_arch(arch).reduced(), **kw))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.int64))


def _torch_tree(tree):
    return TM.transformer.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


# --- configs and trees --------------------------------------------------------------

@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_a_copy_of_the_jax_config(arch, reduce):
    cfg, tcfg = C.get_arch(arch), TC.get_arch(arch)
    if reduce:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
        assert tcfg.capacity_factor == 4.0          # max(1.25, 4.0)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert tcfg.n_params() == cfg.n_params()
    assert arch in TC.list_archs()


# (arch, the 2-layer tree's count, cfg.n_params() at 2 layers): the tree
# holds the final norm (d = 7,168) that n_params() leaves out
COUNTS = [(KIMI, 19_967_675_392, 19_967_668_224),
          (ARCTIC, 27_681_131_520, 27_681_124_352)]


@pytest.mark.parametrize("arch,n_tree,n_cfg", COUNTS)
def test_two_layer_tree_matches_jax_shapes_and_counts(arch, n_tree, n_cfg):
    cfg = dataclasses.replace(C.get_arch(arch), n_layers=2)
    tcfg = dataclasses.replace(TC.get_arch(arch), n_layers=2)
    jtree = jax.eval_shape(lambda: jax_init_params(cfg, jax.random.key(0)))
    want = TM.param_shapes(tcfg)
    plan = TM.layer_plan(tcfg)
    # (layer, JAX subtree, leading axes to drop): the head unrolled, the
    # cycles stacked over n_cycles
    blocks = [(i, jtree["head_blocks"][i], 0) for i in range(len(plan.head))]
    blocks += [(len(plan.head) + c, jtree["cycles"][0], 1)
               for c in range(plan.n_cycles)]
    for i, jb, lead in blocks:
        for path, leaf in jax.tree_util.tree_flatten_with_path(jb)[0]:
            node = want["blocks"][i]
            for p in path:
                node = node[p.key]
            assert tuple(node.shape) == tuple(leaf.shape[lead:]), (i, path)
    assert ("moe" in want["blocks"][0]) == (arch == ARCTIC)
    assert "moe" in want["blocks"][1]
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jtree))
    assert TM.count_params(want) == n_jax == n_tree
    assert tcfg.n_params() == n_cfg


def test_moe_is_served_and_not_trained():
    for arch in ARCHS:
        tcfg = TC.get_arch(arch)
        assert make_prefill_step(tcfg) and make_serve_step(tcfg)
        with pytest.raises(NotImplementedError, match="MoE"):
            TM.transformer.check_trainable(tcfg)
        with pytest.raises(NotImplementedError, match="MoE"):
            TM.lm_loss(tcfg, {}, {"tokens": torch.zeros(1, 3,
                                                        dtype=torch.long)})
    # the VLM (slice 21) is served and trained
    TM.transformer.check_trainable(TC.ModelConfig(**dataclasses.asdict(
        C.get_arch("internvl2-26b").reduced())))


def test_init_draws_expert_slices_and_casts_them_to_the_same_numbers(
        monkeypatch):
    """Expert leaves are drawn EXPERTS_PER_DRAW experts at a time (3 here,
    so that a leaf of 4 crosses a slice) and cast slice by slice: a bf16
    tree holds the numbers of the same fp32 draw cast afterwards."""
    monkeypatch.setattr(moe, "EXPERTS_PER_DRAW", 3)
    _, tcfg = _cfgs(KIMI)
    tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16")
    got = TM.init_params(tcfg, seed=5, device="cpu")
    want = TM.transformer._build_tree(tcfg, torch.Generator().manual_seed(5))
    assert got["blocks"][1]["moe"]["w_up"].shape == (4, 128, 128)
    for a, b in zip(TM.transformer.tree_leaves(got),
                    TM.transformer.tree_leaves(want)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.bfloat16())


# --- apply_moe against JAX ----------------------------------------------------------

# case: (B, S, config fields, router scale, x offset); the offset gives
# every token a shared direction, so that the tokens prefer the same
# experts and the capacity binds
MOE_CASES = {
    "no_drop": ((2, 9), {}, 1.0, 0.0),
    "drops": ((2, 16), {"capacity_factor": 1.25}, 10.0, 1.0),
    "padded_groups": ((2, 7), {"moe_group_size": 4}, 1.0, 0.0),
    "zero_router": ((2, 6), {"capacity_factor": 1.25}, 0.0, 0.0),
}


def _draw(tree, seed):
    """Seeded numpy numbers in the layout of a JAX ``eval_shape`` tree: norm
    scales and biases 0.1 N(0, 1), every other leaf 0.02 N(0, 1) (JAX's
    init scale; drawn here, as JAX's own draw costs seconds on the CPU)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: ((0.1 if path[-1].key in ("scale", "bias") else 0.02)
                         * rng.standard_normal(a.shape)).astype(np.float32),
        tree)


@pytest.fixture(scope="module")
def moe_pairs():
    """Per arch: MoE params in the layout of JAX's ``init_moe`` (fp32) and
    the port's copy."""
    out = {}
    for arch in ARCHS:
        cfg, tcfg = _cfgs(arch)
        p = _draw(jax.eval_shape(lambda: split_leaves(
            jax_init_moe(jax.random.key(1), cfg))[0]), seed=1)
        tp = _torch_tree(p)
        want = moe.init_moe(None, tcfg)
        assert jax.tree.map(lambda a: a.shape, jax.tree.map(
            np.asarray, p)) == TM.transformer.tree_map(
                lambda t: tuple(t.shape), want)
        out[arch] = (p, tp)
    return out


def _jax_positions(top_i, e):
    """JAX's positions (``moe.py:81-85``) in numpy: the exclusive cumsum
    of the (token, slot) one-hots in token-major order, read at each
    slot's expert."""
    onehot = np.eye(e, dtype=np.int64)[top_i]
    g, s, k, _ = onehot.shape
    flat = onehot.reshape(g, s * k, e)
    pos = (np.cumsum(flat, axis=1) - flat).reshape(g, s, k, e)
    return (pos * onehot).sum(-1)


_jit_moe = jax.jit(jax_apply_moe, static_argnums=(2,))


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(moe_pairs, arch, case):
    (b, s), fields, scale, offset = MOE_CASES[case]
    cfg, tcfg = _cfgs(arch, **fields)
    jp, tp = moe_pairs[arch]
    jp = dict(jp, router=jp["router"] * scale)
    tp = dict(tp, router=tp["router"] * scale)
    x = offset + np.random.default_rng(7).standard_normal(
        (b, s, cfg.d_model), dtype=np.float32)
    want, want_aux = _jit_moe(jp, jnp.asarray(x), cfg)
    got, aux = moe.apply_moe(tp, torch.from_numpy(x), tcfg)
    _close("apply_moe out", got.numpy(), want, MOE_ATOL)
    _close("apply_moe aux", aux.numpy(), want_aux, AUX_ATOL)
    # a decode step's call skips the aux and leaves the output as it is
    bare, none = moe.apply_moe(tp, torch.from_numpy(x), tcfg, with_aux=False)
    assert none is None and torch.equal(bare, got)
    # the routing against jax.lax.top_k and JAX's positions
    xg, tokens = moe.group_tokens(torch.from_numpy(x),
                                  moe.group_size_for(tcfg, s))
    r = moe.route(tp["router"], xg, tcfg)
    _, top_i = jax.lax.top_k(jnp.asarray(r.probs.numpy()), tcfg.top_k)
    top_i = np.asarray(top_i)
    np.testing.assert_array_equal(r.experts.numpy(), top_i)
    np.testing.assert_array_equal(r.pos.numpy(),
                                  _jax_positions(top_i, tcfg.n_experts))
    dropped = int((~r.keep).sum())
    if case == "no_drop":
        assert dropped == 0
    elif case == "drops":
        assert dropped > 0 and r.capacity == 10
    elif case == "padded_groups":
        assert xg.shape[:2] == (4, 4) and tokens == 14
    else:
        assert bool((r.probs == r.probs[..., :1]).all())
        assert (r.experts.numpy() == np.arange(tcfg.top_k)).all()
        # each sequence its own group: its first C tokens keep both slots
        assert dropped == b * (s - r.capacity) * tcfg.top_k


# --- the models against JAX ---------------------------------------------------------

S, EXTRA = 10, 3


@pytest.fixture(scope="module")
def models():
    """Per arch: the reduced config, a tree in JAX's init layout, the port's
    copy by ``params_from_jax``, and JAX's (jitted) results on 2 x 13
    tokens: the forward, a prefill of 10 into a cache of 13, and 3 decode
    steps."""
    out = {}
    for arch in ARCHS:
        cfg, tcfg = _cfgs(arch)
        params = _draw(jax.eval_shape(
            lambda: jax_init_params(cfg, jax.random.key(0))), seed=0)
        toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                 (2, S + EXTRA))
        logits, _, aux = jax.jit(lambda p, t: jax_forward(
            cfg, p, t, mode="train"))(params, jnp.asarray(toks))
        lg, st = jax.jit(lambda p, t: jax_prefill(
            cfg, p, t, cache_len=S + EXTRA))(params, jnp.asarray(toks[:, :S]))
        step = jax.jit(jax_serve_step(cfg))
        steps = []
        for i in range(EXTRA):
            dl, st = step(params, jnp.asarray(toks[:, S + i:S + i + 1]), st,
                          jnp.full((2,), S + i))
            steps.append(np.asarray(dl))
        jax_out = {"tokens": toks, "forward": np.asarray(logits),
                   "aux": np.asarray(aux), "prefill": np.asarray(lg),
                   "steps": steps}
        out[arch] = (cfg, tcfg, TM.params_from_jax(tcfg, params,
                                                   device="cpu"), jax_out)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_jax(models, arch):
    """forward (logits and aux), prefill and decode_step against JAX's;
    each decode step, without drops, against the forward over the whole
    sequence too."""
    _, tcfg, tp, want = models[arch]
    plan = TM.layer_plan(tcfg)
    assert plan.head == ((0,) if arch == KIMI else ())
    assert ("mlp" in tp["blocks"][0]) == (arch == KIMI)
    toks = want["tokens"]
    full, _, aux = TM.forward(tcfg, tp, _t(toks), mode="train")
    _close("fp32 logits", full.numpy(), want["forward"], ATOL)
    _close("fp32 aux", aux.numpy(), want["aux"], AUX_ATOL)
    assert float(aux) > 0
    lg, st = TM.prefill(tcfg, tp, _t(toks[:, :S]), cache_len=S + EXTRA)
    _close("fp32 logits", lg.numpy(), want["prefill"], ATOL)
    assert st["cache"]["k"].shape == (2, 2, S + EXTRA, 4, 32)
    for i in range(EXTRA):
        lg, st = TM.decode_step(tcfg, tp, _t(toks[:, S + i:S + i + 1]), st,
                                torch.full((2,), S + i))
        _close("fp32 logits", lg.numpy(), want["steps"][i], ATOL)
        _close("fp32 decode vs forward", lg[:, 0].numpy(),
               full[:, S + i].numpy(), 3e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_jax(models, arch):
    """The port's prefill step (the last row of JAX's prefill: JAX's step
    slices it from the same logits) and serve steps against JAX's."""
    _, tcfg, tp, want = models[arch]
    toks = want["tokens"]
    lg, st = make_prefill_step(tcfg)(tp, {"tokens": _t(toks[:, :S])})
    assert lg.shape == (2, 1, TM.padded_vocab(tcfg))
    _close("fp32 serve steps", lg.numpy(), want["prefill"][:, -1:], ATOL)
    # the step's caches hold S positions; the decode steps need S + EXTRA
    state = TM.init_decode_state(tcfg, 2, max_seq=S + EXTRA, device="cpu")
    TM.forward(tcfg, tp, _t(toks[:, :S]), mode="prefill", states=state)
    serve = make_serve_step(tcfg)
    for i in range(EXTRA):
        lg, state = serve(tp, _t(toks[:, S + i:S + i + 1]), state,
                          torch.full((2,), S + i))
        _close("fp32 serve steps", lg.numpy(), want["steps"][i], ATOL)
        np.testing.assert_array_equal(lg.argmax(-1).numpy(),
                                      want["steps"][i].argmax(-1))


# --- the serving loop ---------------------------------------------------------------

def _greedy(tcfg, tp, prompt, n_new, max_seq=48):
    """Single-request greedy decoding in the loop's split: ``prompt[:-1]``
    prefilled (one group), then one decode step a token from the last
    prompt token on."""
    prompt = np.asarray(prompt)
    st = TM.init_decode_state(tcfg, 1, max_seq=max_seq, device="cpu")
    if len(prompt) > 1:
        TM.forward(tcfg, tp, _t(prompt[None, :-1]), mode="prefill", states=st)
    tok, out = _t([[prompt[-1]]]), []
    for i in range(n_new):
        lg, st = TM.decode_step(tcfg, tp, tok, st,
                                torch.tensor([len(prompt) - 1 + i]))
        tok = lg[:, -1:].argmax(-1)
        out.append(int(tok))
    return out


@pytest.mark.parametrize("factor", [4.0, 1.25])
def test_serving_loop_is_single_request_greedy(factor):
    """Arctic (every layer MoE) with weights x4, so that the context decides
    the greedy tokens: 5 requests on 2 slots (recycling, a 1-token prompt)
    equal single-request greedy decoding exactly. At factor 1.25 a prefill
    of the whole prompt gives other last logits than ``prompt[:-1]`` and a
    decode step for at least one prompt: the split is what makes them
    equal."""
    _, tcfg = _cfgs(ARCTIC, capacity_factor=factor)
    tp = TM.transformer.tree_map(lambda t: t * 4.0,
                                 TM.init_params(tcfg, seed=3, device="cpu"))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, tcfg.vocab_size, n) for n in (13, 21, 1, 9, 17)]
    got = {c.rid: c.tokens for c in ServingLoop(
        tcfg, tp, n_slots=2, max_seq=48).run(
            [Request(i, p, 5) for i, p in enumerate(prompts)])}
    assert [got[i] for i in range(len(prompts))] == \
        [_greedy(tcfg, tp, p, 5) for p in prompts]
    moved = 0.0
    for p in prompts[:2]:
        whole, _ = TM.prefill(tcfg, tp, _t(p[None]))
        st = TM.init_decode_state(tcfg, 1, max_seq=48, device="cpu")
        TM.forward(tcfg, tp, _t(p[None, :-1]), mode="prefill", states=st)
        step, _ = TM.decode_step(tcfg, tp, _t([[p[-1]]]), st,
                                 torch.tensor([len(p) - 1]))
        moved = max(moved, float((whole[0, -1] - step[0, 0]).abs().max()))
    if factor == 4.0:
        assert moved < 3e-4
    else:
        assert moved > 1e-2


# --- chip_smoke.py's route-flip rule, rehearsed ------------------------------------

@functools.cache
def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    c = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c)
    return c


@pytest.mark.parametrize("nudge,passes", [(2.0 ** -8, True),
                                          (2.0 ** -3, False)])
def test_chip_smoke_route_flip_rule(monkeypatch, nudge, passes):
    """A CPU rehearsal of ``chip_smoke.moe_kernel_vs_plain`` on a reduced
    bf16 kimi (16 experts, top 4, factor 1.25; weights x3): a stand-in for
    the kernel that moves 5% of the attention's outputs by ``nudge``
    (relative). One bf16 ulp's worth flips routes only at counted near-ties
    and keeps the held rows' logits within the rule; a move of 2^-3 breaks
    the rule (the control)."""
    import types
    from repro_torch.kernels import swa_attention as swm
    c = _chip_smoke()
    # the phase-12 attention rule is the card's; here only the routes
    monkeypatch.setattr(c, "swa_check", lambda *a, **kw: {
        "err": 0.0, "mean_err": 1.0, "plain_mean_err": 1.0,
        "one_bf16_p_mean_err": 2.0, "window": None})

    def moved(q, k, v, *, window, causal):
        o = swm.swa_attention_plain(q, k, v, window=window, causal=causal)
        hit = torch.rand(o.shape, generator=torch.Generator().manual_seed(
            1)) < 0.05
        return torch.where(hit, (o.float() * (1 + nudge)).to(o.dtype), o)

    sw = types.SimpleNamespace(swa_attention_cuda=moved,
                               swa_attention_plain=swm.swa_attention_plain)
    _, tcfg = _cfgs(KIMI, param_dtype="bfloat16", compute_dtype="bfloat16",
                    capacity_factor=1.25, n_experts=16, top_k=4)
    tp = TM.transformer.tree_map(lambda t: t * 3.0, TM.init_params(
        tcfg, seed=0, device="cpu"))
    toks = _t(np.random.default_rng(0).integers(0, tcfg.vocab_size, (4, 64)))
    if not passes:
        with pytest.raises(AssertionError, match="route flip|logits"):
            c.moe_kernel_vs_plain(sw, moe, TM, tcfg, tp, toks)
        return
    out = c.moe_kernel_vs_plain(sw, moe, TM, tcfg, tp, toks)
    (layer,) = out["moe_layers"]
    assert layer["flips_held"] > 0
    assert layer["flip_gap_ulps_max"] <= c.MOE_FLIP_ULPS
    assert 0 < out["rows_held"] < out["rows"]
    assert out["logit_err_ulps_max"] <= c.MOE_LOGIT_ULPS


# plain router logits of one token (16 experts, top 4): ranks 2-4 tie at 6
# and expert 15 lies far down; the kernel run's experts: (ordered top 4,
# within the rule)
GAP_LOGITS = [8.0, 7.0, 6.0, 6.0, 6.0] + [5.0 - i for i in range(11)]
GAP_CASES = {
    "same": ([0, 1, 2, 3], True),
    "tie_swapped_in": ([0, 1, 2, 4], True),     # expert 4 ties with 3
    "tie_reordered": ([0, 1, 3, 2], True),
    "near_tie_reordered": ([1, 0, 2, 3], False),  # 8 vs 7: 16 ulp of 8
    "far_at_tied_rank": ([0, 1, 2, 15], False),   # ranks 3 and 4 tie
    "far_in_front": ([15, 0, 1, 2], False),
    "top_dropped": ([1, 2, 3, 4], False),         # 8 left out for a 6
}


@pytest.mark.parametrize("case", list(GAP_CASES))
def test_chip_smoke_route_gaps(case):
    """``chip_smoke.moe_route_gaps`` on hand-made routings: a kernel-run
    top k that differs from the plain run's only among exactly tied plain
    logits is within the rule; one that takes an expert from far down the
    plain ranking is not, also where the plain run's ranks 3 and 4 tie
    (the control), and so is one that leaves the plain run's top expert
    out."""
    c = _chip_smoke()
    cfg = dataclasses.replace(TC.get_arch(KIMI).reduced(), n_experts=16,
                              top_k=4, capacity_factor=4.0)
    logits = torch.tensor([[GAP_LOGITS]])
    rp = moe.route(torch.eye(16), logits, cfg)
    assert rp.experts.tolist() == [[[0, 1, 2, 3]]]
    experts, within = GAP_CASES[case]
    rk = rp._replace(experts=torch.tensor([[experts]]))
    gap = float(c.moe_route_gaps(rk, rp)[0, 0])
    assert (gap <= c.MOE_FLIP_ULPS) == within, gap
    if within:
        assert gap == 0.0


if __name__ == "__main__":
    import sys

    rc = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    mod = next(m for m in list(sys.modules.values())
               if getattr(m, "__file__", None) == __file__
               and m.__name__ != "__main__")
    for what, err in sorted(mod.REACHED.items()):
        print(f"{what}: {err:.3g}")
    sys.exit(rc)
