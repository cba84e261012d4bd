"""Port parity: federated LM training on the CPU, against the JAX package.

The reduced ``h2o-danube-3-4b`` (2 ``local`` layers, d 128, 4 query heads
on 2 KV heads of 32, window 16, vocab 512, fp32) is initialised by the JAX
package and carried into the port (``params_from_jax``,
``train_state_from_jax``). Checked: the data pipeline's batches (bitwise),
the schedules and tree optimizers, ``lm_loss`` and its gradient in both
cross-entropy branches, the flat layout (``ravel_pytree``'s order), the
local and sync steps of every strategy setting over 4 steps at tau 2,
``train()`` against JAX's ``train()``, checkpoints restored by the JAX
package, the flat Adam update against the tree ``adamw`` and the launch
formula of ``chip_smoke.py``'s phase 18 (by counting plain calls).

The JAX programs are compiled once, in a module fixture. Tolerances:

* losses and gradient norms: ``rtol 1e-5, atol 1e-6`` (fp32, summation
  order);
* gradients: within ``1e-5`` of the largest |gradient| of each leaf;
* parameters after 4 Adam steps at lr 1e-3: ``atol 5e-5``. Adam divides
  each moment by the root of the second, so a gradient component near zero,
  where the two sides' summation orders differ most in relative terms,
  moves its parameter by up to a few percent of one step differently;
* schedules and tree optimizers: ``rtol 1e-6`` (XLA's and torch's pow /
  cos / sqrt may differ by an ulp);
* the flat Adam update against the port's tree ``adamw``: bitwise (the
  same operations in the same order).
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import repro.configs as JC
import repro.data as JD
import repro.optim as JO
from repro.checkpoint import restore as jax_restore
from repro.launch import fedtrain as JF
from repro.launch import train as JT
from repro.models import init_params as jax_init_params
from repro.models import lm_loss as jax_lm_loss
from repro_torch import configs as TC
from repro_torch import data as TD
from repro_torch import models as TM
from repro_torch import optim as TO
from repro_torch.checkpoint import save as torch_save
from repro_torch.kernels import dispatch
from repro_torch.launch import fedtrain as TF
from repro_torch.launch import train as TT
from repro_torch.utils.pytree import tree_map

ROOT = Path(__file__).resolve().parents[1]
tmap = tree_map
A, B, S, TAU, STEPS, LR = 2, 2, 24, 2, 4, 1e-3
RTOL, ATOL = 1e-5, 1e-6
PARAM_ATOL = 5e-5
STRATEGIES = {
    "sync": dict(strategy="sync"),
    "periodic": dict(strategy="periodic"),
    "decay": dict(strategy="decay", decay_lambda=0.9),
    "consensus": dict(strategy="consensus", consensus_eps=0.4),
    "periodic+outer": dict(strategy="periodic", outer_momentum=0.9),
}


def _cfgs():
    kw = dict(n_kv_heads=2)
    return (dataclasses.replace(JC.get_arch("h2o-danube-3-4b").reduced(), **kw),
            dataclasses.replace(TC.get_arch("h2o-danube-3-4b").reduced(), **kw))


def _tokens(step):
    data = JD.SyntheticLM(vocab_size=512, seed=0)
    return np.stack([data.batch(step, B, S + 1, agent=a) for a in range(A)])


def _flat_rows(params_m):
    return np.stack([np.asarray(ravel_pytree(jax.tree.map(lambda x: x[a],
                                                          params_m))[0])
                     for a in range(A)])


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's side, compiled once: the loss and gradient in both CE branches,
    and 4 steps of every strategy setting (one compiled local step for the
    settings that share it, one for decay; the steps see the state without
    the outer-momentum keys, so they are not traced again)."""
    jc, _ = _cfgs()
    tree = jax.device_get(jax_init_params(jc, jax.random.key(0)))
    toks = _tokens(0)[0]
    vg = jax.jit(lambda p, t: [jax.value_and_grad(
        lambda q: jax_lm_loss(jc, q, {"tokens": t}, ce_chunks=c))(p)
        for c in (0, 2)])
    losses = jax.device_get(vg(tree, jnp.asarray(toks)))
    opt = JO.adamw(weight_decay=0.01)
    feds = {k: JF.FedTrainConfig(tau=TAU, lr=LR, **kw)
            for k, kw in STRATEGIES.items()}
    local = {"shared": jax.jit(JF.make_local_step(jc, opt, feds["periodic"],
                                                  n_agents=A)),
             "decay": jax.jit(JF.make_local_step(jc, opt, feds["decay"],
                                                 n_agents=A))}
    runs = {}
    for name, fed in feds.items():
        ls = local["decay" if name == "decay" else "shared"]
        ss = jax.jit(JF.make_sync_step(jc, fed, n_agents=A))
        st = JF.init_train_state(jc, jax.random.key(0), A, opt, fed)
        init = jax.device_get(st)
        metrics = []
        for step in range(STEPS):
            core = {k: st[k] for k in ("params", "opt", "step")}
            core, m = ls(core, {"tokens": jnp.asarray(_tokens(step))})
            st = dict(st, **core)
            if (step + 1) % TAU == 0:
                st = ss(st)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[name] = {"init": init, "metrics": metrics,
                      "params": _flat_rows(st["params"]),
                      "state": jax.device_get(st)}
    return {"tree": tree, "tokens": toks, "loss_grad": losses, "runs": runs,
            "feds": feds}


# --- data pipeline, schedules, tree optimizers ---------------------------------

@pytest.mark.parametrize("seed,agent,step", [(0, 0, 0), (3, 1, 7), (11, 5, 2)])
def test_synthetic_batches_are_bitwise_jax(seed, agent, step):
    want = JD.SyntheticLM(vocab_size=300, seed=seed).batch(step, 3, 17, agent)
    got = TD.SyntheticLM(vocab_size=300, seed=seed).batch(step, 3, 17, agent)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_memmap_batches_and_host_shards_are_bitwise_jax(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    j, t = JD.MemmapTokens(str(path), 1000, seed=4), TD.MemmapTokens(
        str(path), 1000, seed=4)
    assert np.array_equal(t.batch(3, 4, 33, agent=2), j.batch(3, 4, 33, agent=2))
    src_j, src_t = JD.SyntheticLM(vocab_size=99), TD.SyntheticLM(vocab_size=99)
    it_j = JD.make_batch_iterator(src_j, 4, 9, agent=1, start_step=5,
                                  process_index=1, process_count=2)
    it_t = TD.make_batch_iterator(src_t, 4, 9, agent=1, start_step=5,
                                  process_index=1, process_count=2)
    for _ in range(3):
        assert np.array_equal(next(it_t)["tokens"], next(it_j)["tokens"])
    with pytest.raises(ValueError, match="divide"):
        next(TD.make_batch_iterator(src_t, 3, 9, process_count=2))


@pytest.mark.parametrize("name,args", [
    ("constant_lr", (3e-4,)),
    ("cosine_lr", (1e-3, 50, 0.1)),
    ("warmup_cosine_lr", (1e-3, 7, 60, 0.05)),
])
def test_schedules_match_jax(name, args):
    jf, tf = getattr(JO, name)(*args), getattr(TO, name)(*args)
    for step in (0, 1, 6, 7, 33, 60, 75):
        for js, ts in ((step, step),
                       (jnp.int32(step), torch.tensor(step, dtype=torch.int32))):
            got, want = tf(ts), np.asarray(jf(js))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def _tree_case(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(dtype),
            "b": {"c": rng.standard_normal(5).astype(dtype),
                  "d": [rng.standard_normal((2, 2)).astype(dtype)]}}


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("momentum", {"beta": 0.8}),
    ("momentum", {"beta": 0.9, "nesterov": True}),
    ("adamw", {"weight_decay": 0.01}),
    ("adamw", {"state_dtype": "bfloat16"}),
])
def test_tree_optimizers_and_clip_match_jax(name, kw):
    if kw.get("state_dtype"):
        jkw = dict(kw, state_dtype=jnp.bfloat16)
        tkw = dict(kw, state_dtype=torch.bfloat16)
    else:
        jkw = tkw = kw
    jopt, topt = getattr(JO, name)(**jkw), getattr(TO, name)(**tkw)
    jp = jax.tree.map(jnp.asarray, _tree_case(0))
    tp = tmap(torch.from_numpy, _tree_case(0))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = _tree_case(step + 1)
        jg, jn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.5)
        tg, tn = TO.clip_by_global_norm(tmap(torch.from_numpy, g), 1.5)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        jp, js = jopt.apply(jg, js, jp, 1e-2)
        tp, ts = topt.apply(tg, ts, tp, 1e-2)
    for x, y in zip(dispatch.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                   atol=1e-7)
    if name == "adamw":
        assert int(ts["t"]) == int(js["t"]) == 3
        want = torch.bfloat16 if kw.get("state_dtype") else torch.float32
        assert ts["m"]["a"].dtype == want
        assert (topt.flat is None) == bool(kw.get("state_dtype"))


# --- the loss ------------------------------------------------------------------

@pytest.mark.parametrize("branch", [0, 1], ids=["logits", "chunked"])
def test_lm_loss_and_gradient_match_jax(jax_runs, branch):
    _, tc = _cfgs()
    params = TM.params_from_jax(tc, jax_runs["tree"], device="cpu")
    leaves = TM.transformer.tree_map(lambda t: t.requires_grad_(), params)
    loss = TM.lm_loss(tc, leaves, {"tokens": torch.from_numpy(
        jax_runs["tokens"])}, ce_chunks=(0, 2)[branch])
    loss.backward()
    want_loss, want_grad = jax_runs["loss_grad"][branch]
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=RTOL,
                               atol=ATOL)
    want = TM.params_from_jax(tc, want_grad, device="cpu")
    for got, w in zip(TM.transformer.tree_leaves(leaves),
                      TM.transformer.tree_leaves(want)):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((got.grad - w).abs().max()) <= 1e-5 * scale


def test_remat_recomputes_and_changes_nothing():
    """``cfg.remat``: the same loss and gradients, bitwise, and each
    layer's attention run twice (once more in the backward)."""
    _, tc = _cfgs()
    params = TM.init_params(tc, seed=1, device="cpu")
    toks = torch.from_numpy(_tokens(1)[0])
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
            loss = TM.lm_loss(cfg, leaves, {"tokens": toks})
            loss.backward()
        finally:
            dispatch.swa_attention_plain = real
        calls.append(n[0])
        out.append([loss.detach()] + [t.grad for t in
                                      TM.transformer.tree_leaves(leaves)])
    assert calls == [tc.n_layers, 2 * tc.n_layers]
    assert all(torch.equal(x, y) for x, y in zip(*out))


@pytest.mark.parametrize("arch,match", [("rwkv6-1.6b", None),
                                        ("phi4-mini-3.8b", None)])
def test_lm_loss_refuses_what_the_port_cannot_train(arch, match):
    """Every family the port serves trains (RWKV6 since slice 16, global
    attention since slice 13, the encoder-decoder since slice 19, a VLM
    prefix since slice 21); MoE models are refused by ``lm_loss`` and the
    flat layout."""
    cfg = TC.get_arch(arch).reduced()
    toks = torch.zeros(1, 9, dtype=torch.int64)
    assert match is None
    params = TM.init_params(cfg, seed=0, device="cpu")
    assert torch.isfinite(TM.lm_loss(cfg, params, {"tokens": toks}))
    assert TF.ParamLayout(cfg).n > 0
    moe = dataclasses.replace(TC.get_arch("h2o-danube-3-4b").reduced(),
                              family="moe", n_experts=2, top_k=1)
    with pytest.raises(NotImplementedError, match="MoE"):
        TM.lm_loss(moe, {}, {"tokens": toks})
    with pytest.raises(NotImplementedError, match="MoE"):
        TF.ParamLayout(moe)
    # the vision frontend trains: its prefix rows are dropped before the
    # loss, and its projector is a leaf of the flat layout
    vlm = dataclasses.replace(cfg, frontend="vision", n_frontend_tokens=3)
    params = TM.init_params(vlm, seed=0, device="cpu")
    emb = torch.zeros(1, 3, vlm.d_model)
    assert torch.isfinite(TM.lm_loss(vlm, params, {"tokens": toks,
                                                   "patch_embeds": emb}))
    assert TF.ParamLayout(vlm).n == TF.ParamLayout(cfg).n + vlm.d_model ** 2
    assert ("projector", "w") in TF.ParamLayout(vlm).paths


# --- the federated steps --------------------------------------------------------

def test_layout_is_ravel_pytree_order_and_views_the_row(jax_runs):
    _, tc = _cfgs()
    st = TF.train_state_from_jax(tc, jax_runs["runs"]["periodic"]["init"],
                                 device="cpu")
    assert st.layout.n == st.params.shape[1]
    assert np.array_equal(st.params.numpy(), _flat_rows(
        jax_runs["runs"]["periodic"]["init"]["params"]))
    tree = st.layout.model_params(st.params[1])
    assert tree["blocks"][1]["attn"]["wq"].data_ptr() > st.params[1].data_ptr()
    assert sum(t.numel() for t in TM.transformer.tree_leaves(tree)) == \
        st.layout.n
    row = st.params[0].detach().requires_grad_()
    leaves = st.layout.model_params(row, st.grads, 0)
    TM.lm_loss(tc, leaves, {"tokens": torch.from_numpy(_tokens(0)[0])}
               ).backward()
    # the row's gradient is the agent's row of the gradient buffer itself
    assert row.grad.data_ptr() == st.grads[0].data_ptr()
    assert row.grad.shape == (st.layout.n,)


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_local_and_sync_steps_match_jax(jax_runs, name):
    _, tc = _cfgs()
    run = jax_runs["runs"][name]
    fed = TF.FedTrainConfig(**dataclasses.asdict(jax_runs["feds"][name]))
    st = TF.train_state_from_jax(tc, run["init"], device="cpu")
    opt = TO.adamw(weight_decay=0.01)
    local = TF.make_local_step(tc, opt, fed, n_agents=A)
    sync = TF.make_sync_step(tc, fed, n_agents=A)
    for step in range(STEPS):
        st, m = local(st, {"tokens": torch.from_numpy(_tokens(step))})
        if (step + 1) % TAU == 0:
            st = sync(st)
            if fed.strategy != "consensus":
                assert torch.equal(st.params[0], st.params[1])
        np.testing.assert_allclose(
            [float(m["loss"]), float(m["grad_norm"])], run["metrics"][step],
            rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.params.numpy(), run["params"], rtol=0,
                               atol=PARAM_ATOL)
    got = TF.train_state_to_tree(st)
    assert int(got["step"]) == int(run["state"]["step"]) == STEPS
    assert np.array_equal(got["opt"]["t"].numpy(),
                          np.asarray(run["state"]["opt"]["t"]))
    if fed.outer_momentum:
        for key in ("anchor", "outer_m"):
            np.testing.assert_allclose(
                _flat_rows(tmap(lambda t: t.numpy(), got[key])),
                _flat_rows(run["state"][key]), rtol=0, atol=PARAM_ATOL)


def test_train_matches_jax_train_and_its_checkpoint_restores_in_jax(tmp_path):
    jc = JC.get_arch("h2o-danube-3-4b").reduced()
    fed = JF.FedTrainConfig(strategy="consensus", tau=TAU, lr=LR)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jstate, jlosses = JT.train("h2o-danube-3-4b", reduced=True, steps=3,
                               fed=fed, n_agents=A, batch=B, seq=S,
                               ckpt_dir=str(jax_dir), log_every=100)
    init = jax.device_get(JF.init_train_state(
        jc, jax.random.key(0), A, JO.adamw(weight_decay=0.01), fed))
    tc = TC.get_arch("h2o-danube-3-4b").reduced()
    st0 = TF.train_state_from_jax(tc, init, device="cpu")
    st, losses = TT.train("h2o-danube-3-4b", reduced=True, steps=3,
                          fed=TF.FedTrainConfig(**dataclasses.asdict(fed)),
                          n_agents=A, batch=B, seq=S, ckpt_dir=str(port_dir),
                          log_every=100, device="cpu", state=st0)
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.params.numpy(), _flat_rows(jstate["params"]),
                               rtol=0, atol=PARAM_ATOL)
    got, meta = jax_restore(str(port_dir))
    want, jmeta = jax_restore(str(jax_dir))
    assert meta == jmeta == {"arch": tc.name, "strategy": "consensus",
                             "step": 3}
    mine = tmap(lambda t: t.numpy(), TF.train_state_to_tree(st))
    assert jax.tree.structure(got) == jax.tree.structure(want) == \
        jax.tree.structure(mine)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(mine)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    with np.load(next(port_dir.glob("*.npz"))) as a, \
            np.load(next(jax_dir.glob("*.npz"))) as b:
        assert sorted(a.files) == sorted(b.files)


def test_bf16_checkpoint_is_the_jax_packages_bytes(tmp_path):
    cfg = dataclasses.replace(TC.get_arch("h2o-danube-3-4b").reduced(),
                              param_dtype="bfloat16", n_layers=1)
    st = TF.init_train_state(cfg, 3, 1, TO.adamw(), TF.FedTrainConfig(),
                             device="cpu")
    tree = TF.train_state_to_tree(st)
    torch_save(str(tmp_path / "port"), 1, tree)
    from repro.checkpoint import save as jax_save
    bits = tmap(lambda t: t.numpy() if t.dtype != torch.bfloat16
                       else jax.lax.bitcast_convert_type(jnp.asarray(
                           t.view(torch.int16).numpy()), jnp.bfloat16), tree)
    jax_save(str(tmp_path / "jax"), 1, bits)
    with np.load(tmp_path / "port" / "step_0000000001.npz") as a, \
            np.load(tmp_path / "jax" / "step_0000000001.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes()
    back = TF.train_state_from_jax(cfg, jax_restore(str(tmp_path / "port"))[0],
                                   device="cpu")
    assert torch.equal(back.params, st.params)


def test_flat_adam_update_is_the_tree_adamw_bitwise():
    """The trainer's update (each agent's clip factor as the flat ``w``, one
    ``flat_opt_update`` over the rows) against the tree ``adamw`` applied
    to each agent's clipped tree (the JAX layout's leaves, the order the
    trainer's norm adds them in)."""
    _, tc = _cfgs()
    layout = TF.ParamLayout(tc)
    rng = np.random.default_rng(5)
    flat = torch.from_numpy(rng.standard_normal((A, layout.n), np.float32))
    opt = TO.adamw(weight_decay=0.01)
    fstate = opt.flat.init(flat)
    trees = [layout.jax_tree(flat[a].clone()) for a in range(A)]
    tstates = [opt.init(t) for t in trees]
    for step in range(3):
        g = torch.from_numpy(rng.standard_normal((A, layout.n), np.float32))
        g[1] *= 1e-3                               # one agent not clipped
        st = TF.TrainState(layout=layout, params=flat, grads=g, opt={},
                           flat_opt=opt.flat)
        scale = torch.clamp(1.0 / torch.clamp(TF.grad_norms(st), min=1e-12),
                            max=1.0)
        flat, fstate = opt.flat.update(flat, g, scale, fstate, 1e-2)
        for a in range(A):
            cg, norm = TO.clip_by_global_norm(layout.jax_tree(g[a]), 1.0)
            assert torch.equal(norm, TF.grad_norms(st)[a])
            trees[a], tstates[a] = opt.apply(cg, tstates[a], trees[a], 1e-2)
    assert scale[1] == 1.0 and scale[0] < 1.0
    for a in range(A):
        got = dispatch.tree_leaves(layout.jax_tree(flat[a]))
        want = dispatch.tree_leaves(trees[a])
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["sync", "consensus", "periodic+outer"])
def test_chip_smoke_launch_formula_counts_the_plain_calls(name):
    """A CPU rehearsal of phase 18's ``_lmtrain_expected`` with remat on:
    the dispatch's plain calls stand for the kernels' launches."""
    c = _chip_smoke()
    _, tc = _cfgs()
    cfg = dataclasses.replace(tc, remat=True)
    kw = dict(STRATEGIES[name], tau=1 if name == "sync" else TAU)
    fed = TF.FedTrainConfig(**kw)
    names = {"swa_attention": "swa_attention_plain",
             "swa_attention_bwd": "swa_attention_bwd_plain",
             "adam_update": "adam_update_plain", "row_mean": "row_mean_plain",
             "consensus_step": "consensus_step_plain"}
    counts = {k: 0 for k in names}
    real = {k: getattr(dispatch, v) for k, v in names.items()}

    def counting(k):
        def fn(*a, **kw_):
            counts[k] += 1
            return real[k](*a, **kw_)
        return fn
    opt = TO.adamw(weight_decay=0.01)
    st = TF.init_train_state(cfg, 0, A, opt, fed, device="cpu")
    local = TF.make_local_step(cfg, opt, fed, n_agents=A)
    sync = TF.make_sync_step(cfg, fed, n_agents=A)
    try:
        for k, v in names.items():
            setattr(dispatch, v, counting(k))
        for step in range(3):
            local(st, {"tokens": torch.from_numpy(_tokens(step))})
            if (step + 1) % fed.tau == 0:
                sync(st)
    finally:
        for k, v in names.items():
            setattr(dispatch, v, real[k])
    assert counts == c._lmtrain_expected(cfg, fed, A, 3)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fed = TF.FedTrainConfig(tau=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.train("h2o-danube-3-4b", reduced=True, steps=1, fed=fed,
                 n_agents=A, batch=1, seq=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TF.init_train_state(_cfgs()[1], 0, A, TO.adamw(), fed)
    with pytest.raises(ValueError, match="unknown strategy"):
        TF.FedTrainConfig(strategy="gossip")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lm100m_example_twin_trains_the_jax_examples_config():
    """``examples/torch_train_lm_federated.py`` trains the JAX example's
    lm-100m (every config field equal) on its batches (4 x 128 tokens an
    agent), head 64: the D = 64 backward, fp32, causal with GQA 8 / 4."""
    jex = _example("train_lm_federated")
    tex = _example("torch_train_lm_federated")
    got = tex.lm100m()
    assert dataclasses.asdict(got) == dataclasses.asdict(jex.LM100M)
    assert tex.lm100m() is got
    assert (tex.BATCH, tex.SEQ) == (4, 128)
    assert (got.head_dim, got.n_heads, got.n_kv_heads) == (64, 8, 4)
