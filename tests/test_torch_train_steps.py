"""Port parity: one federated local step and one mean sync of the reduced
recurrent models (``recurrentgemma-9b``, ``rwkv6-1.6b``; the configurations
of ``test_torch_train_families.py``) on the CPU, against the JAX package's
``make_local_step`` / ``make_sync_step`` from the same JAX-made state; and
``chip_smoke.py``'s launch formula of phase 20 rehearsed by counting the
dispatch's plain calls.
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

import repro.optim as JO
from repro.launch import fedtrain as JF
from repro_torch import optim as TO
from repro_torch.kernels import dispatch
from repro_torch.launch import fedtrain as TF
from test_torch_train_families import ATOL, GEMMA, RG, RTOL, RWKV, cfgs, tokens

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", [RG, RWKV])
def test_local_step_and_sync_match_jax(arch):
    """One local step and one mean sync (periodic, tau 1) of two agents
    against JAX's: the metrics ``rtol 1e-5``, the parameters after the
    Adam step and the sync within ``5e-5`` (``test_torch_lm_train.py``'s
    rule), the agent rows bitwise equal after the sync."""
    jc, tc = cfgs(arch)
    A = 2
    fed = JF.FedTrainConfig(strategy="periodic", tau=1, lr=1e-3)
    opt = JO.adamw(weight_decay=0.01)
    st = JF.init_train_state(jc, jax.random.key(0), A, opt, fed)
    init = jax.device_get(st)
    toks = tokens(agents=A)
    core = {k: st[k] for k in ("params", "opt", "step")}
    core, m = jax.jit(JF.make_local_step(jc, opt, fed, n_agents=A))(
        core, {"tokens": jnp.asarray(toks)})
    st = jax.jit(JF.make_sync_step(jc, fed, n_agents=A))(dict(st, **core))
    want = np.stack([np.asarray(ravel_pytree(jax.tree.map(
        lambda x: x[a], st["params"]))[0]) for a in range(A)])

    tfed = TF.FedTrainConfig(**dataclasses.asdict(fed))
    topt = TO.adamw(weight_decay=0.01)
    ts = TF.train_state_from_jax(tc, init, device="cpu")
    ts, tm = TF.make_local_step(tc, topt, tfed, n_agents=A)(
        ts, {"tokens": torch.from_numpy(toks)})
    ts = TF.make_sync_step(tc, tfed, n_agents=A)(ts)
    np.testing.assert_allclose([float(tm["loss"]), float(tm["grad_norm"])],
                               [float(m["loss"]), float(m["grad_norm"])],
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(ts.params[0], ts.params[1])
    np.testing.assert_allclose(ts.params.numpy(), want, rtol=0, atol=5e-5)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", [GEMMA, RG, RWKV])
def test_chip_smoke_train_formula_counts_the_plain_calls(arch):
    """A CPU rehearsal of phase 20's ``_train_expected`` with remat on, 2
    agents, 3 local steps at tau 2 (one sync): the dispatch's plain calls
    stand for the kernels' launches."""
    c = _chip_smoke()
    _, tc = cfgs(arch, remat=True)
    fed = TF.FedTrainConfig(strategy="periodic", tau=2)
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
    st = TF.init_train_state(tc, 0, 2, opt, fed, device="cpu")
    local = TF.make_local_step(tc, opt, fed, n_agents=2)
    sync = TF.make_sync_step(tc, fed, n_agents=2)
    try:
        for k, v in names.items():
            setattr(dispatch, v, counting(k))
        for step in range(3):
            local(st, {"tokens": torch.from_numpy(tokens(step, agents=2))})
            if (step + 1) % fed.tau == 0:
                sync(st)
    finally:
        for k, v in names.items():
            setattr(dispatch, v, real[k])
    assert counts == c._train_expected(tc, fed, 2, 3)
