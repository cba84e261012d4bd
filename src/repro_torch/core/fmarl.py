"""The task-generic FMARL driver (paper Algorithms 1 and 2; ``repro.core.fmarl``).

All m agents live as rows of one flat ``(m, n)`` carry for the whole run
(n = the parameters of one replica, laid out as ``jax.flatten_util.
ravel_pytree`` lays them out). Each local step hands the user's gradient
closure per-agent views of the carry, ravels the grads it returns, and runs
the strategy's step on the flat buffers (``flat_local_step``: the variation
mask, the decay weight or the consensus gossip, then SGD or the fused
optimizer); every tau steps the virtual server averages the replicas (eq.
11, ``flat_sync``) and the optimizer moments with them. On the card each of
those is a hand-written kernel launch (``decay_accum``, ``row_mean``,
``momentum_update`` / ``adam_update``, ``consensus_step`` /
``consensus_gather``, ``topk_scatter``); on the CPU their plain versions.

One carry. The JAX package has two: the tree-space jnp reference
(``_run_fmarl_tree``, ``src/repro/core/fmarl.py:137``) and the flat carry
(``_run_fmarl_flat``, ``:182``). The port keeps the flat carry only and is
held against both JAX paths (tests/test_torch_fmarl.py), as
``repro_torch.rl.fedrl`` is for the RL driver. Where the JAX jit runs one
scan, this is a Python loop with a host step counter.

The closure. Where the JAX driver vmaps a per-agent closure
``local_grad_fn(params_i, key, agent_idx, step)``, the port's closure is
batched over the agents, PyTorch's idiom::

    local_grad_fn(params_m, agent_ids, step, gen) -> (grads_m, aux)

``params_m`` is a dict of ``(m, ...)`` fp32 views of the carry (read them,
do not write them), ``agent_ids`` the ``(m,)`` agent indices, ``step`` the
global iteration k (a host int) and ``gen`` the run's ``torch.Generator``
on the run's device, seeded from the run's seed. ``grads_m`` has
``params_m``'s layout; ``aux`` is a dict of per-agent ``(m, ...)`` tensors
(each leaf is averaged over the period's tau steps and m agents, as
``jax.tree.map(jnp.mean, aux)``), computed anew (not a view of the
params). ``eval_grad_fn(server_params, gen_eval) -> grads`` gets the fp32
server tree and a separate evaluation generator. A closure may ignore
``gen`` and read precomputed draws by ``step``: that is how the tests
replay the JAX package's noise. A per-agent closure ``f(params_i, noise_i,
agent_idx)`` lifts with ``torch.func.vmap``: draw the agents' noise from
``gen`` first (``torch.randn((m, ...), generator=gen, device=...)``), then
``torch.func.vmap(f)(params_m, noise, agent_ids)``; the driver itself does
not depend on it.

Runs. :func:`run_fmarl_batch` runs S configs that differ only in their
values (the learning rate, the strategy's tables) on an ``(S, m, n)``
carry: the closure runs once per run and step on that run's views with that
run's generator, and every aggregation primitive takes the run axis in one
dispatch call (``repro_torch.core.strategies.stack_runs``), as
``repro_torch.rl.fedrl.run_fedrl_batch`` does. On the CPU a batched run
equals the loop of one-run calls bitwise. :func:`run_fmarl` is the one-run
case. With ``buffer_dtype="bfloat16"`` the carry and the raveled grads are
stored in bf16; the closures still see fp32 views.

The phases of a step run inside ``torch.profiler.record_function`` ranges
(``fmarl.gradient``, ``fmarl.local_step``, ``fmarl.sync``,
``fmarl.eval``). ``FmarlConfig.eval_every`` is carried as the JAX config
carries it; like the JAX driver, the port evaluates at every period.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.accounting import CostLedger
from repro_torch.core.strategies import AggregationStrategy, stack_runs
from repro_torch.kernels import dispatch
from repro_torch.optim.flat import FlatOptimizer, server_average_state
from repro_torch.utils.pytree import tree_l2_norm

# The evaluation generator's seed is the run's seed folded with this
# constant (the hetero_scale axis folds 2026, the delay process 2027).
EVAL_FOLD = 2028


class FmarlState(NamedTuple):
    """The end of a run: ``params_m`` the replicas' tree (``(m, ...)``
    leaves; ``(S, m, ...)`` from :func:`run_fmarl_batch`), ``server_params``
    the server's (``(...)``; ``(S, ...)``), both fp32; ``step`` the global
    iteration count k; ``gen`` the run's generator (a tuple of the S runs'
    from :func:`run_fmarl_batch`)."""

    params_m: dict
    server_params: dict
    step: int
    gen: object


@dataclasses.dataclass(frozen=True)
class FmarlConfig:
    strategy: AggregationStrategy
    eta: float
    n_periods: int
    eval_every: int = 1          # carried as in the JAX config (see module)
    optimizer: Optional[FlatOptimizer] = None  # None = plain SGD
    # storage dtype of the flat params / grad buffers (None = fp32), e.g.
    # "bfloat16": the primitives and the optimizer moments still accumulate
    # in fp32, the closures see fp32 views
    buffer_dtype: Optional[str] = None

    def __post_init__(self):
        dispatch.storage_dtype(self.buffer_dtype)  # fail fast on typos


def _eval_seed(seed: int) -> int:
    """The evaluation generator's seed for a run of seed ``seed``."""
    return (int(seed) * 1_000_003 + EVAL_FOLD) % (2 ** 63)


def _structure(cfg: FmarlConfig) -> tuple:
    """Every field but those a run may set on its own (eta, the strategy's
    values)."""
    return tuple(getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                 if f.name not in ("eta", "strategy"))


def _unravel_lead(spec: dispatch.FlatSpec, buf: torch.Tensor) -> dict:
    """The tree of a flat buffer with any leading axes (``(n,)``, ``(m,
    n)``, ``(S, m, n)``): each leaf shaped ``lead + shape``, a view."""
    lead = tuple(buf.shape[:-1])
    return dispatch.tree_from_leaves(spec.paths, (
        buf[..., o:o + sz].reshape(lead + shape)
        for o, sz, shape in zip(spec.offsets, spec.sizes, spec.shapes)))


def _init_row(init_params, device) -> tuple:
    """One replica's tree as an fp32 ``(n,)`` row on ``device`` and its
    layout."""
    def stacked(v):
        if isinstance(v, dict):
            return {k: stacked(x) for k, x in v.items()}
        t = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        return t.to(device, torch.float32)[None]

    flat, spec = dispatch.stacked_ravel_spec(stacked(init_params))
    return flat[0], spec


def _period_means(steps: List[dict]) -> List[torch.Tensor]:
    """Each aux leaf of one period averaged over its steps and agents (0-d
    fp32 tensors, in leaf order)."""
    per_step = [dispatch.tree_leaves(a) for a in steps]
    return [torch.stack([leaves[i] for leaves in per_step]).float().mean()
            for i in range(len(per_step[0]))]


def _per_period(values: List[List[torch.Tensor]]) -> np.ndarray:
    """``(S, n_periods)`` numpy from S runs' lists of 0-d tensors."""
    return torch.stack([torch.stack(v) for v in values]).cpu().numpy()


def run_fmarl_batch(cfgs: Sequence[FmarlConfig], init_params,
                    local_grad_fn: Callable, seeds: Sequence[int],
                    eval_grad_fn: Optional[Callable] = None, *,
                    device: Union[str, torch.device] = "cuda"):
    """Run S FMARL trainings as one batched run on an ``(S, m, n)`` carry.

    ``cfgs`` are alike in everything but ``eta`` and their strategies'
    values (``stack_runs`` checks the strategies); every run starts from
    ``init_params`` (one replica's tree of tensors or arrays) and draws from
    its own generator, seeded with its entry of ``seeds``. Returns
    ``(FmarlState, metrics)``: the state's leaves carry the run axis first;
    ``metrics`` holds numpy ``mean_aux`` (a tree of ``(S, n_periods)``
    arrays) and, with ``eval_grad_fn``, ``server_grad_sq_norm`` ``(S,
    n_periods)``. Runs on the card unless ``device="cpu"``.
    """
    cfgs, seeds = list(cfgs), [int(s) for s in seeds]
    if not cfgs or len(cfgs) != len(seeds):
        raise ValueError(f"run_fmarl_batch: {len(cfgs)} configs and "
                         f"{len(seeds)} seeds; need one each, >= 1")
    cfg = cfgs[0]
    for i, c in enumerate(cfgs):
        if _structure(c) != _structure(cfg):
            raise ValueError(f"run_fmarl_batch: config {i} differs from "
                             f"config 0 in more than eta and the strategy's "
                             f"values")
    dev = dispatch.resolve_device(device)
    S = len(cfgs)
    strat, opt = stack_runs([c.strategy for c in cfgs]), cfg.optimizer
    m, tau = strat.m, strat.tau
    if strat.is_async:
        strat.validate_horizon(cfg.n_periods)
    dtype = dispatch.storage_dtype(cfg.buffer_dtype)
    etas = [float(np.float32(c.eta)) for c in cfgs]
    eta = cfg.eta if len(set(etas)) == 1 else torch.tensor(
        etas, dtype=torch.float32, device=dev)

    row, spec = _init_row(init_params, dev)
    flat = row.expand(S, m, spec.n).contiguous()
    if dtype is not None:
        flat = flat.to(dtype)
    opt_state = opt.init(flat) if opt is not None else {}
    comm_state = strat.init_comm_state(flat)
    gens = tuple(torch.Generator(device=dev).manual_seed(s) for s in seeds)
    eval_gens = [torch.Generator(device=dev).manual_seed(_eval_seed(s))
                 for s in seeds]
    agent_ids = torch.arange(m, device=dev)
    g = torch.empty_like(flat)

    aux_paths: list = []
    aux_means: List[List[List[torch.Tensor]]] = [[] for _ in range(S)]
    grad_sq: List[List[torch.Tensor]] = [[] for _ in range(S)]
    step = 0
    for p in range(cfg.n_periods):
        steps: List[List[dict]] = [[] for _ in range(S)]
        for offset in range(tau):
            with record_function("fmarl.gradient"):
                view = dispatch.compute_view(flat, dtype)
                for s in range(S):
                    g_tree, aux = local_grad_fn(spec.unravel(view[s]),
                                                agent_ids, step, gens[s])
                    spec.ravel(g_tree, out=g[s])
                    steps[s].append(aux)
            with record_function("fmarl.local_step"):
                flat, opt_state, comm_state = strat.flat_local_step(
                    flat, g, offset, eta, opt, opt_state, comm_state)
            step += 1
        with record_function("fmarl.sync"):
            flat, comm_state = strat.flat_sync(flat, comm_state, period=p)
            if opt is not None and not strat.is_async:
                # an async boundary syncs only the arrived replicas; the
                # moments stay local (FedBuff keeps no server momentum)
                server_average_state(strat, opt_state)
        if p == 0:
            aux_paths = dispatch.tree_paths(steps[0][0])
        for s in range(S):
            aux_means[s].append(_period_means(steps[s]))
        if eval_grad_fn is not None:
            with record_function("fmarl.eval"):
                rows = dispatch.compute_view(strat.server_row(flat,
                                                              comm_state),
                                             dtype)
                for s in range(S):
                    gs = eval_grad_fn(spec.unravel_one(rows[s]), eval_gens[s])
                    norm = tree_l2_norm(gs)
                    grad_sq[s].append(norm * norm)

    metrics = {"mean_aux": dispatch.tree_from_leaves(aux_paths, [
        _per_period([[means[i] for means in aux_means[s]] for s in range(S)])
        for i in range(len(aux_paths))])}
    if eval_grad_fn is not None:
        metrics["server_grad_sq_norm"] = _per_period(grad_sq)
    state = FmarlState(
        params_m=_unravel_lead(spec, dispatch.compute_view(flat, dtype)),
        server_params=_unravel_lead(spec, dispatch.compute_view(
            strat.server_row(flat, comm_state), dtype)),
        step=step, gen=gens)
    return state, metrics


def _one_run(state: FmarlState, metrics: dict):
    def first(tree):
        return {k: first(v) if isinstance(v, dict) else v[0]
                for k, v in tree.items()}

    return (FmarlState(first(state.params_m), first(state.server_params),
                       state.step, state.gen[0]), first(metrics))


def run_fmarl_core(cfg: FmarlConfig, init_params, local_grad_fn: Callable,
                   seed: int = 0, eval_grad_fn: Optional[Callable] = None, *,
                   device: Union[str, torch.device] = "cuda"):
    """:func:`run_fmarl` without the ledger: ``(FmarlState, metrics)``."""
    return _one_run(*run_fmarl_batch([cfg], init_params, local_grad_fn,
                                     [seed], eval_grad_fn, device=device))


def _payload_elems(init_params) -> int:
    """Parameters of one replica: the per-event payload in elements."""
    if isinstance(init_params, dict):
        return sum(_payload_elems(v) for v in init_params.values())
    return int(np.prod(np.shape(init_params), dtype=np.int64))


def run_fmarl(cfg: FmarlConfig, init_params, local_grad_fn: Callable,
              seed: int = 0, eval_grad_fn: Optional[Callable] = None, *,
              device: Union[str, torch.device] = "cuda"):
    """Run Algorithm 1 (or 2, if the strategy gossips) for ``cfg.n_periods``
    periods. Returns ``(FmarlState, metrics, CostLedger)``: per-period numpy
    ``mean_aux`` (a tree of ``(n_periods,)`` arrays) and, with
    ``eval_grad_fn``, ``server_grad_sq_norm``; the ledger bills the run's
    periods at the payload of one replica. Runs on the card unless
    ``device="cpu"``: :func:`run_fmarl_batch` with one run."""
    state, metrics = run_fmarl_core(cfg, init_params, local_grad_fn, seed,
                                    eval_grad_fn, device=device)
    ledger = CostLedger()
    ledger.add_periods(cfg.strategy, cfg.n_periods,
                       _payload_elems(init_params))
    return state, metrics, ledger


def expected_gradient_norm(metrics) -> float:
    """Table II metric: mean of ||grad F(theta_bar_k)||^2 over the run."""
    return float(np.asarray(metrics["server_grad_sq_norm"]).mean())
