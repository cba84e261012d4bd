"""Federated LM training: the paper's aggregation schemes as cross-agent
sync strategies (local SGD, DiLoCo-style), the port of
``repro.launch.fedtrain``.

A agents each train their own copy of the model on their own data stream;
every ``tau`` local steps the sync step runs the strategy's collective:

* ``periodic`` / ``sync``: the mean over the agents (eq. 11);
* ``decay``: the same mean, with local step j of a period at learning rate
  ``lr * lambda^(j / 2)`` (eq. 21);
* ``consensus``: the fused ring mixing ``P^E`` over the agents (eq. 23);
* optionally the beyond-paper outer Nesterov momentum on the synced delta.

Layout. Each agent's parameters are one row of a flat ``(A, n)`` buffer in
the parameter dtype, in the order of ``jax.flatten_util.ravel_pytree`` over
the JAX package's parameter tree (its ``cycles`` stacked over the layers,
an encoder-decoder's ``enc_blocks`` / ``dec_blocks`` likewise, dict keys
sorted): :class:`ParamLayout`. Adam's moments are fp32 ``(A, n)``
buffers beside it, as in the RL and FMARL drivers. The model reads views of
an agent's row; one backward writes the agent's gradient row into an
``(A, n)`` gradient buffer (:class:`RowViews`).

Hot path on the card, per local step: the model's forward and backward for
each agent on its tokens (and frames, for an encoder-decoder model) (the
``swa_attention`` forward and ``swa_attention_bwd`` kernels in every
attention, whisper-small's encoder and cross-attentions included, the ``wkv6`` and ``wkv6_bwd`` kernels in every
``wkv`` layer, each forward twice under ``cfg.remat``), each
agent's global gradient norm (one fp32 sum per leaf, added in leaf order,
as ``repro.utils.pytree.tree_l2_norm``), then one ``adam_update`` launch
over all A rows with the clip factor as the per-row weight ``w`` (it
enters before the moments, as JAX's ``g * scale`` does). Per sync: one
``row_mean`` launch (``periodic``, ``sync``, ``decay``) or one
``consensus_step`` launch (``consensus``). Only parameters are synced,
never the moments. The outer momentum's elementwise update is plain torch,
as JAX leaves it to XLA.

In place: the local and sync steps update the :class:`TrainState` they are
given and return it. ``train_state_axes`` (a sharding spec) waits for
``sharding/rules.py``; the steps take no ``rules=``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import (
    _as_tensor,
    check_trainable,
    init_params,
    layer_plan,
    lm_loss,
    param_shapes,
)
from repro_torch.optim.flat import FlatOptimizer
from repro_torch.optim.optimizers import Optimizer
from repro_torch.utils.pytree import tree_l2_norm, tree_map

# Columns of an (A, n) buffer the outer momentum updates at a time (its fp32
# temporaries stay at a few hundred MB whatever n).
OUTER_CHUNK = 1 << 25


@dataclasses.dataclass(frozen=True)
class FedTrainConfig:
    strategy: str = "periodic"       # sync | periodic | decay | consensus
    tau: int = 8
    decay_lambda: float = 0.98       # for 'decay' (paper eq. 21)
    consensus_eps: float = 0.4       # for 'consensus' on the agent ring
    consensus_rounds: int = 1
    outer_momentum: float = 0.0      # beyond-paper: DiLoCo outer Nesterov
    grad_clip: float = 1.0
    lr: float = 3e-4

    def __post_init__(self):
        if self.strategy not in ("sync", "periodic", "decay", "consensus"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.tau < 1:
            raise ValueError(f"tau must be >= 1, got {self.tau}")


def _ring_mixing(n: int, eps: float, rounds: int) -> np.ndarray:
    """Fused mixing matrix P^E for the n-agent ring (a chain for n = 2)."""
    if n == 1:
        return np.ones((1, 1), np.float32)
    adj = np.zeros((n, n))
    for i in range(n):
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = 1
    adj = np.minimum(adj, 1)
    la = np.diag(adj.sum(1)) - adj
    p = np.eye(n) - eps * la
    return np.linalg.matrix_power(p, rounds).astype(np.float32)


def _decay_weights(fed: FedTrainConfig) -> torch.Tensor:
    """``lambda^(j / 2)`` for j < tau, in fp32."""
    j = torch.arange(fed.tau, dtype=torch.float32)
    return torch.pow(torch.tensor(fed.decay_lambda, dtype=torch.float32),
                     j / 2.0)


# ----------------------------------------------------------------------------
# The flat layout of one agent's parameters
# ----------------------------------------------------------------------------

def _jax_paths(tree) -> List[Tuple[tuple, torch.Tensor]]:
    """``(path, leaf)`` in ``jax.tree.leaves`` order."""
    return list(zip(dispatch.tree_paths(tree), dispatch.tree_leaves(tree)))


def _set(tree, path, value):
    """Put ``value`` at ``path`` (dict keys and list indices) of ``tree``,
    making the dicts and lists on the way."""
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        empty = [] if isinstance(nxt, int) else {}
        if isinstance(node, list):
            node.extend([None] * (key + 1 - len(node)))
            if node[key] is None:
                node[key] = empty
            node = node[key]
        else:
            node = node.setdefault(key, empty)
    if isinstance(node, list):
        node.extend([None] * (path[-1] + 1 - len(node)))
    node[path[-1]] = value


class ParamLayout:
    """Where each parameter of one agent lies in its flat row.

    ``paths`` / ``shapes`` are the JAX package's parameter tree in
    ``ravel_pytree`` order (``spec``, a :class:`dispatch.FlatSpec`, holds
    their offsets): with ``cfg.scan_layers`` the layers of a cycle entry
    are one stacked leaf of shape ``(n_cycles, ...)``. ``pieces`` cut those
    into the port's per-layer parameters: ``(offset, shape, port_path)``,
    ``port_path`` into ``{"embed", "final_norm", "unembed", "blocks": [...]}``.
    An encoder-decoder model's tree is the same in both packages
    (``dec_blocks``, ``embed``, ``enc_blocks``, ``enc_norm``,
    ``final_norm``, the blocks stacked over layers): its pieces are its
    leaves.
    """

    def __init__(self, cfg):
        check_trainable(cfg)
        want = param_shapes(cfg)
        self.encdec = cfg.is_encoder_decoder
        plan = layer_plan(cfg)
        P = len(plan.cycle_kinds)
        if self.encdec:
            jax_tree: Dict = want
        else:
            blocks = want["blocks"]
            jax_tree = {k: v for k, v in want.items() if k != "blocks"}
            jax_tree["head_blocks"] = [blocks[li] for li in plan.head]
            jax_tree["tail_blocks"] = [blocks[li] for li in plan.tail]
            jax_tree["cycles"] = [
                tree_map(lambda t: torch.empty(
                    (plan.n_cycles,) + tuple(t.shape), device="meta"),
                    blocks[len(plan.head) + j])
                for j in range(P)] if plan.n_cycles else []
        leaves = _jax_paths(jax_tree)
        self.paths = tuple(p for p, _ in leaves)
        self.shapes = tuple(tuple(t.shape) for _, t in leaves)
        self.spec = dispatch.FlatSpec(self.paths, self.shapes)
        self.n = self.spec.n
        pieces = []
        for path, shape, off, size in zip(self.paths, self.shapes,
                                          self.spec.offsets, self.spec.sizes):
            top, rest = path[0], path[1:]
            if top == "cycles":
                per = size // plan.n_cycles
                for c in range(plan.n_cycles):
                    li = len(plan.head) + c * P + rest[0]
                    pieces.append((off + c * per, shape[1:],
                                   ("blocks", li) + rest[1:]))
            elif top in ("head_blocks", "tail_blocks"):
                li = (plan.head if top == "head_blocks" else plan.tail)[rest[0]]
                pieces.append((off, shape, ("blocks", li) + rest[1:]))
            else:
                pieces.append((off, shape, path))
        self.pieces = tuple(pieces)
        self.n_layers = cfg.n_layers

    def model_params(self, row: torch.Tensor,
                     grads: Optional[torch.Tensor] = None,
                     agent: int = 0) -> dict:
        """The port's parameter tree as views of ``row`` (one agent's
        ``(n,)`` row). With ``grads`` (the ``(A, n)`` gradient buffer) the
        views go through :class:`RowViews`: a backward writes their
        gradients into ``grads[agent]``."""
        if grads is None:
            views = [row[o:o + int(np.prod(s, dtype=np.int64))].view(s)
                     for o, s, _ in self.pieces]
        else:
            views = RowViews.apply(row, grads, agent, self)
        tree: Dict = {} if self.encdec else {
            "blocks": [{} for _ in range(self.n_layers)]}
        for (_, _, path), v in zip(self.pieces, views):
            _set(tree, path, v)
        return tree

    def jax_tree(self, flat: torch.Tensor):
        """The JAX-layout tree of an ``(A, n)`` buffer (leaves ``(A,
        *shape)``) or an ``(n,)`` row, as views."""
        lead = tuple(flat.shape[:-1])
        tree: Dict = {} if self.encdec else {
            "head_blocks": [], "tail_blocks": [], "cycles": []}
        for path, shape, o, s in zip(self.paths, self.shapes,
                                     self.spec.offsets, self.spec.sizes):
            _set(tree, path, flat[..., o:o + s].view(lead + shape))
        return tree

    def ravel(self, tree, out: torch.Tensor) -> torch.Tensor:
        """Fill ``out`` (``(A, n)``) from a JAX-layout tree whose leaves
        carry a leading agent axis (numpy arrays, bf16 ones as ml_dtypes or
        raw 2-byte records, or tensors), cast to ``out``'s dtype."""
        got = _jax_paths(tree)
        if tuple(p for p, _ in got) != self.paths:
            raise ValueError(f"ParamLayout.ravel: tree paths "
                             f"{[p for p, _ in got]} != {list(self.paths)}")
        A = out.shape[0]
        for (path, leaf), shape, o, s in zip(got, self.shapes,
                                             self.spec.offsets, self.spec.sizes):
            if tuple(np.shape(leaf)) != (A,) + shape:
                raise ValueError(f"ParamLayout.ravel: {path} has shape "
                                 f"{tuple(np.shape(leaf))}, expected "
                                 f"{(A,) + shape}")
            src = leaf if isinstance(leaf, torch.Tensor) else _as_tensor(
                leaf, out.dtype, out.device)
            out[:, o:o + s].copy_(src.reshape(A, s))
        return out


class RowViews(torch.autograd.Function):
    """The views of one agent's flat parameter row that the model reads.

    The forward returns one view per :attr:`ParamLayout.pieces` entry. The
    backward copies each view's gradient into its slot of ``grads[agent]``
    (zeros for a view the loss did not reach) and returns that row, which
    autograd keeps as the row's ``.grad`` without a copy: one backward gives
    the agent's whole flat gradient row and allocates no other row."""

    @staticmethod
    def forward(ctx, row, grads, agent, layout):
        ctx.grads, ctx.agent, ctx.layout = grads, agent, layout
        return tuple(row[o:o + int(np.prod(s, dtype=np.int64))].view(s)
                     for o, s, _ in layout.pieces)

    @staticmethod
    def backward(ctx, *gs):
        out = ctx.grads[ctx.agent]
        for g, (o, s, _) in zip(gs, ctx.layout.pieces):
            n = int(np.prod(s, dtype=np.int64))
            if g is None:
                out[o:o + n].zero_()
            else:
                out[o:o + n].copy_(g.reshape(-1))
        return out, None, None, None


# ----------------------------------------------------------------------------
# Train state
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """The federated train state on one device.

    ``params`` ``(A, n)`` in the parameter dtype; ``grads`` its gradient
    buffer (work space, same shape and dtype); ``opt`` the flat optimizer's
    fp32 state (``{"mu", "nu", "t"}`` for Adam, ``{"mu"}`` for momentum,
    ``{}`` for SGD); ``step`` the local steps taken; with outer momentum
    ``anchor`` ``(A, n)`` in the parameter dtype and ``outer_m`` ``(A, n)``
    fp32 (JAX starts ``outer_m`` in the parameter dtype and carries it in
    fp32 from the first sync; its zeros are exact in either).
    """

    layout: ParamLayout
    params: torch.Tensor
    grads: torch.Tensor
    opt: dict
    flat_opt: FlatOptimizer
    step: int = 0
    anchor: Optional[torch.Tensor] = None
    outer_m: Optional[torch.Tensor] = None

    @property
    def n_agents(self) -> int:
        return int(self.params.shape[0])


def _flat_of(optimizer: Optimizer) -> FlatOptimizer:
    flat = getattr(optimizer, "flat", None)
    if flat is None:
        raise NotImplementedError(
            "the flat LM update needs an optimizer with fp32 moments "
            "(repro_torch.optim.adamw / momentum / sgd); bf16 moments have "
            "no flat kernel")
    return flat


def _empty_state(cfg, n_agents, optimizer, outer: bool, device) -> TrainState:
    layout = ParamLayout(cfg)
    dtype = torch_dtype(cfg.param_dtype)
    shape = (n_agents, layout.n)
    params = torch.empty(shape, dtype=dtype, device=device)
    flat = _flat_of(optimizer)
    state = TrainState(layout=layout, params=params,
                       grads=torch.zeros(shape, dtype=dtype, device=device),
                       opt=flat.init(params), flat_opt=flat)
    if outer:
        state.anchor = torch.empty(shape, dtype=dtype, device=device)
        state.outer_m = torch.zeros(shape, dtype=torch.float32, device=device)
    return state


def init_train_state(cfg, seed: int, n_agents: int, optimizer: Optimizer,
                     fed: FedTrainConfig, *, device="cuda") -> TrainState:
    """Every agent starts from the same seeded parameters
    (``repro_torch.models.init_params(cfg, seed)``: the port's generator,
    not the JAX package's numbers; carry those with
    :func:`train_state_from_jax`), zero moments, the anchor at the start."""
    dev = dispatch.resolve_device(device)
    state = _empty_state(cfg, n_agents, optimizer, fed.outer_momentum > 0,
                         dev)
    params = init_params(cfg, seed, device=dev)
    for o, _, path in state.layout.pieces:
        node = params
        for k in path:
            node = node[k]
        state.params[0, o:o + node.numel()].copy_(node.reshape(-1))
    state.params[1:].copy_(state.params[:1].expand(n_agents - 1, -1))
    if state.anchor is not None:
        state.anchor.copy_(state.params)
    return state


def train_state_from_jax(cfg, state, *, optimizer: Optional[Optimizer] = None,
                         device="cuda") -> TrainState:
    """The port's train state from a JAX one (``repro.launch.fedtrain
    .init_train_state`` or a state after steps, as numpy arrays or a JAX
    checkpoint restored by ``repro_torch.checkpoint.restore``):
    agent-stacked ``params``, ``opt`` (``m`` / ``v`` / ``t`` of adamw,
    ``m`` of momentum, ``()`` of sgd), ``step`` and, when present,
    ``anchor`` / ``outer_m``. ``optimizer`` (default ``adamw()``) names the
    flat update the state feeds."""
    from repro_torch.optim.optimizers import adamw
    dev = dispatch.resolve_device(device)
    optimizer = optimizer or adamw()
    outer = "anchor" in state
    n_agents = int(np.shape(_jax_paths(state["params"])[0][1])[0])
    st = _empty_state(cfg, n_agents, optimizer, outer, dev)
    st.layout.ravel(state["params"], st.params)
    opt = state.get("opt") or {}
    for ours, theirs in (("mu", "m"), ("nu", "v")):
        if ours in st.opt:
            st.layout.ravel(opt[theirs], st.opt[ours])
    if "t" in st.opt:
        t = np.asarray(opt["t"]).reshape(-1)      # one count per agent
        if np.any(t != t[0]):
            raise ValueError(f"train_state_from_jax: the agents' Adam step "
                             f"counts differ: {t}")
        st.opt["t"] = int(t[0])
    st.step = int(np.asarray(state["step"]))
    if outer:
        st.layout.ravel(state["anchor"], st.anchor)
        st.layout.ravel(state["outer_m"], st.outer_m)
    return st


def train_state_to_tree(state: TrainState) -> dict:
    """The JAX package's train-state tree of ``state``, as views of its
    buffers: what ``repro.launch.fedtrain`` carries and
    ``repro.checkpoint`` saves."""
    L = state.layout
    f = state.flat_opt
    if f.kind == "adam":
        opt = {"m": L.jax_tree(state.opt["mu"]), "v": L.jax_tree(state.opt["nu"]),
               "t": torch.full((state.n_agents,), state.opt["t"],
                               dtype=torch.int32)}
    elif f.kind == "momentum":
        opt = {"m": L.jax_tree(state.opt["mu"])}
    else:
        opt = ()
    tree = {"params": L.jax_tree(state.params), "opt": opt,
            "step": torch.tensor(state.step, dtype=torch.int32)}
    if state.anchor is not None:
        tree["anchor"] = L.jax_tree(state.anchor)
        tree["outer_m"] = L.jax_tree(state.outer_m)
    return tree


# ----------------------------------------------------------------------------
# Steps
# ----------------------------------------------------------------------------

def grad_norms(state: TrainState) -> torch.Tensor:
    """``(A,)`` fp32: each agent's global gradient norm over the leaves of
    its JAX tree (``tree_l2_norm``: one fp32 ``sum(g * g)`` per leaf, added
    in leaf order)."""
    return torch.stack([tree_l2_norm(state.layout.jax_tree(state.grads[a]))
                        for a in range(state.n_agents)])


def make_local_step(cfg, optimizer: Optimizer, fed: FedTrainConfig,
                    n_agents: int = 1, *, swa_impl=None, wkv_impl=None):
    """Returns ``local_step(state, batch) -> (state, metrics)``.
    ``batch["tokens"]``: ``(A, B, S + 1)`` integer on the state's device;
    an encoder-decoder model's ``batch["frames"]``: ``(A, B, F, d)``.
    Each agent's loss and gradient, its clip factor ``min(1, clip /
    max(norm, 1e-12))``, then one flat update of all rows at ``lr`` (times
    ``lambda^(j / 2)`` at period offset j for ``decay``). ``metrics``:
    ``{"loss", "grad_norm"}``, the agents' means (0-d fp32). ``swa_impl``
    and ``wkv_impl`` replace the dispatched attention and recurrence (a
    reference run)."""
    check_trainable(cfg)
    flat = _flat_of(optimizer)
    decay_w = _decay_weights(fed)

    def local_step(state: TrainState, batch):
        if state.n_agents != n_agents:
            raise ValueError(f"local_step: state has {state.n_agents} agents,"
                             f" the step {n_agents}")
        losses = []
        for a in range(n_agents):
            row = state.params[a].detach().requires_grad_()
            params = state.layout.model_params(row, state.grads, a)
            loss = lm_loss(cfg, params, {k: v[a] for k, v in batch.items()},
                           swa_impl=swa_impl, wkv_impl=wkv_impl)
            loss.backward()
            losses.append(loss.detach())
        gnorm = grad_norms(state)
        scale = torch.clamp(fed.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        offset = state.step % fed.tau
        lr_scale = decay_w[offset] if fed.strategy == "decay" else \
            torch.tensor(1.0)
        lr = float(torch.tensor(fed.lr, dtype=torch.float32) * lr_scale)
        _, state.opt = flat.update(state.params, state.grads, scale,
                                   state.opt, lr, inplace=True)
        state.step += 1
        return state, {"loss": torch.stack(losses).mean(),
                       "grad_norm": gnorm.mean()}

    return local_step


def make_sync_step(cfg, fed: FedTrainConfig, n_agents: int = 1):
    """Returns ``sync_step(state) -> state``: the strategy's cross-agent
    step on the parameters (``periodic`` / ``sync`` / ``decay``: every row
    set to the fp32 mean of the rows, one ``row_mean``; ``consensus``: the
    rows mixed by ``P^E``, one ``consensus_step``), then, with outer
    momentum, the Nesterov update of the anchor from the synced rows."""
    mix = (torch.from_numpy(_ring_mixing(n_agents, fed.consensus_eps,
                                         fed.consensus_rounds))
           if fed.strategy == "consensus" else None)

    def communicate(state: TrainState) -> None:
        if mix is not None:
            out = dispatch.consensus_mix(state.params, mix.to(
                state.params.device), out=state.grads)
            state.params, state.grads = out, state.params
        else:
            row = dispatch.row_mean(state.params)
            state.params.copy_(row.expand_as(state.params))

    def sync_step(state: TrainState) -> TrainState:
        if state.n_agents != n_agents:
            raise ValueError(f"sync_step: state has {state.n_agents} agents, "
                             f"the step {n_agents}")
        communicate(state)
        if fed.outer_momentum > 0:
            mu = fed.outer_momentum
            for a in range(n_agents):
                for c0 in range(0, state.layout.n, OUTER_CHUNK):
                    cols = slice(c0, c0 + OUTER_CHUNK)
                    anchor = state.anchor[a, cols]
                    delta = anchor.float() - state.params[a, cols].float()
                    m = mu * state.outer_m[a, cols] + delta
                    new_anchor = anchor.float() - (mu * m + delta)
                    state.outer_m[a, cols] = m
                    state.params[a, cols] = new_anchor
                    anchor.copy_(new_anchor)
        return state

    return sync_step
