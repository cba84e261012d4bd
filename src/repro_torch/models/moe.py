"""Mixture-of-Experts FFN of the port (``repro.models.moe``): top-k routing
with a per-group expert capacity, as the JAX package computes it.

Tokens are split into groups (:func:`group_tokens`); within a group each
expert takes at most C = ``max(1, int(S_g * k / E * capacity_factor))``
(token, slot) assignments, and the overflow is dropped (the token keeps
its residual path and its other slots). :func:`route` reads the routing:

* the router logits ``x_g @ router`` in the compute dtype, then fp32, and
  their softmax;
* the top k by a stable descending sort: among equal probabilities the
  lower expert comes first, the order of ``jax.lax.top_k`` (a zero padding
  row gives E equal probabilities; bf16 logits tie often);
* the k weights renormalised to sum 1 *before* any drop, so a token that
  loses a slot keeps a total weight below 1;
* each (token, slot)'s position in its expert: the number of earlier
  assignments to that expert in token-major order (token s, slot j comes
  after every slot of the tokens before s and the slots before j of s),
  kept where it is below C.

Dispatch and combine work by index, without the JAX package's ``(G, S, E,
C)`` one-hots: each kept (token, slot) row is gathered into an ``(E, G *
C, d)`` buffer (empty slots zero; the dispatch one-hot is 0 / 1, so the
gather is the einsum exactly), the expert FFN is one batched product over E
(``torch.bmm``), and each token's at most k outputs are weighted by their
combine weights rounded to the compute dtype (as JAX casts ``combine``),
added in fp32 and cast once. Empty slots run through the FFN as JAX's do
(``0 * FFN(0)`` adds nothing); no expert is skipped.

Variants: shared experts (``kimi-k2``), an always-on MLP of width
``expert_d_ff * n_shared_experts`` added to the routed output; a dense
residual (``arctic``), an MLP of width ``d_ff`` added beside it. Both take
the ungrouped ``x``.

The load-balance auxiliary (Switch eq. 4) is ``E * sum_e f_e P_e``, with
``f_e`` the share of rows whose top-1 slot is e and ``P_e`` the mean
probability, both over the padded rows too, as JAX averages them.

One device: the JAX package caps the group at the per-shard sequence when
the ``seq`` axis is sharded. Outside a sharding-rules context that axis
has size 1, so there the group is S whenever S < ``moe_group_size`` (each
sequence its own group; a decode step, S = 1, routes every token alone,
C = 1, and nothing drops) and ``moe_group_size`` tokens of the flattened
(b, s) order from there on, the last group padded with zero rows. The port
has no mesh and always groups so.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_mlp, init_mlp, mk

# Experts drawn at a time by init_moe: a kimi-k2 expert leaf is 5.64 G
# fp32 elements (22.5 GB), so each leaf is drawn and cast in slices of this
# many experts (under ~2.3 GB of fp32 at kimi's and arctic's widths).
EXPERTS_PER_DRAW = 16


def _mk_experts(gen, shape, std: float = 0.02,
                cast: Callable = lambda t: t) -> torch.Tensor:
    """One ``(E, ...)`` expert leaf drawn from ``gen`` ``EXPERTS_PER_DRAW``
    experts at a time, each slice cast as soon as it is drawn: the fp32
    draw alive at once is one slice, not the leaf. ``gen=None`` gives a
    ``meta`` tensor."""
    if gen is None:
        return mk(None, shape)
    out = None
    for e0 in range(0, shape[0], EXPERTS_PER_DRAW):
        n = min(EXPERTS_PER_DRAW, shape[0] - e0)
        part = cast(mk(gen, (n,) + tuple(shape[1:]), std=std))
        if out is None:
            out = torch.empty(tuple(shape), dtype=part.dtype,
                              device=part.device)
        out[e0:e0 + n] = part
        del part
    return out


def init_moe(gen, cfg, cast: Callable = lambda t: t) -> dict:
    """The JAX package's leaves: ``router (d, E)``, ``w_gate`` / ``w_up``
    (or ``w_in``) ``(E, d, ff)``, ``w_down (E, ff, d)``, and ``shared`` /
    ``residual`` MLPs where the config has them. Expert leaves go through
    ``cast`` slice by slice (:func:`_mk_experts`)."""
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    p = {"router": mk(gen, (d, e), std=0.02),
         "w_down": _mk_experts(gen, (e, ff, d), std=0.02 / max(1, ff) ** 0.5,
                               cast=cast)}
    if cfg.activation in ("swiglu", "geglu"):
        p["w_gate"] = _mk_experts(gen, (e, d, ff), cast=cast)
        p["w_up"] = _mk_experts(gen, (e, d, ff), cast=cast)
    else:
        p["w_in"] = _mk_experts(gen, (e, d, ff), cast=cast)
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, ff * cfg.n_shared_experts,
                               cfg.activation)
    if cfg.dense_residual:
        p["residual"] = init_mlp(gen, d, cfg.d_ff, cfg.activation)
    return p


def group_size_for(cfg, s: int) -> int:
    """The group size ``apply_moe`` asks for at sequence length ``s`` on one
    device: ``s`` when it is below ``moe_group_size``."""
    return s if s < cfg.moe_group_size else cfg.moe_group_size


def group_tokens(x: torch.Tensor, group_size: int):
    """``(B, S, d) -> (G, S_g, d)`` with ``S_g = min(group_size, B * S)``
    over the flattened (b, s) order, the last group padded with zero rows;
    also the number of real tokens."""
    b, s, d = x.shape
    tokens = b * s
    g_sz = min(group_size, tokens)
    pad = (-tokens) % g_sz
    flat = x.reshape(tokens, d)
    if pad:
        flat = F.pad(flat, (0, 0, 0, pad))
    return flat.reshape(-1, g_sz, d), tokens


class Routing(NamedTuple):
    """The routing of ``(G, S_g)`` grouped rows: ``logits`` and ``probs``
    ``(G, S_g, E)`` fp32; ``weights`` ``(G, S_g, k)`` fp32, renormalised
    before the drops; ``experts`` and ``pos`` ``(G, S_g, k)`` int64;
    ``keep`` ``(G, S_g, k)`` bool; ``capacity`` C."""
    logits: torch.Tensor
    probs: torch.Tensor
    weights: torch.Tensor
    experts: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


def route(router: torch.Tensor, xg: torch.Tensor, cfg) -> Routing:
    """Top-k routing of grouped rows ``xg (G, S_g, d)`` (see the module
    docstring). No host synchronisation."""
    g, sg, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = (xg @ router).float()
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = srt.values[..., :k], srt.indices[..., :k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = max(1, int(sg * k / e * cfg.capacity_factor))
    # position in expert: rank of each (token, slot) among its expert's
    # assignments in token-major order, by a stable sort on the expert id
    flat = top_i.reshape(g, sg * k)
    order = torch.sort(flat, dim=1, stable=True).indices
    counts = torch.zeros(g, e, dtype=torch.int64, device=xg.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, 1) - counts
    rank = (torch.arange(sg * k, device=xg.device)
            - starts.gather(1, flat.gather(1, order)))
    pos = torch.empty_like(flat).scatter_(1, order, rank).reshape(g, sg, k)
    return Routing(logits, probs, top_w, top_i, pos, pos < cap, cap)


def _expert_ffn(p: dict, xe: torch.Tensor, activation: str) -> torch.Tensor:
    """``(E, N, d) -> (E, N, d)``: each expert's FFN on its N rows, one
    batched product a matrix."""
    if activation in ("swiglu", "geglu"):
        gate = torch.bmm(xe, p["w_gate"])
        up = torch.bmm(xe, p["w_up"])
        act = (F.silu(gate) if activation == "swiglu"
               else F.gelu(gate, approximate="tanh"))
        h = act * up
    else:
        h = F.gelu(torch.bmm(xe, p["w_in"]), approximate="tanh")
    return torch.bmm(h, p["w_down"])


def apply_moe(p: dict, x: torch.Tensor, cfg, *, with_aux: bool = True):
    """``x (B, S, d) -> (out (B, S, d), aux)``, aux a 0-d fp32 tensor, or
    None without ``with_aux`` (a decode step, which discards it)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    xg, tokens = group_tokens(x, group_size_for(cfg, s))
    g, sg, _ = xg.shape
    r = route(p["router"], xg, cfg)
    cap = r.capacity
    # each (token, slot)'s row in the (E, G * C) buffer; dropped slots go to
    # a spare row past the end (index E * G * C), which is never read
    n_rows = e * g * cap
    gidx = torch.arange(g, device=x.device)[:, None, None]
    dest = torch.where(r.keep, (r.experts * g + gidx) * cap + r.pos,
                       n_rows).reshape(-1)
    rows = g * sg
    src = torch.arange(rows, device=x.device).repeat_interleave(k)
    # dispatch: the buffer row's token (rows: a zero row)
    tok_of = torch.full((n_rows + 1,), rows, dtype=torch.int64,
                        device=x.device)
    tok_of.index_put_((dest,), src)
    xflat = torch.cat([xg.reshape(rows, d), xg.new_zeros(1, d)])
    xe = xflat[tok_of[:n_rows]].reshape(e, g * cap, d)
    ye = _expert_ffn(p, xe, cfg.activation).reshape(n_rows, d)
    # combine: the k products in fp32, in slot order, cast once; a dropped
    # slot reads row 0 at weight 0, as JAX's combine einsum multiplies
    # every buffer row, by 0 where the slot is not the token's
    w = (r.weights * r.keep).to(x.dtype).float().reshape(rows, k)
    dest = torch.where(r.keep.reshape(-1), dest, 0).reshape(rows, k)
    acc = w[:, 0:1] * ye[dest[:, 0]].float()
    for j in range(1, k):
        acc = acc + w[:, j:j + 1] * ye[dest[:, j]].float()
    out = acc.to(x.dtype)[:tokens].reshape(b, s, d)

    aux = None
    if with_aux:
        # Switch-style load balance: E * sum_e f_e * P_e over every group row
        top1 = torch.zeros(e, dtype=torch.int64, device=x.device)
        top1.scatter_add_(0, r.experts[..., 0].reshape(-1),
                          torch.ones(rows, dtype=torch.int64, device=x.device))
        frac_tokens = top1.float() / rows
        frac_probs = r.probs.reshape(-1, e).mean(0)
        aux = e * torch.sum(frac_tokens * frac_probs)

    if cfg.n_shared_experts:
        out = out + apply_mlp(p["shared"], x, cfg.activation)
    if cfg.dense_residual:
        out = out + apply_mlp(p["residual"], x, cfg.activation)
    return out, aux
