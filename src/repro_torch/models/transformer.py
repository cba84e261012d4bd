"""Decoder LM of the port (``repro.models.transformer``).

The JAX package groups layers into [head] + [cycles scanned over stacked
params] + [tail]; here the scan over cycles is a Python loop over one
parameter dict per layer (``params["blocks"]``), and :func:`layer_plan` is
kept to read the JAX tree (:func:`params_from_jax`). Block kinds:

* ``wkv`` (slice 4, ``rwkv6-1.6b``): the RWKV6 time-mix and channel-mix,
  the ``ln0`` of the ssm family;
* ``attn`` and ``local`` (slice 5, ``phi4-mini-3.8b`` and
  ``h2o-danube-3-4b``; slice 15, ``gemma-7b``): ``ln1 -> attention -> +``,
  ``ln2 -> dense MLP -> +``, global or sliding-window attention with RoPE;
* ``rglru`` (slice 15, ``recurrentgemma-9b``): ``ln1 -> the Griffin
  recurrent block (models/rglru.py) -> +``, ``ln2 -> dense MLP -> +``.

In an MoE model (slice 20, ``kimi-k2-1t-a32b``, ``arctic-480b``) the
attention blocks of layers from ``first_k_dense`` on take the MoE FFN
(``models/moe.py``) in place of the dense MLP (:func:`ffn_kind`); each
returns its router's load-balance auxiliary, which :func:`forward` sums
in the JAX package's order (head, the cycles, the tail). Such models serve;
:func:`lm_loss` does not train them yet.

Layer patterns may mix kinds (``recurrentgemma-9b``: ``(rglru, rglru,
local)``). A VLM (slice 21, ``internvl2-26b``) is a decoder whose tree
holds a ``projector`` (d, d): :func:`forward` takes the frontend's patch
embeddings ``(B, F, d)``, projects them and puts them before the token
embeddings, so a prefix of F rows sits at positions 0 … F − 1 and the
tokens after it; decoding goes on from position F + S. Encoder-decoder
models (slice 18, ``whisper-small``) run through ``models/encdec.py``:
:func:`init_params`, :func:`params_from_jax`, :func:`param_shapes` and
:func:`count_params` take their tree (``build_encdec_leaf_tree``), and
the decoder-only :func:`forward`, :func:`decode_step` and
:func:`init_decode_state` refuse them.

Modes: ``train`` and ``prefill`` run a whole sequence from an initial state
(both return the final states; attention layers keep a cache only where a
state is given or the mode is not ``train``); ``decode`` runs one token
against the states. A ``train`` forward writes no recurrent state in place:
each layer computes from its initial state and the final states come back
as new tensors (autograd holds the initial ones). Under autograd it
recomputes each scanned layer in the backward when ``cfg.remat``
(``torch.utils.checkpoint``, as the JAX package wraps its cycle body in
``jax.checkpoint``).

The loss (slice 13; every served family since slice 16): :func:`lm_loss`
is next-token cross-entropy over the hidden states, through
:func:`chunked_cross_entropy` (per-chunk recompute, or the logits
materialised when ``n_chunks`` is 0 or does not divide B). Attention
layers train through the differentiable ``swa_attention``, ``wkv`` blocks
through the differentiable ``wkv6`` (forward and backward kernels on the
card), ``rglru`` blocks by autograd through the plain RG-LRU scan; a VLM
batch's prefix rows are dropped before the loss. MoE models raise
``NotImplementedError`` there; encoder-decoder models train through
``encdec.encdec_loss``.

The decode state of a one-kind pattern is one dict for all layers, each
leaf stacked over them (the JAX package's ``state["cycles"][0]``):

* ``wkv``: ``{"tm": {"shift": (L, B, d), "wkv": (L, B, H, hd, hd) fp32},
  "cm_shift": (L, B, d)}``, zeros;
* ``attn`` / ``local``: ``{"cache": {"k": (L, B, W, KV, hd), "v": ...,
  "pos": (L, B, W) int32}}``, K/V zeros and ``pos`` -1 (empty slots), with
  W = ``min(window, max_seq)`` for ``local`` and ``max_seq`` for ``attn``;
* ``rglru``: ``{"rec": {"h": (L, B, W) fp32, "conv": (L, B, K - 1, W)}}``,
  zeros.

A mixed pattern keeps one such stack per block kind, over that kind's
layers only, keyed by the kind: ``{"rglru": {"rec": ...}, "local":
{"cache": ...}}``; layer i's entry is :func:`state_index` (``(kind, j)``:
the j-th layer of its kind). The batch axis is axis 1 of every leaf in
both layouts, so a slot's rows are views of each leaf.

In place: :func:`forward` (with ``states`` given, in ``prefill`` or
``decode`` mode) and :func:`decode_step` write the new states over the
states they are given and return that same dict: a prefill fills each
layer's cache and a decode step writes one ring slot; a recurrent layer's
final state (``wkv``: the WKV state and both shift carries; ``rglru``: its
``h`` and conv inputs) is copied over its views once the block has run.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import attention as at
from repro_torch.models import moe
from repro_torch.models import rglru as rg
from repro_torch.models import rwkv6 as rw
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    embed,
    init_embedding,
    init_mlp,
    init_norm,
    mk,
    torch_dtype,
    unembed,
)

# ----------------------------------------------------------------------------
# Layer plan
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerPlan:
    head: tuple          # absolute layer indices, unrolled
    cycle_kinds: tuple   # block kinds within one scanned cycle
    n_cycles: int
    tail: tuple          # absolute layer indices, unrolled


def layer_plan(cfg) -> LayerPlan:
    head = tuple(range(cfg.first_k_dense)) if cfg.family == "moe" else ()
    start = len(head)
    cyc = len(cfg.layer_pattern)
    remaining = cfg.n_layers - start
    n_cycles = remaining // cyc if cfg.scan_layers else 0
    tail_start = start + n_cycles * cyc
    tail = tuple(range(tail_start, cfg.n_layers))
    return LayerPlan(head, cfg.layer_pattern, n_cycles, tail)


def ffn_kind(cfg, layer_idx: int) -> str:
    """``moe`` for an MoE model's layers from ``first_k_dense`` on, else
    ``dense``."""
    if cfg.family == "moe" and layer_idx >= cfg.first_k_dense:
        return "moe"
    return "dense"


def check_decoder_only(cfg, fn: str) -> None:
    """Raise ``NotImplementedError`` where a decoder-only entry point is
    given an encoder-decoder model, naming where that model runs."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{fn}: {cfg.name} is an encoder-decoder model; it runs through "
            f"repro_torch.models.encdec (encdec_forward, encdec_decode_step) "
            f"and the serve steps, and has no ServingLoop (nor has the JAX "
            f"package)")


def padded_vocab(cfg) -> int:
    return -(-cfg.vocab_size // 128) * 128


# ----------------------------------------------------------------------------
# Parameters
# ----------------------------------------------------------------------------

def _init_block(gen, cfg, kind: str, ffn: str, cast: Callable) -> dict:
    """One block's leaves; an ``moe`` FFN casts its expert leaves slice by
    slice as they are drawn (``moe.init_moe``)."""
    d = cfg.d_model
    if kind == "wkv":
        return {"ln1": init_norm(gen, d, cfg.norm),
                "tm": rw.init_time_mix(gen, cfg),
                "ln2": init_norm(gen, d, cfg.norm),
                "cm": rw.init_channel_mix(gen, cfg)}
    p = {"ln1": init_norm(gen, d, cfg.norm)}
    if kind == "rglru":
        p["rec"] = rg.init_rglru_block(gen, cfg)
    else:
        p["attn"] = at.init_attention(gen, cfg)
    p["ln2"] = init_norm(gen, d, cfg.norm)
    if ffn == "moe":
        p["moe"] = moe.init_moe(gen, cfg, cast=cast)
    else:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.activation)
    return p


def _build_tree(cfg, gen, cast: Callable = lambda t: t) -> dict:
    """The parameter tree drawn from ``gen`` leaf by leaf in a fixed order;
    each top-level entry and each block goes through ``cast`` as soon as it
    is drawn (an MoE block's expert leaves slice by slice within it). An
    encoder-decoder model's is ``build_encdec_leaf_tree``'s, as
    the JAX package's ``_build_leaf_tree`` routes it. A vision model's
    ``projector`` (d, d), std 0.02, is drawn after ``ln0``'s place and
    before the blocks, as JAX draws it from the key after ``ln0``'s."""
    if cfg.is_encoder_decoder:
        from repro_torch.models.encdec import build_encdec_leaf_tree
        return build_encdec_leaf_tree(cfg, gen, cast=cast)
    d, vp = cfg.d_model, padded_vocab(cfg)
    part = lambda t: tree_map(cast, t)
    p: dict = {"embed": part(init_embedding(gen, vp, d)),
               "final_norm": part(init_norm(gen, d, cfg.norm))}
    if not cfg.tie_embeddings:
        p["unembed"] = part({"w": mk(gen, (d, vp), std=0.02)})
    if cfg.family == "ssm":
        p["ln0"] = part(init_norm(gen, d, cfg.norm))
    if cfg.frontend == "vision":
        p["projector"] = part({"w": mk(gen, (d, d), std=0.02)})
    p["blocks"] = [part(_init_block(gen, cfg, cfg.block_kind(i),
                                    ffn_kind(cfg, i), cast))
                   for i in range(cfg.n_layers)]
    return p


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def param_shapes(cfg) -> dict:
    """The parameter tree with ``meta`` tensors: shapes, no storage."""
    return _build_tree(cfg, None)


def count_params(params) -> int:
    """Parameters in a tree (counted from the tree, not ``cfg.n_params()``,
    which miscounts RWKV blocks and leaves out the norms' and the padded
    vocabulary's rows)."""
    return sum(int(t.numel()) for t in tree_leaves(params))


def init_params(cfg, seed: int = 0, device="cuda") -> dict:
    """Seeded random parameters in ``cfg.param_dtype`` on ``device``: one
    ``torch.Generator`` on that device, drawn leaf by leaf in a fixed order
    (embed, final norm, unembed, ln0, projector, then each block). Not
    the JAX package's numbers (another generator); carry those with
    :func:`params_from_jax`. Leaves are drawn in fp32 and cast as soon as
    their entry (a block, the embedding) is drawn, so the fp32 draw alive
    at once is one entry (the embedding, at full width), not the tree; an
    MoE block's expert leaves are cast ``moe.EXPERTS_PER_DRAW`` experts at
    a time (a kimi-k2 expert leaf alone is 22.5 GB of fp32)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dtype = torch_dtype(cfg.param_dtype)
    return _build_tree(cfg, gen, cast=lambda t: t.to(dtype))


def _as_tensor(a, dtype, device) -> torch.Tensor:
    a = np.array(a)                          # a writable copy
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        # ml_dtypes' bfloat16, or the raw 2-byte records a checkpoint holds
        # for it (numpy has no bfloat16 of its own)
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _unstack_jax_blocks(cfg, tree, want) -> dict:
    """A decoder-only JAX tree with the top-level entries of ``want`` and
    its layers as ``blocks``, one dict per layer (``head_blocks``, the
    unstacked ``cycles``, ``tail_blocks``)."""
    plan = layer_plan(cfg)
    blocks: List[Optional[dict]] = [None] * cfg.n_layers
    for i, li in enumerate(plan.head):
        blocks[li] = tree["head_blocks"][i]
    cycles = tree.get("cycles") or []
    if plan.n_cycles and len(cycles) != len(plan.cycle_kinds):
        raise ValueError(f"params_from_jax: 'cycles' has {len(cycles)} "
                         f"entries, the pattern {len(plan.cycle_kinds)}")
    for c in range(plan.n_cycles):
        for j in range(len(plan.cycle_kinds)):
            li = len(plan.head) + c * len(plan.cycle_kinds) + j
            blocks[li] = tree_map(lambda a, c=c: np.asarray(a)[c], cycles[j])
    for i, li in enumerate(plan.tail):
        blocks[li] = tree["tail_blocks"][i]
    src = {k: tree.get(k) for k in want if k != "blocks"}
    src["blocks"] = blocks
    return src


def params_from_jax(cfg, tree, device="cuda") -> dict:
    """The port's parameters from the JAX package's ``init_params`` tree as
    numpy arrays, or from a JAX-saved checkpoint of it
    (``repro_torch.checkpoint.restore``).

    ``cycles`` is unstacked: it holds one entry per ``layer_pattern``
    element whose leaves carry a leading ``n_cycles`` axis; cycle c's entry
    j is layer ``len(head) + c * len(pattern) + j``. Floating leaves are
    cast to ``cfg.param_dtype`` (bfloat16 arrays are carried bit for bit).
    Every leaf's shape is checked against the port's tree. An
    encoder-decoder tree keeps its layout (``enc_blocks`` and
    ``dec_blocks`` stacked over layers, as in JAX).
    """
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    want = param_shapes(cfg)
    src = (tree if cfg.is_encoder_decoder
           else _unstack_jax_blocks(cfg, tree, want))

    def carry(w, a, path):
        if isinstance(w, dict):
            if not isinstance(a, dict) or set(a) != set(w):
                raise ValueError(f"params_from_jax: {path or 'root'} has keys "
                                 f"{sorted(a) if isinstance(a, dict) else a}, "
                                 f"expected {sorted(w)}")
            return {k: carry(w[k], a[k], f"{path}/{k}") for k in w}
        if isinstance(w, list):
            return [carry(x, y, f"{path}/{i}") for i, (x, y) in
                    enumerate(zip(w, a))]
        if tuple(np.shape(a)) != tuple(w.shape):
            raise ValueError(f"params_from_jax: {path} has shape "
                             f"{tuple(np.shape(a))}, expected {tuple(w.shape)}")
        return _as_tensor(a, dtype, dev)

    return carry(want, src, "")


# ----------------------------------------------------------------------------
# Stream state
# ----------------------------------------------------------------------------

def state_kinds(cfg) -> tuple:
    """The block kinds of ``cfg.layer_pattern``, each once, in order."""
    return tuple(dict.fromkeys(cfg.layer_pattern))


def state_index(cfg) -> List[tuple]:
    """Where layer i's decode state lives: ``(None, i)`` in a one-kind
    layout, ``(kind, j)`` in a mixed one, j counting the layers of that
    kind before it."""
    if len(state_kinds(cfg)) == 1:
        return [(None, i) for i in range(cfg.n_layers)]
    seen: dict = {}
    out = []
    for i in range(cfg.n_layers):
        kind = cfg.block_kind(i)
        out.append((kind, seen.get(kind, 0)))
        seen[kind] = seen.get(kind, 0) + 1
    return out


def _kind_state(cfg, kind: str, batch: int, max_seq: int, dtype,
                mode: str) -> dict:
    """One layer's initial state (``meta`` tensors: shapes and dtypes)."""
    if kind == "wkv":
        return rw.init_wkv_state(cfg, batch, dtype, device="meta")
    if kind == "rglru":
        return {"rec": rg.init_rglru_state(cfg, batch, dtype, device="meta")}
    if mode == "train":
        return {}
    if max_seq < 1:
        raise ValueError(f"init_decode_state: attention layers need "
                         f"max_seq >= 1, got {max_seq}")
    return {"cache": at.init_kv_cache(cfg, batch, kind, max_seq, dtype,
                                      device="meta")}


def init_decode_state(cfg, batch: int, max_seq: int = 0, dtype=None,
                      mode: str = "decode", device="cuda") -> dict:
    """Initial states for ``batch`` streams, every leaf stacked over the
    layers of its kind (see the module docstring). ``dtype`` (default
    ``cfg.compute_dtype``) is that of the shift carries, the conv inputs
    and the KV cache; the WKV and RG-LRU states are fp32. Attention layers
    hold a cache of ``min(window, max_seq)`` slots (``max_seq`` for global
    attention), none in ``train`` mode; recurrent states ignore ``max_seq``
    and ``mode``."""
    check_decoder_only(cfg, "init_decode_state")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.compute_dtype) if dtype is None else dtype
    kinds = state_kinds(cfg)

    def stack(kind, n):
        return tree_map(
            lambda t: torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                  device=dev),
            _kind_state(cfg, kind, batch, max_seq, dtype, mode))

    if len(kinds) == 1:
        return reset_state(stack(kinds[0], cfg.n_layers))
    index = state_index(cfg)
    return reset_state({
        kind: stack(kind, sum(k == kind for k, _ in index)) for kind in kinds})


def reset_state(states: dict) -> dict:
    """Every leaf of ``states`` (or of a view of some of its rows) back to
    its initial value, in place: -1 for the caches' ``pos`` (an empty slot),
    zero for everything else."""
    for key, t in states.items():
        if isinstance(t, dict):
            reset_state(t)
        else:
            t.fill_(-1 if key == "pos" else 0)
    return states


def layer_state(states: dict, i: int) -> dict:
    """Entry ``i`` of stacked leaves, as views (in a one-kind layout, layer
    ``i``'s state; see :func:`state_index`)."""
    return tree_map(lambda t: t[i], states)


# ----------------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------------

def _apply_block(p, x, cfg, kind, st, *, positions, pos, wkv_impl,
                 swa_impl):
    """One block: ``(x, new, aux)``. ``pos`` (B,) is given for a decode
    step, ``positions`` (B, S) otherwise. A recurrent block only reads
    ``st`` (one layer's views) and returns its new state in ``new`` as new
    tensors; an attention block returns ``new`` None (its cache, where it
    has one, is written in place). ``aux`` is the MoE FFN's load-balance
    auxiliary (0-d fp32), None for a dense FFN and in a decode step."""
    xa = apply_norm(p["ln1"], x, cfg.norm)
    new = None
    if kind == "wkv":
        y, tm = rw.time_mix(p["tm"], xa, cfg, st["tm"], wkv_impl=wkv_impl)
        x = x + y
        xb = apply_norm(p["ln2"], x, cfg.norm)
        y2, cm_shift = rw.channel_mix(p["cm"], xb, cfg, st["cm_shift"])
        return x + y2, {"tm": tm, "cm_shift": cm_shift}, None
    if kind == "rglru":
        y, rec = rg.apply_rglru_block(p["rec"], xa, cfg, st["rec"])
        new = {"rec": rec}
    elif pos is not None:
        y, _ = at.attention_decode(p["attn"], xa, st["cache"], cfg, kind=kind,
                                   pos=pos)
    elif "cache" in st:
        y, _ = at.attention_prefill(
            p["attn"], xa, cfg, kind=kind, positions=positions,
            cache_len=st["cache"]["k"].shape[1], out=st["cache"],
            swa_impl=swa_impl)
    else:
        y = at.attention(p["attn"], xa, cfg, kind=kind, positions=positions,
                         swa_impl=swa_impl)
    x = x + y
    xb = apply_norm(p["ln2"], x, cfg.norm)
    if "moe" in p:
        y, aux = moe.apply_moe(p["moe"], xb, cfg, with_aux=pos is None)
        return x + y, new, aux
    return x + apply_mlp(p["mlp"], xb, cfg.activation), new, None


def remat_layers(cfg) -> range:
    """The layers the JAX package scans (``cycles``): those it recomputes in
    the backward when ``cfg.remat``."""
    plan = layer_plan(cfg)
    start = len(plan.head)
    return range(start, start + plan.n_cycles * len(plan.cycle_kinds))


def _stack_trees(trees):
    """Equal-structured dicts of tensors -> one dict, each leaf stacked."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _write_tree(dst, src) -> None:
    """Copy each leaf of ``src`` over the same leaf of ``dst``."""
    for k, v in src.items():
        if isinstance(v, dict):
            _write_tree(dst[k], v)
        else:
            dst[k].copy_(v)


def _aux_total(cfg, aux: list) -> Optional[torch.Tensor]:
    """The layers' auxiliaries (None for a dense FFN) summed in the JAX
    package's order: from an fp32 zero, each head layer's, then the sum over
    cycles of each cycle's sum (from zero, in pattern order), then each tail
    layer's. None where no layer returned one."""
    if all(a is None for a in aux):
        return None
    zero = torch.zeros((), dtype=torch.float32, device=next(
        a for a in aux if a is not None).device)
    val = lambda i: zero if aux[i] is None else aux[i]
    plan = layer_plan(cfg)
    total = zero
    for li in plan.head:
        total = total + val(li)
    if plan.n_cycles:
        cyc, start = len(plan.cycle_kinds), len(plan.head)
        per = []
        for c in range(plan.n_cycles):
            acc = zero
            for j in range(cyc):
                acc = acc + val(start + c * cyc + j)
            per.append(acc)
        total = total + torch.stack(per).sum()
    for li in plan.tail:
        total = total + val(li)
    return total


def _run_layers(cfg, params, x, states, *, positions=None, pos=None,
                wkv_impl=None, swa_impl=None, remat=False, inplace=True):
    """The blocks over ``x``: ``(x, states, aux)``. With ``inplace``
    (prefill, decode) each recurrent layer's new state is written over its
    views of ``states``, which is returned; without it (training)
    ``states`` is only read and a new dict comes back, its recurrent leaves
    the layers' new states stacked (new tensors). ``aux`` is the sum of
    the MoE layers' auxiliaries (:func:`_aux_total`; None without MoE and
    in a decode step)."""
    if len(params["blocks"]) != cfg.n_layers:
        raise ValueError(f"params hold {len(params['blocks'])} blocks, the "
                         f"config {cfg.n_layers} layers")
    recompute = remat_layers(cfg) if remat else ()
    index = state_index(cfg)
    new, aux = {}, []
    for i, p in enumerate(params["blocks"]):
        kind, j = index[i]
        st = layer_state(states if kind is None else states[kind], j)
        run = lambda x_, p=p, i=i, st=st: _apply_block(
            p, x_, cfg, cfg.block_kind(i), st, positions=positions, pos=pos,
            wkv_impl=wkv_impl, swa_impl=swa_impl)
        x, n, a = checkpoint(run, x, use_reentrant=False) \
            if i in recompute else run(x)
        aux.append(a)
        if n is None:
            continue
        if inplace:
            _write_tree(st, n)
        else:
            new.setdefault(kind, []).append(n)
    aux = _aux_total(cfg, aux)
    if inplace or not new:
        return x, states, aux
    out = dict(states)
    for kind, layers in new.items():
        if kind is None:
            out.update(_stack_trees(layers))
        else:
            out[kind] = {**states[kind], **_stack_trees(layers)}
    return x, out, aux


def _embed_in(cfg, params, tokens, embeds=None):
    """Token embeddings in the compute dtype; with ``embeds`` (B, F, d),
    the projected prefix before them (JAX ``forward``'s order: cast, the
    projector where the tree has one, concatenate, then ``ln0``)."""
    scale = cfg.d_model ** 0.5 if cfg.tie_embeddings else None
    dtype = torch_dtype(cfg.compute_dtype)
    x = embed(params["embed"], tokens, scale=scale).to(dtype)
    if embeds is not None:
        prefix = embeds.to(dtype)
        if "projector" in params:
            prefix = prefix @ params["projector"]["w"].to(dtype)
        x = torch.cat([prefix, x], dim=1)
    if "ln0" in params:
        x = apply_norm(params["ln0"], x, cfg.norm)
    return x


def lm_head(cfg, params, x):
    """fp32 logits of hidden states ``x`` (after the final norm)."""
    if cfg.tie_embeddings:
        return unembed(params["embed"], x).float()
    return (x @ params["unembed"]["w"]).float()


def forward(cfg, params, tokens: torch.Tensor, *, embeds=None,
            mode: str = "train", states: Optional[dict] = None,
            unembed_out: bool = True, wkv_impl: Optional[Callable] = None,
            swa_impl: Optional[Callable] = None):
    """tokens: (B, S) integer. ``embeds``: an optional (B, F, d) prefix
    (the VLM stub frontend's patch embeddings), projected and put before
    the tokens. The T = F + S rows sit at positions 0..T-1. Returns
    ``(logits (B, T, V) fp32`` — or the final hidden states when
    ``unembed_out=False`` — ``, states, aux)``.

    ``states`` (default: :func:`init_decode_state` for ``mode`` with
    ``max_seq`` = T) are updated in place and returned: the WKV states
    advance, the KV caches are filled from the sequence. In ``train`` mode
    under autograd with ``cfg.remat`` the scanned layers are recomputed in
    the backward (:func:`remat_layers`). ``aux`` (0-d fp32) is the sum of
    the MoE layers' load-balance auxiliaries in the JAX package's order, 0
    for a model without MoE. ``wkv_impl`` replaces the dispatched
    recurrence in every ``wkv`` block (see ``rwkv6.time_mix``), ``swa_impl``
    the dispatched attention in every attention block (see
    ``attention.attention``). ``mode`` picks the default states only.
    """
    check_decoder_only(cfg, "forward")
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if cfg.wkv_impl == "chunked" and tokens.shape[1] > 1:
        raise NotImplementedError(
            "wkv_impl='chunked' (the JAX matmul form wkv_chunked) is not "
            "ported; the port runs the wkv6 kernel (wkv_impl='scan')")
    x = _embed_in(cfg, params, tokens, embeds)
    b, s = x.shape[:2]
    if states is None:
        states = init_decode_state(cfg, b, max_seq=s, mode=mode,
                                   device=x.device)
    positions = torch.arange(s, device=x.device).expand(b, s)
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    x, states, aux = _run_layers(cfg, params, x, states, positions=positions,
                                 wkv_impl=wkv_impl, swa_impl=swa_impl,
                                 remat=remat, inplace=mode != "train")
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if not unembed_out:
        return x, states, aux
    return lm_head(cfg, params, x), states, aux


def prefill(cfg, params, tokens: torch.Tensor, *, embeds=None,
            cache_len: Optional[int] = None,
            wkv_impl: Optional[Callable] = None,
            swa_impl: Optional[Callable] = None):
    """The prompt (after the ``embeds`` prefix, if any) through the sequence
    path from an initial state: ``(logits (B, F + S, V), states)``, the KV
    caches sized for ``cache_len`` (default F + S) positions."""
    b, s = tokens.shape
    total = s + (embeds.shape[1] if embeds is not None else 0)
    states = init_decode_state(cfg, b, max_seq=cache_len or total,
                               mode="prefill",
                               device=tokens.device)
    logits, states, _ = forward(cfg, params, tokens, embeds=embeds,
                                mode="prefill", states=states,
                                wkv_impl=wkv_impl, swa_impl=swa_impl)
    return logits, states


def decode_step(cfg, params, token: torch.Tensor, states: dict,
                pos: torch.Tensor, *, wkv_impl: Optional[Callable] = None):
    """token: (B, 1) integer; pos: (B,) absolute positions of the tokens
    (read by the rotary embedding and the cache write; the WKV recurrence
    does not read them). One serve step: ``(logits (B, 1, V) fp32,
    states)``, ``states`` updated in place."""
    check_decoder_only(cfg, "decode_step")
    if token.ndim != 2 or token.shape[1] != 1:
        raise ValueError(f"decode_step: token must be (B, 1), got "
                         f"{tuple(token.shape)}")
    if tuple(pos.shape) != (token.shape[0],):
        raise ValueError(f"decode_step: pos must be ({token.shape[0]},), got "
                         f"{tuple(pos.shape)}")
    x = _embed_in(cfg, params, token)
    x, states, _ = _run_layers(cfg, params, x, states,
                               positions=pos[:, None], pos=pos,
                               wkv_impl=wkv_impl)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return lm_head(cfg, params, x), states



# ----------------------------------------------------------------------------
# Loss
# ----------------------------------------------------------------------------

def check_trainable(cfg) -> None:
    """Raise ``NotImplementedError`` for models :func:`lm_loss` cannot train
    yet: MoE models (served since slice 20). An encoder-decoder model
    trains through ``encdec.encdec_loss``, a VLM with its patch embeddings
    in the batch."""
    if cfg.family == "moe":
        raise NotImplementedError(
            "MoE models (kimi-k2, arctic) serve; their training, with the "
            "router's auxiliary loss in lm_loss, comes with a later slice")


def lm_loss(cfg, params, batch, *, ce_chunks: Optional[int] = None,
            swa_impl: Optional[Callable] = None,
            wkv_impl: Optional[Callable] = None) -> torch.Tensor:
    """Next-token cross-entropy (0-d fp32). ``batch``: ``{'tokens': (B, S)}``
    integer, for a VLM ``'patch_embeds': (B, F, d)`` (the prefix; its F
    hidden rows are dropped before the loss, as in JAX) and for an
    encoder-decoder model ``'frames': (B, F, d)``; the model reads
    ``tokens[:, :-1]`` and predicts ``tokens[:, 1:]``. An
    encoder-decoder model goes to ``encdec.encdec_loss``, which reads
    ``cfg.ce_chunks`` alone, as in JAX. Otherwise ``ce_chunks`` (default
    ``cfg.ce_chunks``, as JAX's ``ce_chunks or cfg.ce_chunks``) picks
    :func:`chunked_cross_entropy`'s branch;
    ``swa_impl`` and ``wkv_impl`` replace the dispatched attention and
    recurrence (see :func:`forward`)."""
    check_trainable(cfg)
    if cfg.is_encoder_decoder:
        from repro_torch.models.encdec import encdec_loss
        return encdec_loss(cfg, params, batch, swa_impl=swa_impl)
    if batch.get("frames") is not None:
        raise NotImplementedError("frames feed an encoder-decoder model; "
                                  f"{cfg.name} is decoder-only")
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    embeds = batch.get("patch_embeds")
    hidden, _, _ = forward(cfg, params, inputs, embeds=embeds, mode="train",
                           unembed_out=False, swa_impl=swa_impl,
                           wkv_impl=wkv_impl)
    if embeds is not None:
        hidden = hidden[:, embeds.shape[1]:]
    w = (params["embed"]["table"].T if cfg.tie_embeddings
         else params["unembed"]["w"])
    return chunked_cross_entropy(hidden, w, targets,
                                 n_chunks=ce_chunks or cfg.ce_chunks)


def _ce_sum(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position ``logsumexp - target logit`` of fp32 logits."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return lse - tgt


def sharded_cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                          ) -> torch.Tensor:
    """Mean CE of ``(B, S, V)`` logits, in fp32. The JAX package contracts
    a one-hot so that a model-parallel vocab axis stays sharded; the
    gathered target logit is the same number."""
    return _ce_sum(logits.float(), targets).mean()


def _chunk_ce(h_c, w, t_c):
    return torch.sum(_ce_sum((h_c @ w).float(), t_c))


def chunked_cross_entropy(hidden: torch.Tensor, w_unembed: torch.Tensor,
                          targets: torch.Tensor, n_chunks: int = 0
                          ) -> torch.Tensor:
    """CE without the full ``(B, S, V)`` logits: B split into ``n_chunks``
    chunks whose logits are recomputed in the backward
    (``torch.utils.checkpoint``), their fp32 sums added in order and divided
    by the target count. ``n_chunks`` 0, or one that does not divide B,
    materialises the logits (:func:`sharded_cross_entropy`)."""
    if not n_chunks or hidden.shape[0] % n_chunks:
        return sharded_cross_entropy(hidden @ w_unembed, targets)
    b = hidden.shape[0]
    hb = hidden.reshape(n_chunks, b // n_chunks, *hidden.shape[1:])
    tb = targets.reshape(n_chunks, b // n_chunks, *targets.shape[1:])
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        total = total + checkpoint(_chunk_ce, hb[c], w_unembed, tb[c],
                                   use_reentrant=False)
    return total / targets.numel()
