"""Whisper-style encoder-decoder (``repro.models.encdec``) [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is a stub, as in the JAX
package: the caller gives frame embeddings ``(B, n_frames, d)`` directly.
Encoder: bidirectional self-attention blocks (``ln1 -> attention -> +``,
``ln2 -> MLP -> +``) over the frames plus sinusoidal positions, then
``enc_norm``. Decoder: causal self-attention, cross-attention over the
encoder output and the MLP, each pre-normed, over the token embeddings plus
sinusoidal positions, then ``final_norm``; the unembedding is the
embedding table's transpose. No RoPE anywhere.

Every full-sequence attention goes through the dispatched ``swa_attention``
(the hand-written kernel on the card, at head size 64 for whisper-small):
the encoder's with ``causal=False`` (Sq = Sk = frames), the decoder's
self-attention causal, and the cross-attention with ``causal=False`` and
Sq != Sk, in training, in prefill and at every decode step. Under autograd
each is :class:`repro_torch.kernels.dispatch.SwaAttention`, whose backward
is the ``swa_attention_bwd`` kernel (JAX's train mode: the
``flash_attention`` custom VJP, its cross-attention through
``cross_attention_flash``). A decode step's self-attention runs over the
ring cache as plain torch (``attention.attention_decode``), as for every
family the port serves.

Parameters keep the JAX tree's layout: ``embed``, ``enc_blocks``,
``enc_norm``, ``dec_blocks``, ``final_norm``, the blocks' leaves stacked
over layers (layer i's parameters are views ``leaf[i]``).

The two state layouts are JAX's. A prefill (``encdec_forward(mode=
"prefill")``) returns ``{"cache": {"k", "v", "pos"}, "cross": {"k", "v"}}``,
each leaf stacked over the decoder layers; a decode step takes
:func:`init_encdec_decode_state`'s ``{"self": {"k", "v", "pos"},
"cross_k", "cross_v"}``. A caller glues them: ``state["self"] =
st["cache"]``, ``state["cross_k"], state["cross_v"] = st["cross"]["k"],
st["cross"]["v"]``. :func:`encdec_decode_step` writes the new token's K/V
into ``state["self"]`` in place and returns the same dict.

Training: :func:`encdec_loss`, teacher-forced next-token cross-entropy
against the embedding table's transpose. Under ``cfg.remat`` with autograd
on, each encoder layer and each decoder layer is recomputed in the
backward (``torch.utils.checkpoint``, as JAX wraps both scans' bodies in
``jax.checkpoint``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import dispatch
from repro_torch.models import attention as at
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    embed,
    init_embedding,
    init_mlp,
    init_norm,
    sinusoidal_for_positions,
    torch_dtype,
    unembed,
)
from repro_torch.models.transformer import (
    _stack_trees,
    chunked_cross_entropy,
    layer_state,
    padded_vocab,
    tree_map,
)


def _enc_block_init(gen, cfg) -> dict:
    d = cfg.d_model
    return {"ln1": init_norm(gen, d, cfg.norm),
            "attn": at.init_attention(gen, cfg),
            "ln2": init_norm(gen, d, cfg.norm),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg.activation)}


def _dec_block_init(gen, cfg) -> dict:
    d = cfg.d_model
    return {"ln1": init_norm(gen, d, cfg.norm),
            "attn": at.init_attention(gen, cfg),
            "ln_x": init_norm(gen, d, cfg.norm),
            "xattn": at.init_attention(gen, cfg, cross=True),
            "ln2": init_norm(gen, d, cfg.norm),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg.activation)}


def build_encdec_leaf_tree(cfg, gen, cast: Callable = lambda t: t) -> dict:
    """The parameter tree in the JAX package's layout, drawn from ``gen``
    (``None``: ``meta`` tensors) in a fixed order: embed, each encoder
    block, enc_norm, each decoder block, final_norm. Each entry and each
    block goes through ``cast`` as soon as it is drawn; the blocks are then
    stacked over layers."""
    d = cfg.d_model
    part = lambda t: tree_map(cast, t)
    p = {"embed": part(init_embedding(gen, padded_vocab(cfg), d))}
    p["enc_blocks"] = _stack_trees([part(_enc_block_init(gen, cfg))
                                    for _ in range(cfg.n_encoder_layers)])
    p["enc_norm"] = part(init_norm(gen, d, cfg.norm))
    p["dec_blocks"] = _stack_trees([part(_dec_block_init(gen, cfg))
                                    for _ in range(cfg.n_layers)])
    p["final_norm"] = part(init_norm(gen, d, cfg.norm))
    return p


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def _remat(cfg) -> bool:
    """Whether layers are recomputed in the backward: ``cfg.remat`` with
    autograd on (nothing is saved for a backward otherwise)."""
    return cfg.remat and torch.is_grad_enabled()


def _enc_block(cfg, p, x, pos, fn):
    """One encoder layer: ``x + attention(ln1 x)``, then ``+ MLP(ln2 x)``;
    the attention bidirectional over the frames."""
    b, f, _ = x.shape
    xa = apply_norm(p["ln1"], x, cfg.norm)
    q, k, v = at._project_qkv(p["attn"], xa, cfg, pos, rope=False)
    o = fn(q, k, v, window=None, causal=False)
    x = x + o.reshape(b, f, cfg.n_heads * cfg.head_dim) @ p["attn"]["wo"]
    xb = apply_norm(p["ln2"], x, cfg.norm)
    return x + apply_mlp(p["mlp"], xb, cfg.activation)


def encode(cfg, params, frames: torch.Tensor, *,
           swa_impl: Optional[Callable] = None) -> torch.Tensor:
    """frames: ``(B, F, d)`` stub embeddings -> encoder output ``(B, F, d)``
    in ``cfg.compute_dtype``. ``swa_impl`` replaces the dispatched
    attention (a function of ``(q, k, v, *, window, causal)``). Each layer
    is recomputed in the backward under ``cfg.remat``."""
    dtype = torch_dtype(cfg.compute_dtype)
    x = frames.to(dtype)
    pos = _positions(x)
    x = x + sinusoidal_for_positions(pos[0], cfg.d_model).to(dtype)
    fn = swa_impl or dispatch.swa_attention
    remat = _remat(cfg)
    for i in range(cfg.n_encoder_layers):
        run = lambda x_, p=layer_state(params["enc_blocks"], i): _enc_block(
            cfg, p, x_, pos, fn)
        x = checkpoint(run, x, use_reentrant=False) if remat else run(x)
    return apply_norm(params["enc_norm"], x, cfg.norm)


def _dec_block(cfg, p, x, attend_self, kv, swa_impl):
    """One decoder layer: ``x + attend_self(ln1 x)``, ``+ cross-attention
    (ln_x x)`` over the cross K/V ``kv``, then ``+ MLP(ln2 x)``."""
    x = x + attend_self(apply_norm(p["ln1"], x, cfg.norm))
    xx = apply_norm(p["ln_x"], x, cfg.norm)
    x = x + at.cross_attention(p["xattn"], xx, *kv, cfg, swa_impl=swa_impl)
    xb = apply_norm(p["ln2"], x, cfg.norm)
    return x + apply_mlp(p["mlp"], xb, cfg.activation)


def _dec_train_block(cfg, p, x, positions, enc_out, swa_impl):
    """A train-mode decoder layer: causal self-attention, the cross K/V of
    ``enc_out`` (inside the layer, so a recomputed layer recomputes them,
    as JAX's checkpointed scan body does)."""
    attend = lambda xa: at.attention(p["attn"], xa, cfg, kind="attn",
                                     positions=positions, swa_impl=swa_impl)
    return _dec_block(cfg, p, x, attend, at.cross_kv(p["xattn"], enc_out, cfg),
                      swa_impl)


def _decoder_layers(cfg, params, x, positions, *, enc_out=None, states=None,
                    mode: str = "train", pos=None, cache_len=None,
                    swa_impl=None):
    """The decoder stack over ``x`` ``(B, S, d)``: ``(x after final_norm,
    new states)``. ``prefill``: new states ``{"cache", "cross"}``, the
    self-attention caches sized ``cache_len`` (default S); ``decode``:
    ``states`` is a decode state, whose ``self`` cache is written in place,
    and the new states are ``{}``; ``train``: ``{}``, each layer recomputed
    in the backward under ``cfg.remat``."""
    b, s, _ = x.shape
    n, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    new: dict = {}
    if mode == "prefill":
        w = cache_len or s
        t = enc_out.shape[1]
        dev = x.device
        new = {"cache": {
            "k": torch.empty((n, b, w, kv, hd), dtype=x.dtype, device=dev),
            "v": torch.empty((n, b, w, kv, hd), dtype=x.dtype, device=dev),
            "pos": torch.empty((n, b, w), dtype=torch.int32, device=dev)},
            "cross": {
            "k": torch.empty((n, b, t, kv, hd), dtype=x.dtype, device=dev),
            "v": torch.empty((n, b, t, kv, hd), dtype=x.dtype, device=dev)}}
    remat = mode == "train" and _remat(cfg)
    for i in range(n):
        p = layer_state(params["dec_blocks"], i)
        if mode == "train":
            run = lambda x_, p=p: _dec_train_block(cfg, p, x_, positions,
                                                   enc_out, swa_impl)
            x = checkpoint(run, x, use_reentrant=False) if remat else run(x)
            continue
        if mode == "decode":
            kv = (states["cross_k"][i], states["cross_v"][i])
            attend = lambda xa: at.attention_decode(
                p["attn"], xa, layer_state(states["self"], i), cfg,
                kind="attn", pos=pos)[0]
        else:
            kv = at.cross_kv(p["xattn"], enc_out, cfg)
            new["cross"]["k"][i], new["cross"]["v"][i] = kv
            attend = lambda xa: at.attention_prefill(
                p["attn"], xa, cfg, kind="attn", positions=positions,
                cache_len=w, out=layer_state(new["cache"], i),
                swa_impl=swa_impl)[0]
        x = _dec_block(cfg, p, x, attend, kv, swa_impl)
    return apply_norm(params["final_norm"], x, cfg.norm), new


def encdec_logits(params, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits of decoder hidden states (after ``final_norm``): the
    embedding table's transpose, unscaled."""
    return unembed(params["embed"], x).float()


def _embed_tokens(cfg, params, tokens, pos):
    dtype = torch_dtype(cfg.compute_dtype)
    x = embed(params["embed"], tokens).to(dtype)
    return x + sinusoidal_for_positions(pos, cfg.d_model).to(dtype)


def encdec_forward(cfg, params, tokens: torch.Tensor, frames: torch.Tensor,
                   mode: str = "train", cache_len: Optional[int] = None,
                   unembed_out: bool = True,
                   swa_impl: Optional[Callable] = None):
    """The decoder over the whole token sequence ``(B, S)`` (positions
    0..S-1), teacher-forced, against the encoder output of ``frames``:
    ``(logits (B, S, V) fp32`` — or the hidden states when
    ``unembed_out=False`` — ``, states)``. ``prefill`` mode also returns
    the self-attention caches (``cache_len`` slots, default S) and the
    cross K/V (see the module docstring); ``train`` returns ``{}``."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"encdec_forward: mode must be 'train' or "
                         f"'prefill', got {mode!r}")
    enc_out = encode(cfg, params, frames, swa_impl=swa_impl)
    positions = _positions(tokens)
    x = _embed_tokens(cfg, params, tokens, positions[0])
    x, states = _decoder_layers(cfg, params, x, positions, enc_out=enc_out,
                                mode=mode, cache_len=cache_len,
                                swa_impl=swa_impl)
    if not unembed_out:
        return x, states
    return encdec_logits(params, x), states


def encdec_loss(cfg, params, batch, *,
                swa_impl: Optional[Callable] = None) -> torch.Tensor:
    """Next-token cross-entropy (0-d fp32) of ``batch = {"tokens": (B, S),
    "frames": (B, F, d)}``: the decoder reads ``tokens[:, :-1]`` against
    the encoder output of ``frames`` and predicts ``tokens[:, 1:]``, the
    logits the embedding table's transpose, through
    ``chunked_cross_entropy`` with ``cfg.ce_chunks``, as in JAX.
    ``swa_impl`` replaces the dispatched attention (a reference run)."""
    tokens, frames = batch["tokens"], batch["frames"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    hidden, _ = encdec_forward(cfg, params, inputs, frames, unembed_out=False,
                               swa_impl=swa_impl)
    return chunked_cross_entropy(hidden, params["embed"]["table"].T, targets,
                                 n_chunks=cfg.ce_chunks)


def init_encdec_decode_state(cfg, batch: int, max_seq: int, n_frames: int,
                             dtype=None, device="cuda") -> dict:
    """A decode state for ``batch`` streams: the self-attention ring caches
    of ``max_seq`` slots (K/V zeros, positions -1) and the cross K/V of
    ``n_frames`` frames (zeros), every leaf stacked over the decoder
    layers. ``dtype`` (default ``cfg.compute_dtype``; JAX's default is
    bf16, whisper-small's compute dtype) is that of K and V."""
    dev = dispatch.resolve_device(device)
    dtype = torch_dtype(cfg.compute_dtype) if dtype is None else dtype
    n, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    cache = at.init_kv_cache(cfg, batch, "attn", max_seq, dtype, device=dev)
    return {"self": tree_map(
        lambda t: t[None].expand((n,) + tuple(t.shape)).clone(), cache),
        "cross_k": torch.zeros((n, batch, n_frames, kv, hd), dtype=dtype,
                               device=dev),
        "cross_v": torch.zeros((n, batch, n_frames, kv, hd), dtype=dtype,
                               device=dev)}


def encdec_decode_step(cfg, params, token: torch.Tensor, state: dict,
                       pos: torch.Tensor, *,
                       swa_impl: Optional[Callable] = None):
    """token: ``(B, 1)``; ``state``: :func:`init_encdec_decode_state`'s
    layout; pos: ``(B,)`` absolute positions of the tokens. One step:
    ``(logits (B, 1, V) fp32, state)``, ``state["self"]`` written in
    place."""
    if token.ndim != 2 or token.shape[1] != 1:
        raise ValueError(f"encdec_decode_step: token must be (B, 1), got "
                         f"{tuple(token.shape)}")
    if tuple(pos.shape) != (token.shape[0],):
        raise ValueError(f"encdec_decode_step: pos must be "
                         f"({token.shape[0]},), got {tuple(pos.shape)}")
    x = _embed_tokens(cfg, params, token, pos[:, None])
    x, _ = _decoder_layers(cfg, params, x, pos[:, None], states=state,
                           mode="decode", pos=pos, swa_impl=swa_impl)
    return encdec_logits(params, x), state
