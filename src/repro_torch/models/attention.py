"""Attention of the decoder LMs (``repro.models.attention``): full-sequence
causal attention with an optional sliding window (train / prefill) and the
one-token decode step over a ring-buffered KV cache.

Full-sequence attention goes through
:func:`repro_torch.kernels.dispatch.swa_attention`: the hand-written
``swa_attention`` kernel on the card, its plain version on the CPU. The JAX
package picks one of three jnp forms of that function by ``cfg.attn_impl``
(``flash``, ``chunked``, ``einsum``); the port runs the dispatched function
for every name. It computes what the TPU kernel computes, which keeps the
softmax weights in fp32 for ``p @ v`` where the JAX forms round them to the
compute dtype first: the same numbers in fp32, a little more exact in bf16.
As in the JAX ``flash`` path, positions are contiguous from 0 (they are
read by the rotary embedding and the cache).

The decode path keeps the cache un-repeated, ``(B, W, KV, hd)``, and runs
as plain torch (a grouped einsum), as JAX runs it outside any kernel. The
token at position p lives in ring slot ``p % W``; empty slots hold
position -1.

In place: :func:`build_cache` with ``out=`` and :func:`write_cache` write
into the cache tensors they are given (views of the model's stacked decode
state), and :func:`attention_decode` writes the new token's K/V there.

Cross-attention (whisper-small's decoder): :func:`cross_kv` projects the
encoder output to K/V once, :func:`cross_attention` attends the decoder's
queries over all of it, no mask (the JAX package's all-zero positions),
through the same dispatched kernel with ``causal=False`` and Sq != Sk, in
prefill and at every decode step.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.models.layers import apply_rope, mk

NEG_INF = -1e30
ATTN_IMPLS = ("flash", "chunked", "einsum")
CACHE_UPDATES = ("scatter", "onehot")


def init_attention(gen, cfg, *, cross: bool = False) -> dict:
    """Q/K/V/O projections (and QKV biases where ``cfg.qkv_bias``). A
    cross-attention block (``cross``) has the same keys and shapes."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    std = 0.02
    p = {
        "wq": mk(gen, (d, h * hd), std=std),
        "wk": mk(gen, (d, kv * hd), std=std),
        "wv": mk(gen, (d, kv * hd), std=std),
        "wo": mk(gen, (h * hd, d), std=std / max(cfg.n_layers, 1) ** 0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = mk(gen, (h * hd,), zeros=True)
        p["bk"] = mk(gen, (kv * hd,), zeros=True)
        p["bv"] = mk(gen, (kv * hd,), zeros=True)
    return p


def window_of(cfg, kind: str) -> Optional[int]:
    """The sliding window of a ``kind`` block: ``cfg.sliding_window`` for
    ``local``, None (global) for ``attn``."""
    return cfg.sliding_window if kind == "local" else None


def _project_qkv(p, x, cfg, positions, *, rope: bool = True):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if rope and cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd): each KV head repeated H / KV times
    in a row (the kernels read head h's KV head as ``h // (H // KV)``)."""
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_heads // kv, hd).reshape(
        b, s, n_heads, hd)


def _mask_bias(q_pos, k_pos, *, causal: bool, window: Optional[int]):
    """(.., Sq, Sk) fp32 additive bias from position tensors."""
    ok = torch.ones(q_pos.shape[:-1] + (q_pos.shape[-1], k_pos.shape[-1]),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        ok &= k_pos[..., None, :] > q_pos[..., :, None] - window
    zero = torch.zeros((), device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _attend(p, x, cfg, kind, positions, impl, swa_impl):
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {impl!r}; expected {ATTN_IMPLS}")
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    fn = swa_impl or dispatch.swa_attention
    o = fn(q, k, v, window=window_of(cfg, kind), causal=True)
    return o.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"], k, v


def attention(p, x, cfg, *, kind: str, positions, impl: Optional[str] = None,
              swa_impl: Optional[Callable] = None):
    """Full-sequence causal attention (train / prefill). x: (B, S, d);
    positions: (B, S), contiguous from 0. ``impl`` (``flash``, ``chunked``
    or ``einsum``, default ``cfg.attn_impl``) names a JAX form of the same
    function; every name runs the dispatched kernel, or ``swa_impl`` when
    given (a function of ``(q, k, v, *, window, causal)`` such as
    ``swa_attention_plain``)."""
    return _attend(p, x, cfg, kind, positions, impl or cfg.attn_impl,
                   swa_impl)[0]


def build_cache(k, v, positions, cache_len: int, out: Optional[dict] = None
                ) -> dict:
    """Arrange full-sequence K/V (B, S, KV, hd) into a ring cache of length
    W = ``cache_len``: with W >= S token i at slot i, the rest zeros at
    position -1; with W < S only the last W tokens, the one at position p at
    slot ``p % W``. Returns a new cache, or fills ``out`` (a cache of length
    W, written in place) and returns it."""
    b, s, kv, hd = k.shape
    w = cache_len
    if out is None:
        out = {"k": k.new_zeros((b, w, kv, hd)), "v": v.new_zeros((b, w, kv, hd)),
               "pos": torch.full((b, w), -1, dtype=torch.int32,
                                 device=k.device)}
    else:
        if tuple(out["k"].shape) != (b, w, kv, hd):
            raise ValueError(f"build_cache: out['k'] is {tuple(out['k'].shape)}"
                             f", expected {(b, w, kv, hd)}")
        out["k"].zero_()
        out["v"].zero_()
        out["pos"].fill_(-1)
    if w >= s:
        out["k"][:, :s] = k
        out["v"][:, :s] = v
        out["pos"][:, :s] = positions
        return out
    rows = torch.arange(b, device=k.device)[:, None]
    slots = positions[:, -w:] % w                          # (B, W)
    out["k"][rows, slots] = k[:, -w:]
    out["v"][rows, slots] = v[:, -w:]
    out["pos"][rows, slots] = positions[:, -w:].to(torch.int32)
    return out


def attention_prefill(p, x, cfg, *, kind: str, positions, cache_len: int,
                      impl: Optional[str] = None, out: Optional[dict] = None,
                      swa_impl: Optional[Callable] = None):
    """Full-sequence attention that also returns the populated KV cache of
    length ``min(window, cache_len)`` (``cache_len`` for global attention),
    filled into ``out`` when given."""
    o, k, v = _attend(p, x, cfg, kind, positions, impl or cfg.attn_impl,
                      swa_impl)
    return o, build_cache(k, v, positions, cache_len_of(cfg, kind, cache_len),
                          out=out)


# ----------------------------------------------------------------------------
# Decode path with a ring-buffered KV cache
# ----------------------------------------------------------------------------

def cache_len_of(cfg, kind: str, max_seq: int) -> int:
    """Ring length of a ``kind`` layer's cache for ``max_seq`` positions."""
    window = window_of(cfg, kind)
    return min(window, max_seq) if window else max_seq


def init_kv_cache(cfg, batch: int, kind: str, max_seq: int, dtype,
                  device="cpu") -> dict:
    w = cache_len_of(cfg, kind, max_seq)
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, w, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, w, kv, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, w), -1, dtype=torch.int32, device=device),
    }


def write_cache(cache: dict, k_new, v_new, pos, impl: str = "scatter") -> dict:
    """k_new / v_new: (B, KV, hd); pos: (B,) absolute positions. Writes slot
    ``pos % W`` of each row in place and returns ``cache``. The JAX
    package's ``onehot`` (masked arithmetic) and ``scatter`` forms write the
    same values; both names run this one."""
    if impl not in CACHE_UPDATES:
        raise ValueError(f"unknown cache_update {impl!r}; expected "
                         f"{CACHE_UPDATES}")
    w = cache["k"].shape[1]
    rows = torch.arange(k_new.shape[0], device=k_new.device)
    slot = pos % w
    cache["k"][rows, slot] = k_new
    cache["v"][rows, slot] = v_new
    cache["pos"][rows, slot] = pos.to(torch.int32)
    return cache


def attention_decode(p, x, cache: dict, cfg, *, kind: str, pos):
    """One-token decode. x: (B, 1, d); pos: (B,) absolute position of the
    new token. Writes its K/V into ``cache`` (in place) and attends over the
    cache: each KV head serves ``H // KV`` query heads; a slot counts when
    its position is set (>= 0), not after ``pos`` and inside the window."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    window = window_of(cfg, kind)

    q, k, v = _project_qkv(p, x, cfg, pos[:, None])
    cache = write_cache(cache, k[:, 0], v[:, 0], pos, impl=cfg.cache_update)

    qh = q[:, 0].reshape(b, kv, g, hd)
    scores = torch.einsum("bngh,btnh->bngt", qh, cache["k"]).float() * hd ** -0.5
    kp = cache["pos"]
    bias = _mask_bias(pos[:, None], kp, causal=True, window=window)[:, 0]
    bias = torch.where(kp >= 0, bias, NEG_INF)             # empty ring slots
    wgt = torch.softmax(scores + bias[:, None, None, :], dim=-1).to(x.dtype)
    o = torch.einsum("bngt,btnh->bngh", wgt, cache["v"]).reshape(b, 1, h * hd)
    return o @ p["wo"], cache


# ----------------------------------------------------------------------------
# Cross-attention (whisper decoder); K/V precomputed from the encoder output
# ----------------------------------------------------------------------------

def cross_kv(p, enc_out, cfg):
    """enc_out: (B, T, d) -> K, V (B, T, KV, hd), each with its bias."""
    b, t, _ = enc_out.shape
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    k = enc_out @ p["wk"]
    v = enc_out @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return k.reshape(b, t, kv, hd), v.reshape(b, t, kv, hd)


def cross_attention(p, x, k, v, cfg, *, swa_impl: Optional[Callable] = None):
    """x: (B, S, d) queries; k, v: (B, T, KV, hd) from :func:`cross_kv`.
    Every query sees every key: the dispatched attention (or ``swa_impl``)
    with no window and ``causal=False``. The JAX package picks ``attn_einsum``
    or ``attn_chunked`` by S * T; both compute this function."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(b, s, h, hd)
    fn = swa_impl or dispatch.swa_attention
    o = fn(q, k, v, window=None, causal=False)
    return o.reshape(b, s, h * hd) @ p["wo"]
