"""Serving steps: prefill (context ingest) and serve_step (one-token decode),
as ``repro.launch.serve`` builds them, for decoder LMs and, through
``models/encdec.py``, the encoder-decoder (whisper-small). There is no mesh:
the steps run on the device the parameters lie on, and record nothing for
autograd, whether or not the parameters require grad."""
from __future__ import annotations

import torch

from repro_torch.models.encdec import (
    encdec_decode_step,
    encdec_forward,
    encdec_logits,
)
from repro_torch.models.transformer import (
    decode_step,
    forward,
    lm_head,
)


def make_prefill_step(cfg):
    """``prefill_step(params, batch) -> (logits (B, 1, V), states)``:
    ``batch["tokens"]`` (B, S) through the sequence path from an initial
    state, after ``batch["patch_embeds"]`` (B, F, d) where the batch has
    them (a VLM's prefix), the KV caches sized for F + S positions, as the
    JAX step sizes them; decoding goes on at position F + S. Only the last
    position is unembedded (the JAX step slices it from the full logits;
    the values are the same row of the same product). An encoder-decoder
    model reads ``batch["frames"]`` (B, F, d) instead, and its states are
    ``encdec_forward``'s prefill states (self-attention caches and cross
    K/V)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.is_encoder_decoder:
            x, states = encdec_forward(cfg, params, batch["tokens"],
                                       batch["frames"], mode="prefill",
                                       unembed_out=False)
            return encdec_logits(params, x[:, -1:]), states
        # forward's default states: sized for the F + S rows, prefill mode
        x, states, _ = forward(cfg, params, batch["tokens"],
                               embeds=batch.get("patch_embeds"),
                               mode="prefill", unembed_out=False)
        return lm_head(cfg, params, x[:, -1:]), states

    return prefill_step


def make_serve_step(cfg):
    """``serve_step(params, token, states, pos) -> (logits (B, 1, V),
    states)``: one decode step; ``states`` are updated in place (an
    encoder-decoder model's are ``init_encdec_decode_state``'s layout)."""
    step = encdec_decode_step if cfg.is_encoder_decoder else decode_step

    @torch.no_grad()
    def serve_step(params, token, states, pos):
        return step(cfg, params, token, states, pos)

    return serve_step
