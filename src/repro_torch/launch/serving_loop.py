"""Batched serving loop: slot-based continuous batching (lite), as
``repro.launch.serving_loop``.

A fixed pool of B slots shares one stacked decode state. Requests carry a
prompt and a token budget; free slots are refilled from the queue each
cycle, then all active slots decode in lockstep, one serve step per token,
with one batched greedy argmax. Finished slots are recycled without
disturbing their neighbours.

Admission prefills only the new request's own slot: the slot's state rows
are reset to their initial values (zeros; -1 for the caches' positions, so
that a recycled slot's stale K/V is never attended), then ``prompt[:-1]``
runs through the sequence path at B = 1 (one kernel launch per layer over
the whole prompt) and writes that slot's rows: its WKV states, or its ring
of K/V. The last prompt token stays in the token buffer, so the request's
first generated token comes out of the next lockstep decode, as in the JAX
loop. The JAX loop instead feeds each prompt token through ``decode_step``
over all slots (``repro/launch/serving_loop.py:95-100``), which advances
every other active slot's recurrent state once per prompt token with that
slot's pending token (for attention models it rewrites the same K/V at the
same positions, which is harmless); the port does not copy that fault
(ROADMAP, Queue C), so its completions equal single-request greedy
decoding.

In place: ``self.state`` is updated in place by every decode step and by
every admission; the token buffer is host memory, copied to the device
once per step.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

import numpy as np
import torch

from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_decode_state,
    reset_state,
    tree_map,
)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) integer token ids, S >= 1
    max_new_tokens: int


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: List[int]


@dataclasses.dataclass
class _Slot:
    rid: Optional[int] = None
    pos: int = 0                  # absolute position of next write
    remaining: int = 0
    out: Optional[List[int]] = None


class ServingLoop:
    """Greedy decoding over a slot pool, on the device the parameters lie
    on. A slot stops after ``max_new_tokens`` or once its position reaches
    ``max_seq - 1``. ``n_prefills`` and ``n_steps`` count the admissions
    that ran a prefill and the lockstep decode steps. Nothing is recorded
    for autograd, whether or not the parameters require grad."""

    def __init__(self, cfg, params, n_slots: int = 4, max_seq: int = 256):
        self.cfg, self.params = cfg, params
        self.n_slots, self.max_seq = n_slots, max_seq
        self.device = params["embed"]["table"].device
        self.state = init_decode_state(cfg, n_slots, max_seq=max_seq,
                                       device=self.device)
        self.slots = [_Slot() for _ in range(n_slots)]
        self._tok = np.zeros((n_slots, 1), np.int64)
        self.n_prefills = self.n_steps = 0

    def _free(self):
        return [i for i, s in enumerate(self.slots) if s.rid is None]

    def _slot_state(self, i: int) -> dict:
        """Slot ``i``'s rows of every state leaf, as (L, 1, ...) views."""
        return tree_map(lambda t: t[:, i:i + 1], self.state)

    @torch.no_grad()
    def _admit(self, req: Request, slot_idx: int):
        prompt = np.asarray(req.prompt).reshape(-1)
        if prompt.size == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        view = reset_state(self._slot_state(slot_idx))
        if prompt.size > 1:
            toks = torch.as_tensor(prompt[None, :-1].astype(np.int64),
                                   device=self.device)
            forward(self.cfg, self.params, toks, mode="prefill", states=view,
                    unembed_out=False)
            self.n_prefills += 1
        s = self.slots[slot_idx]
        s.rid, s.remaining, s.out = req.rid, req.max_new_tokens, []
        s.pos = int(prompt.size) - 1
        self._tok[slot_idx, 0] = int(prompt[-1])

    @torch.no_grad()
    def run(self, requests: Iterable[Request]) -> List[Completion]:
        queue = list(requests)
        done: List[Completion] = []
        while queue or any(s.rid is not None for s in self.slots):
            for i in self._free():
                if not queue:
                    break
                self._admit(queue.pop(0), i)
            active = [i for i, s in enumerate(self.slots) if s.rid is not None]
            if not active:
                continue
            tok = torch.from_numpy(self._tok).to(self.device)
            pos = torch.as_tensor([s.pos for s in self.slots],
                                  device=self.device)
            logits, _ = decode_step(self.cfg, self.params, tok, self.state,
                                    pos)
            self.n_steps += 1
            nxt = logits[:, -1].argmax(-1).cpu().numpy()
            for i in active:
                s = self.slots[i]
                s.pos += 1
                if s.remaining > 0:
                    s.out.append(int(nxt[i]))
                    s.remaining -= 1
                    self._tok[i, 0] = int(nxt[i])
                if s.remaining == 0 or s.pos >= self.max_seq - 1:
                    done.append(Completion(s.rid, s.out))
                    self.slots[i] = _Slot()
        return done
