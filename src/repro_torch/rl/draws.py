"""The random draws of a federated training run, from one source object.

The port cannot reproduce the JAX package's threefry streams, so the
training driver (:func:`repro_torch.rl.fedrl.run_fedrl`) takes every random
number it uses from a draw source, in a fixed order:

1. ``init_params`` — the initial policy parameters, once;
2. per epoch, ``reset`` — the reset jitter, uniform on [-0.2, 0.2);
3. per local update, ``action_noise`` — the standard-normal action noise of
   the update's whole rollout, then (only when the PPO update shuffles)
   ``permutations`` — one permutation per agent and PPO epoch;
4. per epoch, ``eval_stream()`` — a source for the fixed evaluation stream,
   which gives the same draws every time it is asked for, as the JAX
   package's fixed ``eval_seed`` key does.

:class:`TorchDraws` draws from ``torch.Generator``s on the run's device;
:class:`ReplayDraws` hands out precomputed arrays in that order (the tests
replay the JAX package's draws through it, and a run on the card can replay
the draws of a run on the CPU).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.rl.policy import init_policy


def _tree_to(tree, device) -> Dict:
    """A ``{"pi", "vf"}`` tree of arrays or tensors as fp32 tensors on
    ``device`` (copies)."""
    def leaf(v):
        v = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.array(v))
        return v.to(device, torch.float32, copy=True)

    return {h: {k: leaf(v) for k, v in tree[h].items()} for h in ("pi", "vf")}


class TorchDraws:
    """Draws from ``torch.Generator``s: the run's stream on ``device``, seeded
    with ``seed``; the evaluation stream a fresh generator seeded with
    ``eval_seed`` at every call. The initial parameters come from a CPU
    generator seeded with ``seed`` (the orthogonal init of
    :func:`repro_torch.rl.policy.init_policy`), moved to ``device``."""

    def __init__(self, seed: int, device: Union[str, torch.device],
                 eval_seed: int = 1234):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.eval_seed = int(eval_seed)
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)

    def init_params(self, obs_dim: int) -> Dict:
        params = init_policy(obs_dim,
                             generator=torch.Generator().manual_seed(self.seed),
                             device="cpu")
        return _tree_to(params, self.device)

    def reset(self, shape: Sequence[int]) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self._gen, device=self.device)
        return u * 0.4 - 0.2

    def action_noise(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self._gen,
                           device=self.device)

    def permutations(self, m: int, epochs: int, d: int) -> torch.Tensor:
        u = torch.rand((m, epochs, d), generator=self._gen, device=self.device)
        return torch.argsort(u, dim=-1)

    def eval_stream(self) -> "TorchDraws":
        return TorchDraws(self.eval_seed, self.device, self.eval_seed)


class ReplayDraws:
    """Precomputed draws, handed out in the driver's order.

    ``init`` is a ``{"pi": {...}, "vf": {...}}`` tree of arrays (the JAX
    package's layout); ``resets`` one array per epoch; ``noise`` one array
    per local update; ``perms`` one ``(m, epochs, D)`` integer array per
    local update (empty when the PPO update does not shuffle); ``eval`` the
    evaluation stream's ``{"reset": ..., "noise": ...}``. Arrays may be numpy
    arrays or tensors; each is moved to ``device`` when it is handed out,
    and a draw of the wrong shape, or one more than was given, raises.
    """

    def __init__(self, init, resets: List, noise: List,
                 perms: Optional[List] = None, eval: Optional[Dict] = None,
                 device: Union[str, torch.device] = "cpu"):
        self.init, self.resets, self.noise = init, list(resets), list(noise)
        self.perms = list(perms or [])
        self.eval = eval
        self.device = torch.device(device)
        self._i = {"reset": 0, "noise": 0, "perms": 0}

    def to(self, device) -> "ReplayDraws":
        """The same draws, handed out on ``device``, from the start."""
        return ReplayDraws(self.init, self.resets, self.noise, self.perms,
                           self.eval, device)

    def _next(self, kind: str, arrays: List, shape, dtype) -> torch.Tensor:
        i = self._i[kind]
        if i >= len(arrays):
            raise IndexError(f"ReplayDraws: no {kind} draw #{i} "
                             f"({len(arrays)} given)")
        self._i[kind] = i + 1
        t = arrays[i]
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.array(t))
        t = t.to(self.device, dtype)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"ReplayDraws: {kind} draw #{i} is "
                             f"{tuple(t.shape)}, the run needs {tuple(shape)}")
        return t

    def init_params(self, obs_dim: int) -> Dict:
        if self.init["pi"]["w1"].shape[0] != obs_dim:
            raise ValueError(f"ReplayDraws: init params take obs_dim "
                             f"{self.init['pi']['w1'].shape[0]}, not {obs_dim}")
        return _tree_to(self.init, self.device)

    def reset(self, shape) -> torch.Tensor:
        return self._next("reset", self.resets, shape, torch.float32)

    def action_noise(self, shape) -> torch.Tensor:
        return self._next("noise", self.noise, shape, torch.float32)

    def permutations(self, m: int, epochs: int, d: int) -> torch.Tensor:
        return self._next("perms", self.perms, (m, epochs, d), torch.int64)

    def eval_stream(self) -> "ReplayDraws":
        if self.eval is None:
            raise ValueError("ReplayDraws: no evaluation-stream draws given")
        return ReplayDraws(self.init, [self.eval["reset"]],
                           [self.eval["noise"]], device=self.device)
