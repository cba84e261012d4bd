"""Training launcher: federated local SGD over the port's language models
(``repro.launch.train``).

Runs on the card unless asked for the CPU:

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-3-4b \\
      --reduced --steps 20 --strategy consensus --tau 4 --agents 2 \\
      --device cpu

Each agent reads its own ``SyntheticLM`` stream (``seed``, agent id, step:
the JAX launcher's batches bit for bit, with its stub frontend:
:func:`stub_batch`), every local step updates all
agents with ``adamw(weight_decay=0.01)`` and every ``tau`` steps the sync
step runs the strategy (``repro_torch.launch.fedtrain``). The checkpoint is
written in the JAX package's format (its train-state tree, metadata
``arch`` / ``strategy``), so ``repro.checkpoint.restore`` reads it.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import save
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticLM
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.fedtrain import (
    FedTrainConfig,
    TrainState,
    init_train_state,
    make_local_step,
    make_sync_step,
    train_state_to_tree,
)
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import check_trainable
from repro_torch.optim import adamw


def stub_batch(cfg, toks: torch.Tensor) -> dict:
    """One local step's batch from its token windows ``toks`` ``(A, B,
    seq + 1)``, as JAX's ``train()`` builds it with its stub frontends. A
    vision model's tokens are cut to ``seq - F + 1`` and its prefix is
    ``"patch_embeds": 0.1 * ones((A, B, F, d))``, so the model still reads
    ``seq`` rows; an audio encoder-decoder model keeps its tokens and gets
    ``"frames"`` of the same value and shape. F is ``n_frontend_tokens``,
    the stubs in the compute dtype on ``toks``' device."""
    if cfg.frontend not in ("vision", "audio"):
        return {"tokens": toks}
    A, B, n = toks.shape
    F = cfg.n_frontend_tokens
    stub = 0.1 * torch.ones((A, B, F, cfg.d_model),
                            dtype=torch_dtype(cfg.compute_dtype),
                            device=toks.device)
    if cfg.frontend == "vision":
        return {"tokens": toks[:, :, :n - F], "patch_embeds": stub}
    return {"tokens": toks, "frames": stub}


def train(arch: str, *, reduced: bool, steps: int, fed: FedTrainConfig,
          n_agents: int, batch: int, seq: int, ckpt_dir: Optional[str] = None,
          log_every: int = 10, seed: int = 0, device="cuda",
          state: Optional[TrainState] = None):
    """Train ``arch`` (``.reduced()`` when ``reduced``) for ``steps`` local
    steps of ``n_agents`` agents on ``(batch, seq)`` token windows; returns
    ``(state, losses)``, the losses the agents' mean per step (floats).

    The agents start from ``init_train_state(cfg, seed, ...)``, or from
    ``state`` when given (a resumed run, or a JAX state carried by
    ``train_state_from_jax``; trained in place). ``device`` defaults to the
    card and raises without one.
    """
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    check_trainable(cfg)
    opt = adamw(weight_decay=0.01)
    if state is None:
        state = init_train_state(cfg, seed, n_agents, opt, fed, device=dev)
    elif state.params.device != dev or state.n_agents != n_agents:
        raise ValueError(f"train: the state holds {state.n_agents} agents on "
                         f"{state.params.device}, asked for {n_agents} on "
                         f"{dev}")
    local_step = make_local_step(cfg, opt, fed, n_agents=n_agents)
    sync_step = make_sync_step(cfg, fed, n_agents=n_agents)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seed=seed)

    losses = []
    t0 = time.time()
    for step in range(steps):
        toks = np.stack([data.batch(step, batch, seq + 1, agent=a)
                         for a in range(n_agents)])
        state, metrics = local_step(
            state, stub_batch(cfg, torch.from_numpy(toks).to(dev)))
        if (step + 1) % fed.tau == 0:
            state = sync_step(state)
        losses.append(float(metrics["loss"]))
        if (step + 1) % log_every == 0:
            rate = (step + 1) / (time.time() - t0)
            print(f"step {step + 1:5d} | loss {losses[-1]:.4f} | "
                  f"{rate:.2f} steps/s | sync every {fed.tau}")
    if ckpt_dir:
        save(ckpt_dir, steps, train_state_to_tree(state),
             metadata={"arch": cfg.name, "strategy": fed.strategy})
    return state, losses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--strategy", default="periodic",
                    choices=["sync", "periodic", "decay", "consensus"])
    ap.add_argument("--tau", type=int, default=8)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--outer-momentum", type=float, default=0.0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args()
    fed = FedTrainConfig(strategy=args.strategy, tau=args.tau, lr=args.lr,
                         outer_momentum=args.outer_momentum)
    _, losses = train(args.arch, reduced=args.reduced, steps=args.steps,
                      fed=fed, n_agents=args.agents, batch=args.batch,
                      seq=args.seq, ckpt_dir=args.ckpt, device=args.device)
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")


if __name__ == "__main__":
    main()
