"""Train a ~100M-param LM with the paper's federated aggregation as the
cross-agent sync strategy, on the PyTorch port.

  PYTHONPATH=src python examples/torch_train_lm_federated.py [--steps 300] \\
      [--device cpu]

The port's copy of ``examples/train_lm_federated.py``: the same lm-100m
config (16 layers, d 512, 8 query heads on 4 KV heads of 64, fp32), the
same knobs and batches (``repro_torch.launch.train.train``: A agents x 4
rows x 128 tokens, AdamW, a sync every ``tau`` steps). It runs on the card
(every attention's forward and backward through the hand-written
``swa_attention`` kernels, the flat Adam and the sync's ``row_mean`` /
``consensus_step``) unless ``--device cpu`` is given. The weights come
from the port's generator, so its numbers are the port's own, not JAX's.
"""
import argparse

from repro_torch.configs import get_arch, register_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.fedtrain import FedTrainConfig
from repro_torch.launch.train import train

ARCH = "lm-100m"
BATCH, SEQ = 4, 128


def lm100m() -> ModelConfig:
    """The example's ~100M-param llama-style config, registered once."""
    try:
        return get_arch(ARCH)
    except KeyError:
        return register_arch(ModelConfig(
            name=ARCH,
            family="dense",
            n_layers=16,
            d_model=512,
            n_heads=8,
            n_kv_heads=4,
            head_dim=64,
            d_ff=2048,
            vocab_size=65536,          # ~33M embed (tied) + ~67M blocks
            activation="swiglu",
            tie_embeddings=True,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
            ce_chunks=0,
            source="example",
        ))


def run(steps: int, agents: int, tau: int, strategy: str,
        outer_momentum: float = 0.0, device: str = "cuda",
        log_every: int = 20):
    """``train()`` on lm-100m: ``(state, losses)``."""
    cfg = lm100m()
    print(f"lm-100m: {cfg.n_params() / 1e6:.1f}M params, "
          f"strategy={strategy} tau={tau} agents={agents} device={device}")
    fed = FedTrainConfig(strategy=strategy, tau=tau, lr=3e-4,
                         outer_momentum=outer_momentum)
    return train(ARCH, reduced=False, steps=steps, fed=fed, n_agents=agents,
                 batch=BATCH, seq=SEQ, log_every=log_every, device=device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--tau", type=int, default=8)
    ap.add_argument("--strategy", default="periodic",
                    choices=["sync", "periodic", "decay", "consensus"])
    ap.add_argument("--outer-momentum", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args()
    _, losses = run(args.steps, args.agents, args.tau, args.strategy,
                    args.outer_momentum, args.device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'improved' if losses[-1] < losses[0] else 'NO IMPROVEMENT'})")


if __name__ == "__main__":
    main()
