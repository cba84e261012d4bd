"""Flat-key .npz checkpoints, in the JAX package's format."""
from repro_torch.checkpoint.io import latest_step, restore, save

__all__ = ["latest_step", "restore", "save"]
