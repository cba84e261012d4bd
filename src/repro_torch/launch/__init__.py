"""Serving entry points of the port's language models (``repro.launch``):
the prefill and serve steps and the batched greedy ``ServingLoop``."""
from repro_torch.launch.serve import make_prefill_step, make_serve_step
from repro_torch.launch.serving_loop import Completion, Request, ServingLoop

__all__ = ["Completion", "Request", "ServingLoop", "make_prefill_step",
           "make_serve_step"]
