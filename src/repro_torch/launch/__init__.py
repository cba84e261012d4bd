"""Entry points of the port's language models (``repro.launch``): the
prefill and serve steps, the batched greedy ``ServingLoop`` and federated
training (``fedtrain``; the launcher is ``repro_torch.launch.train``)."""
from repro_torch.launch.fedtrain import (
    FedTrainConfig,
    ParamLayout,
    TrainState,
    init_train_state,
    make_local_step,
    make_sync_step,
    train_state_from_jax,
    train_state_to_tree,
)
from repro_torch.launch.serve import make_prefill_step, make_serve_step
from repro_torch.launch.serving_loop import Completion, Request, ServingLoop

__all__ = ["Completion", "FedTrainConfig", "ParamLayout", "Request",
           "ServingLoop", "TrainState", "init_train_state", "make_local_step",
           "make_prefill_step", "make_serve_step", "make_sync_step",
           "train_state_from_jax", "train_state_to_tree"]
