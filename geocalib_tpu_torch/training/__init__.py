"""Training: losses, metrics, the training step (data-parallel over a mesh's ranks),
and the loop (``training.train``) with its checkpoints, export, debug tools and
staged store."""

from geocalib_tpu_torch.training.losses import geocalib_losses, geocalib_metrics
from geocalib_tpu_torch.training.train_step import (AdamState, TrainConfig, TrainState,
                                                    create_train_state, loss_and_updates,
                                                    make_eval_step, make_schedule,
                                                    make_train_step, optimizer_update)

__all__ = [
    "AdamState",
    "TrainConfig",
    "TrainState",
    "create_train_state",
    "geocalib_losses",
    "geocalib_metrics",
    "loss_and_updates",
    "make_eval_step",
    "make_schedule",
    "make_train_step",
    "optimizer_update",
]
