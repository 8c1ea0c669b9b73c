"""Training: losses, metrics and the one-device training step (``train_step.train_step``)."""

from geocalib_tpu_torch.training.losses import geocalib_losses, geocalib_metrics
from geocalib_tpu_torch.training.train_step import (AdamState, TrainConfig, TrainState,
                                                    create_train_state, loss_and_updates,
                                                    make_schedule, optimizer_update)

__all__ = [
    "AdamState",
    "TrainConfig",
    "TrainState",
    "create_train_state",
    "geocalib_losses",
    "geocalib_metrics",
    "loss_and_updates",
    "make_schedule",
    "optimizer_update",
]
