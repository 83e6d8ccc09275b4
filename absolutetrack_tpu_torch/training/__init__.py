"""Training (port of ``absolutetrack_tpu/training/``): losses, the
optimizer written out, the train and eval steps, and the synthetic and
rendered window builders."""

from .loss import LossWeights, sequence_loss
from .train import TrainState, make_eval_step, make_train_step

__all__ = [
    "LossWeights",
    "TrainState",
    "make_eval_step",
    "make_train_step",
    "sequence_loss",
]
