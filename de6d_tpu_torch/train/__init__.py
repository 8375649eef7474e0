"""Training (counterpart of ``de6d_tpu/train``): optimizers and
schedules, the train state and step, the train loop, checkpoints."""

from .optimization import build_optimizer_and_schedule
from .train_state import TrainState, create_train_state, make_train_step

__all__ = [
    "build_optimizer_and_schedule",
    "TrainState",
    "create_train_state",
    "make_train_step",
]
