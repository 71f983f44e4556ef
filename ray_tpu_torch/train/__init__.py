"""ray_tpu_torch.train — the training step, on one device or sharded over
a mesh (port of ray_tpu/train/step.py). The Trainer, session and
checkpoint modules of ray_tpu.train belong to the runtime and are not
ported yet."""

from ray_tpu_torch.train.step import (
    TrainState,
    adamw,
    cross_entropy_loss,
    init_train_state,
    make_train_step,
)

__all__ = [
    "TrainState",
    "adamw",
    "cross_entropy_loss",
    "init_train_state",
    "make_train_step",
]
