"""ray_tpu_torch.train — the training step, on one device or sharded over
a mesh (port of ray_tpu/train/step.py), and checkpoints (port of
ray_tpu/train/_checkpoint.py: ``Checkpoint``, ``CheckpointManager`` and
``save_pytree``/``load_pytree``, which save and restore a ``TrainState``,
a rank's part of one over a mesh, or a tree of tensors and numpy arrays).
The Trainer, its worker group and the session belong to the runtime and
are not ported yet."""

from ray_tpu_torch.train._checkpoint import (
    Checkpoint,
    CheckpointManager,
    load_pytree,
    save_pytree,
)
from ray_tpu_torch.train.step import (
    TrainState,
    adamw,
    cross_entropy_loss,
    init_train_state,
    make_train_step,
)

__all__ = [
    "Checkpoint",
    "CheckpointManager",
    "TrainState",
    "adamw",
    "cross_entropy_loss",
    "init_train_state",
    "load_pytree",
    "make_train_step",
    "save_pytree",
]
