"""Training: optimizers, losses, train/eval steps (counterpart of
qagnn_tpu/train)."""

from qagnn_tpu_torch.train.losses import (
    LOSSES,
    cross_entropy_loss,
    margin_rank_loss,
)
from qagnn_tpu_torch.train.optim import (
    TrainOptimizer,
    build_train_optimizer,
    make_lr_schedule,
)
from qagnn_tpu_torch.train.step import (
    Batch,
    accuracy,
    make_detail_step,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "LOSSES", "cross_entropy_loss", "margin_rank_loss", "TrainOptimizer",
    "build_train_optimizer", "make_lr_schedule", "Batch", "accuracy",
    "make_detail_step", "make_eval_step", "make_train_step",
]
