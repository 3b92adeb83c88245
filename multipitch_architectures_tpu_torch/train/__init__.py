"""Training: the single configurable trainer that replaces the
reference's 111 copy-paste experiment scripts, with its losses, learning
rate schedulers and early stopping."""

from .losses import (bce_loss, cross_entropy_logits, multitask_bce_ce_loss,
                     polyphony_targets)
from .monitoring import EarlyStopping, early_stopping
from .schedulers import (NoamSchedule, ReduceLROnPlateau, noam_opt,
                         polynomial_decay_lambda)
from .trainer import TrainConfig, Trainer
