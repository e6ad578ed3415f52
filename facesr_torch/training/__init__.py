"""Training of the port: schedules, the optax-exact AdamW, the train/eval
steps and the Trainer (one card, or data-parallel over ranks)."""

from facesr_torch.training.optim import AdamW, set_learning_rate
from facesr_torch.training.schedules import (ReduceLROnPlateau, compute_lr,
                                             cosine_annealing, step_lr)
from facesr_torch.training.steps import (TrainState, ema_update, init_ema,
                                         make_eval_step, make_train_step)
from facesr_torch.training.trainer import EarlyStopping, Trainer, TrainerConfig

__all__ = ["AdamW", "set_learning_rate", "ReduceLROnPlateau", "compute_lr",
           "cosine_annealing", "step_lr", "TrainState", "init_ema", "ema_update",
           "make_train_step", "make_eval_step", "EarlyStopping", "Trainer",
           "TrainerConfig"]
