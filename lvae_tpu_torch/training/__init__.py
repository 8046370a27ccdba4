"""Training, counterpart of ``lvae_tpu/training/``: the train state and
step (optim.py), the LR schedules, the checkpoints and the trainer
(trainer.py, imported from there: it pulls in the data side)."""
from lvae_tpu_torch.training import checkpoint
from lvae_tpu_torch.training.optim import (
    TrainState, make_train_step, param_group_label,
)
from lvae_tpu_torch.training.schedules import get_cosine_factor, lr_factor

__all__ = ['TrainState', 'checkpoint', 'get_cosine_factor', 'lr_factor',
           'make_train_step', 'param_group_label']
