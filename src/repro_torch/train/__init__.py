"""Training of the port: the train step and the fault-tolerant trainer
(the reference's `train/`)."""

from repro_torch.train.train_step import TrainState, init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
