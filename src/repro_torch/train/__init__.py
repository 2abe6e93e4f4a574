"""Training pieces of the port: the LM train step and explicit DDP
gradient synchronization."""
from . import ddp
from .train import (TrainConfig, TrainState, init_train_state,
                    make_train_step, train_state_shardings)

__all__ = ["TrainConfig", "TrainState", "make_train_step", "init_train_state",
           "train_state_shardings", "ddp"]
