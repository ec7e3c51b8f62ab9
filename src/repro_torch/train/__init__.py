from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)
from repro_torch.train.trainer import LoopConfig, train_loop

__all__ = ["TrainConfig", "init_train_state", "make_train_step",
           "LoopConfig", "train_loop"]
