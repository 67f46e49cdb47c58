"""Training substrate of the port (twin of ``repro.train``)."""
from repro_torch.train.optimizer import (OptConfig, OptState, adamw_update,
                                         init_opt_state)
from repro_torch.train.trainer import (TrainConfig, Trainer, loss_and_grads,
                                       make_train_step)

__all__ = ["OptConfig", "OptState", "adamw_update", "init_opt_state",
           "TrainConfig", "Trainer", "loss_and_grads", "make_train_step"]
