"""Training step and fault-tolerant trainer loop; the lockstep server."""
from .serve import ServeConfig, Server
from .train import (Trainer, TrainerConfig, cross_entropy, make_loss_fn,
                    make_train_step)

__all__ = ["ServeConfig", "Server", "Trainer", "TrainerConfig",
           "cross_entropy", "make_loss_fn", "make_train_step"]
