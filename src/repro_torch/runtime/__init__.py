"""Training step and fault-tolerant trainer loop."""
from .train import (Trainer, TrainerConfig, cross_entropy, make_loss_fn,
                    make_train_step)

__all__ = ["Trainer", "TrainerConfig", "cross_entropy", "make_loss_fn",
           "make_train_step"]
