"""Training step and fault-tolerant trainer loop; the lockstep server;
the sharding rules of a mesh."""
from .serve import ServeConfig, Server
from .sharding import ShardingPolicy, pp_degree, tp_degree
from .train import (Trainer, TrainerConfig, cross_entropy, make_loss_fn,
                    make_train_step)

__all__ = ["ServeConfig", "Server", "ShardingPolicy", "Trainer",
           "TrainerConfig", "pp_degree", "tp_degree",
           "cross_entropy", "make_loss_fn", "make_train_step"]
