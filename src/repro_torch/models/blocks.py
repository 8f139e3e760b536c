"""Dense MLP block (the PyTorch counterpart of ``blocks.mlp_forward``)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from .layers import dense, gelu, silu


def mlp_forward(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.gated_mlp:
        return dense(silu(dense(x, p["gate"])) * dense(x, p["up"]), p["down"])
    return dense(gelu(dense(x, p["up"])), p["down"])
