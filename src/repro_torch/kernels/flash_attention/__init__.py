"""Flash attention (forward and backward) for training: CUDA C++ kernels
for sm_90a with their plain PyTorch version."""
from .ops import (LAUNCHES, attention_ref, flash_attention, flash_bwd,
                  flash_fwd, reset_launch_counts)

__all__ = ["LAUNCHES", "attention_ref", "flash_attention", "flash_bwd",
           "flash_fwd", "reset_launch_counts"]
