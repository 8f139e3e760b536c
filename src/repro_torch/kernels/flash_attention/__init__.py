"""Flash attention (forward and backward) for training: CUDA C++ kernels
for sm_90a, two bodies each (tensor cores for bf16, f32 CUDA cores
otherwise), with their plain PyTorch version."""
from .ops import (BODY_LAUNCHES, LAUNCHES, attention_ref, flash_attention,
                  flash_body, flash_bwd, flash_fwd, reset_launch_counts)

__all__ = ["BODY_LAUNCHES", "LAUNCHES", "attention_ref", "flash_attention",
           "flash_body", "flash_bwd", "flash_fwd", "reset_launch_counts"]
