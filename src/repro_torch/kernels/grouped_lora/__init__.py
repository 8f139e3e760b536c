"""Grouped low-rank (LoRA) matmul for multi-tenant serving: a CUDA C++
kernel for sm_90a with its plain PyTorch versions."""
from .ops import (LAUNCHES, grouped_lora, grouped_lora_pregathered,
                  grouped_lora_ref, reset_launch_counts)

__all__ = ["LAUNCHES", "grouped_lora", "grouped_lora_pregathered",
           "grouped_lora_ref", "reset_launch_counts"]
