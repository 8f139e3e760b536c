"""Paged flash attention (decode + chunked prefill) for the serving engine:
CUDA C++ kernels for sm_90a with their plain PyTorch versions."""
from .ops import (LAUNCHES, paged_decode, paged_decode_ref, paged_prefill,
                  paged_prefill_ref, reset_launch_counts)

__all__ = ["LAUNCHES", "paged_decode", "paged_decode_ref", "paged_prefill",
           "paged_prefill_ref", "reset_launch_counts"]
