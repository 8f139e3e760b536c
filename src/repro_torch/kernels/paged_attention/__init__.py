"""Paged flash attention (decode, chunked prefill and speculative verify)
for the serving engine: CUDA C++ kernels for sm_90a with their plain
PyTorch versions."""
from .ops import (LAUNCHES, paged_decode, paged_decode_ref, paged_prefill,
                  paged_prefill_ref, paged_verify, paged_verify_ref,
                  reset_launch_counts)

__all__ = ["LAUNCHES", "paged_decode", "paged_decode_ref", "paged_prefill",
           "paged_prefill_ref", "paged_verify", "paged_verify_ref",
           "reset_launch_counts"]
