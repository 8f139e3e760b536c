"""Per-group int4/int8 dequant-matmul for quantized weights: CUDA C++
kernels for sm_90a (a tensor-core body and a CUDA-core one) with their
plain PyTorch versions."""
from . import ops, ref
from .ops import (LAUNCHES, dequant_ref, quant_matmul, quant_matmul_ref,
                  quantize_ref, reset_launch_counts)

__all__ = ["LAUNCHES", "dequant_ref", "quant_matmul", "quant_matmul_ref",
           "quantize_ref", "reset_launch_counts"]
