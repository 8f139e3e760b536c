"""Per-group int4/int8 weight quantization of the port (paper §3.3.1)."""
from .weights import (QuantizedTensor, quantize_weight, dequantize_weight,
                      quant_dense, quantize_tree, tree_storage_bytes)

__all__ = ["QuantizedTensor", "quantize_weight", "dequantize_weight",
           "quant_dense", "quantize_tree", "tree_storage_bytes"]
