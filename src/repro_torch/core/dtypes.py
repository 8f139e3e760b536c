"""Datatype registry for LIFE analytical models.

The paper parameterizes every operator by ``nbytes`` (bytes/element of a
"native" dtype, e.g. 2 for bf16) and ``qbytes`` (bytes/element of a quantized
storage dtype, e.g. 0.5 for int4).  Micro-scaling formats (MXFP8/MXINT8,
Rouhani et al. 2023) carry a shared scale per block which we account as
``block_overhead_bytes / block_size`` extra per element.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DType:
    name: str
    bytes_per_el: float              # storage bytes per element
    is_quantized: bool = False       # needs dequant before MXU/compute
    # per-group quant params (scale/zero) — group size is a model-config knob,
    # these describe the *per-parameter-group* storage cost in bytes.
    scale_bytes: float = 0.0         # bytes of scale per group (e.g. bf16=2)
    zero_bytes: float = 0.0          # bytes of zero-point per group
    # micro-scaling block formats: shared scale per fixed hardware block.
    mx_block: Optional[int] = None   # block size (32 for MX formats)
    mx_scale_bytes: float = 0.0      # shared-scale bytes per block (E8M0 = 1)

    def storage_bytes(self, num_el: int, group_size: Optional[int] = None) -> float:
        """Total bytes to store ``num_el`` elements, incl. quant metadata."""
        base = num_el * self.bytes_per_el
        if self.mx_block:
            base += (num_el / self.mx_block) * self.mx_scale_bytes
        elif self.is_quantized and group_size:
            groups = num_el / group_size
            base += groups * (self.scale_bytes + self.zero_bytes)
        return base


_REGISTRY = {}


def _reg(dt: DType) -> DType:
    _REGISTRY[dt.name] = dt
    return dt


FP32 = _reg(DType("fp32", 4.0))
TF32 = _reg(DType("tf32", 4.0))
BF16 = _reg(DType("bf16", 2.0))
FP16 = _reg(DType("fp16", 2.0))
FP8 = _reg(DType("fp8", 1.0))
INT16 = _reg(DType("int16", 2.0, is_quantized=True, scale_bytes=2.0, zero_bytes=2.0))
INT8 = _reg(DType("int8", 1.0, is_quantized=True, scale_bytes=2.0, zero_bytes=1.0))
INT4 = _reg(DType("int4", 0.5, is_quantized=True, scale_bytes=2.0, zero_bytes=0.5))
MXFP8 = _reg(DType("mxfp8", 1.0, is_quantized=True, mx_block=32, mx_scale_bytes=1.0))
MXINT8 = _reg(DType("mxint8", 1.0, is_quantized=True, mx_block=32, mx_scale_bytes=1.0))
MXFP4 = _reg(DType("mxfp4", 0.5, is_quantized=True, mx_block=32, mx_scale_bytes=1.0))


def get(name: str) -> DType:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown dtype {name!r}; known: {sorted(_REGISTRY)}") from None


def nbytes(name: str) -> float:
    """Paper's ``calc_nbytes``: storage bytes per element."""
    return get(name).bytes_per_el


def known() -> list[str]:
    return sorted(_REGISTRY)
