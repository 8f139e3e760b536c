"""Weight quantization substrate (paper §3.3.1 executable), the port's
counterpart of the JAX package's ``quant/weights.py``.

Per-group int4/int8 quantization of model weight trees; quantized linears
execute through the hand-written dequant-matmul kernel (CUDA tensors) or
its plain version (CPU tensors).  LIFE's analytical model charges exactly
this layout: 0.5 B/element + per-group scale/zero reads + 2·k·n dequant
ops.

The port keeps the reference's selection rule in :func:`quantize_tree`:
every 2-D leaf with ``numel >= min_size`` and ``shape[0] % group_size ==
0``.  The model trees stack their layers on a leading axis, so on a
dense decoder that rule picks exactly ``embed`` and ``lm_head`` — the
embedding is quantized too, although the reference's docstring says
embeddings stay high-precision; the port keeps the reference's
behaviour (ROADMAP queue 3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.kernels.quant_matmul.ref import dequant_ref, quantize_ref


@dataclasses.dataclass
class QuantizedTensor:
    w_q: torch.Tensor       # int8 storage of int4/int8 values, (k, n)
    scales: torch.Tensor    # (k // group, n) bf16
    zeros: torch.Tensor     # (k // group, n) bf16
    group_size: int
    bits: int

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.w_q.shape)

    def storage_bytes(self) -> int:
        """Deployable-layout bytes: packed weights + bf16 scales + packed
        integer zero-points (paper Appendix 8.1: zeros at the weight
        width).  In memory the zeros stay bf16 for compute convenience."""
        per_el = 0.5 if self.bits == 4 else 1.0
        return int(self.w_q.numel() * per_el + self.scales.numel() * 2
                   + self.zeros.numel() * per_el)


def quantize_weight(w: torch.Tensor, *, group_size: int = 128,
                    bits: int = 4) -> QuantizedTensor:
    """(k, n) weight -> per-group quantized representation, on w's device."""
    if w.dim() != 2 or w.shape[0] % group_size:
        raise ValueError(f"quantize_weight takes a (k, n) weight with k a "
                         f"multiple of group_size={group_size}, got "
                         f"{tuple(w.shape)}")
    if bits == 4:
        w_q, sc, z = quantize_ref(w.float(), group_size)
    else:  # int8: same scheme, 255 levels
        k, n = w.shape
        wg = w.float().reshape(k // group_size, group_size, n)
        wmin, wmax = wg.amin(dim=1), wg.amax(dim=1)
        # a tensor divisor: a true quotient on the card too (ref.py)
        sc = torch.clamp((wmax - wmin) / torch.full_like(wmax, 255.0),
                         min=1e-8)
        z = torch.round(-wmin / sc) - 128.0
        w_q = torch.clamp(torch.round(wg / sc[:, None, :]) + z[:, None, :],
                          -128, 127).to(torch.int8).reshape(k, n)
        sc, z = sc.to(torch.bfloat16), z.to(torch.bfloat16)
    return QuantizedTensor(w_q=w_q, scales=sc, zeros=z,
                           group_size=group_size, bits=bits)


def dequantize_weight(q: QuantizedTensor,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return dequant_ref(q.w_q, q.scales, q.zeros, q.group_size).to(dtype)


def quant_dense(x: torch.Tensor, q: QuantizedTensor, *,
                use_kernel: bool = True) -> torch.Tensor:
    """y = x @ dequant(q) — through the dequant-matmul kernel's wrapper
    (the kernel on a CUDA tensor, its plain version on a CPU one), or
    with ``use_kernel=False`` as a product with the dequantized weight."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if use_kernel:
        y = quant_matmul(x2.contiguous(), q.w_q, q.scales, q.zeros,
                         group_size=q.group_size)
    else:
        y = x2 @ dequantize_weight(q, x.dtype)
    return y.reshape(*lead, q.w_q.shape[1])


def quantize_tree(params: Dict, *, group_size: int = 128, bits: int = 4,
                  min_size: int = 1 << 16) -> Dict:
    """Quantize every large 2-D matmul weight in a nested-dict param tree
    (2-D, ``numel >= min_size``, ``shape[0] % group_size == 0``); other
    leaves are returned as they are."""
    def visit(leaf):
        if isinstance(leaf, dict):
            return {k: visit(v) for k, v in leaf.items()}
        if (isinstance(leaf, torch.Tensor) and leaf.dim() == 2
                and leaf.numel() >= min_size
                and leaf.shape[0] % group_size == 0):
            return quantize_weight(leaf, group_size=group_size, bits=bits)
        return leaf

    return visit(params)


def tree_storage_bytes(params: Dict) -> int:
    """Deployable bytes of a (partly) quantized tree: each
    :class:`QuantizedTensor`'s :meth:`~QuantizedTensor.storage_bytes`
    plus every other tensor's in-memory bytes."""
    if isinstance(params, dict):
        return sum(tree_storage_bytes(v) for v in params.values())
    if isinstance(params, QuantizedTensor):
        return params.storage_bytes()
    return params.numel() * params.element_size()
