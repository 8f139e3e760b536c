"""Plain PyTorch versions of the int4 dequant-matmul kernel (the JAX
package's ``kernels/quant_matmul/ref.py`` oracle).

Everything is f32 and follows the reference's order of operations:
``(w_q - zero) * scale`` in f32, the product in f32, then one cast to x's
dtype.  The wrapper in ``ops.py`` computes :func:`quant_matmul_ref` for
tensors on the CPU; ``chip_smoke.py`` holds the CUDA kernel to it on the
card.  :func:`quantize_ref` gives the reference's ``w_q``, bf16 scales and
bf16 zeros bit for bit, on the CPU and on the card: both libraries round
half to even, the q values come from the f32 scale, and the scale is cast
to bf16 only after them.  Every division is tensor by tensor: on a CUDA
tensor, torch divides by a Python scalar as a product with its
reciprocal, which rounds some scales one ulp away from the true quotient
(and with them some q values).
"""
from __future__ import annotations

import torch


def dequant_ref(w_q: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
                group_size: int = 128) -> torch.Tensor:
    """(k, n) int4-valued int8 + per-group scale/zero -> f32 weights."""
    k, n = w_q.shape
    g = group_size
    wq = w_q.float().reshape(k // g, g, n)
    w = (wq - zeros[:, None, :].float()) * scales[:, None, :].float()
    return w.reshape(k, n)


def quant_matmul_ref(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor,
                     zeros: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    w = dequant_ref(w_q, scales, zeros, group_size)
    return (x.float() @ w).to(x.dtype)


def quantize_ref(w: torch.Tensor, group_size: int = 128):
    """Symmetric-ish per-group int4 quantization of (k, n) weights:
    ``(w_q int8 in [-8, 7], scale bf16, zero bf16)``."""
    k, n = w.shape
    g = group_size
    wg = w.float().reshape(k // g, g, n)
    wmin = wg.amin(dim=1)
    wmax = wg.amax(dim=1)
    scale = torch.clamp((wmax - wmin) / torch.full_like(wmax, 15.0), min=1e-8)
    zero = torch.round(-wmin / scale) - 8.0
    q = torch.clamp(torch.round(wg / scale[:, None, :]) + zero[:, None, :],
                    -8, 7).to(torch.int8)
    return q.reshape(k, n), scale.to(torch.bfloat16), zero.to(torch.bfloat16)
