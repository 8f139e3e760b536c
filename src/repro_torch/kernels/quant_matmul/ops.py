"""Public wrapper of the int4 dequant-matmul kernel.

``quant_matmul`` takes the signature of the JAX package's
``kernels/quant_matmul/ops.py`` (without its TPU tile sizes).  For tensors
on a CUDA device it launches the hand-written Hopper kernel of
``csrc/quant_matmul.cu`` (built on first use, bound with ``ctypes``) on
the current stream, or raises; nothing falls back.  For tensors on the
CPU it computes the plain version of ``ref.py``.

``LAUNCHES`` counts the kernel's launches, so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels import build as _build
from .ref import dequant_ref, quant_matmul_ref, quantize_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "quant_matmul.cu"
LIBRARY_NAME = "quant_matmul"

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"quant_matmul": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_M_TILES = 65535          # the kernel's grid.y, 16 rows each

_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build(SOURCE, LIBRARY_NAME).path))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.quant_matmul_launch.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
        lib.quant_matmul_launch.restype = I
        lib.quant_matmul_error_string.argtypes = [I]
        lib.quant_matmul_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor,
           zeros: torch.Tensor, group_size: int) -> None:
    """What both paths take: x (m, k), w_q (k, n), scale and zero
    (k / group_size, n), with group_size dividing k."""
    if x.dim() != 2 or w_q.dim() != 2:
        raise ValueError(f"quant_matmul takes x (m, k) and w_q (k, n), got "
                         f"{tuple(x.shape)}, {tuple(w_q.shape)}")
    m, k = x.shape
    k2, n = w_q.shape
    if k2 != k:
        raise ValueError(f"x {tuple(x.shape)} and w_q {tuple(w_q.shape)} "
                         f"disagree on k")
    if group_size < 1 or k % group_size:
        raise ValueError(f"group_size {group_size} does not divide k={k}")
    want = (k // group_size, n)
    if tuple(scales.shape) != want or tuple(zeros.shape) != want:
        raise ValueError(f"scales/zeros must be {want}, got "
                         f"{tuple(scales.shape)}/{tuple(zeros.shape)}")


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor,
                 zeros: torch.Tensor, *, group_size: int = 128) -> torch.Tensor:
    """``x @ ((w_q - zero) * scale)`` per group of ``group_size`` k rows.

    x: (m, k) f32 or bf16; w_q: (k, n) int8 holding int4 (or int8)
    values, one per byte; scales, zeros: (k / group_size, n) bf16.
    Accumulates in f32; returns (m, n) in x's dtype."""
    _check(x, w_q, scales, zeros, group_size)
    if not x.is_cuda:
        return quant_matmul_ref(x, w_q, scales, zeros, group_size)
    m, k = x.shape
    n = w_q.shape[1]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"quant_matmul takes f32 or bf16 x, got {x.dtype}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, got {w_q.dtype}")
    if scales.dtype != torch.bfloat16 or zeros.dtype != torch.bfloat16:
        raise TypeError(f"scales and zeros must be bf16, got "
                        f"{scales.dtype}/{zeros.dtype}")
    for name, t in (("x", x), ("w_q", w_q), ("scales", scales),
                    ("zeros", zeros)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if -(-m // 16) > _MAX_M_TILES:
        raise ValueError(f"quant_matmul takes at most {16 * _MAX_M_TILES} "
                         f"rows, got m={m}")
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.quant_matmul_launch(
        x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        out.data_ptr(), m, k, n, group_size, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul launch failed: "
                           f"{lib.quant_matmul_error_string(err).decode()}")
    LAUNCHES["quant_matmul"] += 1
    return out


__all__ = ["LAUNCHES", "dequant_ref", "load_library", "quant_matmul",
           "quant_matmul_ref", "quantize_ref", "reset_launch_counts"]
