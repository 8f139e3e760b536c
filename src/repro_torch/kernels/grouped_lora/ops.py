"""Public wrapper of the grouped-LoRA kernel.

``grouped_lora`` takes the signature of the JAX package's
``kernels/grouped_lora/ops.py``.  For tensors on a CUDA device it launches
the hand-written Hopper kernel of ``csrc/grouped_lora.cu`` (built on first
use, bound with ``ctypes``) on the current stream, or raises; nothing
falls back.  For tensors on the CPU it computes the plain version of
``ref.py``.

``LAUNCHES`` counts the kernel's launches, so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels import build as _build
from .ref import grouped_lora_pregathered, grouped_lora_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "grouped_lora.cu"
LIBRARY_NAME = "grouped_lora"

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"grouped_lora": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

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
        lib.grouped_lora_launch.argtypes = [P, P, P, P, P, I, I, I, I, I, I,
                                            I, I, ctypes.c_float, P]
        lib.grouped_lora_launch.restype = I
        lib.grouped_lora_max_rank.argtypes = []
        lib.grouped_lora_max_rank.restype = I
        lib.grouped_lora_error_string.argtypes = [I]
        lib.grouped_lora_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def grouped_lora(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 idx: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Grouped low-rank delta ``scale·(x @ A[idx]) @ B[idx]``.

    x: (S, T, k); A: (P, k, R); B: (P, R, n); idx: (S,) int32 pool slots
    (-1 = no adapter -> exact-zero delta).  Returns (S, T, n) in x.dtype.
    A slot ``>= P`` is a fault: the plain version raises ``IndexError``,
    the kernel traps, which CUDA reports as a device-side assert at the
    next synchronisation, as it does for torch's own indexing.
    """
    if not x.is_cuda:
        return grouped_lora_ref(x, A, B, idx, scale)
    if x.dim() != 3 or A.dim() != 3 or B.dim() != 3:
        raise ValueError(f"grouped LoRA takes x (S,T,k), A (P,k,R), "
                         f"B (P,R,n); got {tuple(x.shape)}, "
                         f"{tuple(A.shape)}, {tuple(B.shape)}")
    S, T, k = x.shape
    P, k2, R = A.shape
    P2, R2, n = B.shape
    if k2 != k or P2 != P or R2 != R:
        raise ValueError(f"inconsistent grouped-LoRA operands: x "
                         f"{tuple(x.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)}")
    if x.dtype not in _DTYPE_CODES or A.dtype not in _DTYPE_CODES \
            or B.dtype != A.dtype:
        raise TypeError(f"grouped LoRA takes f32/bf16 x and factors of one "
                        f"f32/bf16 dtype, got {x.dtype}, {A.dtype}/{B.dtype}")
    for name, t in (("x", x), ("A", A), ("B", B)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if (idx.dtype != torch.int32 or tuple(idx.shape) != (S,)
            or idx.device != x.device or not idx.is_contiguous()):
        raise ValueError(f"idx must be a contiguous int32 ({S},) tensor on "
                         f"{x.device}, got {idx.dtype} {tuple(idx.shape)} "
                         f"on {idx.device}")
    out = torch.empty((S, T, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    if not 1 <= R <= lib.grouped_lora_max_rank():
        raise ValueError(f"grouped LoRA takes a padded pool rank in "
                         f"[1, {lib.grouped_lora_max_rank()}], got {R}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.grouped_lora_launch(
        x.data_ptr(), A.data_ptr(), B.data_ptr(), idx.data_ptr(),
        out.data_ptr(), S, T, k, R, n, P, _DTYPE_CODES[x.dtype],
        _DTYPE_CODES[A.dtype], float(scale), stream)
    if err != 0:
        raise RuntimeError(f"grouped_lora launch failed: "
                           f"{lib.grouped_lora_error_string(err).decode()}")
    LAUNCHES["grouped_lora"] += 1
    return out


__all__ = ["LAUNCHES", "grouped_lora", "grouped_lora_pregathered",
           "grouped_lora_ref", "load_library", "reset_launch_counts"]
