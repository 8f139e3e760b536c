"""Public wrapper of the int4 dequant-matmul kernel.

``quant_matmul`` takes the signature of the JAX package's
``kernels/quant_matmul/ops.py`` (without its TPU tile sizes).  For tensors
on a CUDA device it launches one of the two hand-written Hopper bodies of
``csrc/quant_matmul.cu`` (built on first use, bound with ``ctypes``) on
the current stream, or raises; nothing falls back.  For tensors on the
CPU it computes the plain version of ``ref.py``.

Which body runs (:func:`qmm_body`): bf16 x with at least
:data:`WGMMA_MIN_ROWS` rows, a group size that is a multiple of 64 and n
a multiple of 16 goes to ``wgmma`` (tensor cores); every other call
(small m, f32 x, other group sizes or widths) goes to ``splitk`` (CUDA
cores, k split across blocks as :func:`splitk_plan` says).

``LAUNCHES`` counts the calls that launched a kernel, so a run can show
that its main path went through it; ``BODY_LAUNCHES`` counts them by body.
Each launch also reports its work (:func:`quant_matmul_cost`) to an
active work count (``repro_torch.core.counts``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.core import counts as _counts
from repro_torch.kernels import build as _build
from .ref import dequant_ref, quant_matmul_ref, quantize_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "quant_matmul.cu"
LIBRARY_NAME = "quant_matmul"

#: calls that launched the kernel since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"quant_matmul": 0}
#: the same calls by body
BODY_LAUNCHES: Dict[str, int] = {"wgmma": 0, "splitk": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: bf16 x with at least this many rows runs on the tensor cores: measured
#: on the H100 by chip_smoke.py's kernels phase, wgmma is the faster body
#: from m = 16 at 4096 x 4096 and from m = 8 at lm_head's 4096 x 32000
WGMMA_MIN_ROWS = 16
#: the splitk body's tile: rows per block (templated in the kernel) and
#: columns per block
SPLITK_ROWS = (1, 2, 4, 8, 16)
SPLITK_COLS = 128
#: the wgmma body's output tile
WGMMA_ROWS, WGMMA_COLS = 128, 128
_MAX_GRID_YZ = 65535


class SplitPlan(NamedTuple):
    rows: int               # m rows per block (the kernel's template M)
    splits: int             # k ranges, one per grid.y
    groups_per_split: int
    scratch: Optional[tuple]  # (splits, m, n) f32 partials, or None


def qmm_body(dtype: torch.dtype, m: int, n: int, group_size: int) -> str:
    """``"wgmma"`` for bf16 x with m >= WGMMA_MIN_ROWS, a group size that
    is a multiple of its 64-row k tile and n a multiple of 16 (w_q's rows
    are strides of a TMA tensor map); else ``"splitk"``."""
    if (dtype == torch.bfloat16 and m >= WGMMA_MIN_ROWS
            and group_size % 64 == 0 and n % 16 == 0):
        return "wgmma"
    return "splitk"


def _plan(rows: int, cols: int, m: int, k: int, n: int, group_size: int,
          sm_count: int) -> SplitPlan:
    groups = k // group_size
    tiles = -(-n // cols) * -(-m // rows)
    splits = max(1, min(groups, _MAX_GRID_YZ, -(-2 * sm_count // tiles)))
    gps = -(-groups // splits)
    splits = -(-groups // gps)
    return SplitPlan(rows, splits, gps, (splits, m, n) if splits > 1 else None)


def splitk_plan(m: int, k: int, n: int, group_size: int,
                sm_count: int = 132) -> SplitPlan:
    """The splitk body's grid: the smallest row tile that holds m (16 rows
    per tile above that), 128 columns per block, and k split into ranges
    of whole groups until the grid has at least two blocks per SM, as
    many as are resident at once (or every group is a range of its own).
    Splits > 1 write f32 partials to a (splits, m, n) scratch that a
    second pass adds in split order."""
    rows = next((r for r in SPLITK_ROWS if m <= r), SPLITK_ROWS[-1])
    return _plan(rows, SPLITK_COLS, m, k, n, group_size, sm_count)


def wgmma_plan(m: int, k: int, n: int, group_size: int,
               sm_count: int = 132) -> SplitPlan:
    """The wgmma body's grid: 128 x 128 output tiles, and k split as in
    :func:`splitk_plan` when the tiles alone give fewer than two blocks
    per SM (a 4096 x 4096 projection at m = 64 has 32 tiles)."""
    return _plan(WGMMA_ROWS, WGMMA_COLS, m, k, n, group_size, sm_count)


_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, BODY_LAUNCHES):
        for k in counts:
            counts[k] = 0


def quant_matmul_cost(x: torch.Tensor, w_q: torch.Tensor,
                      scales: torch.Tensor) -> _counts.KernelCost:
    """K5's work for x (m, k) @ w_q (k, n): 2·m·k·n FLOPs; bytes: x,
    the int8 weights, the scales and zeros, and the output once."""
    m, k = x.shape
    n = w_q.shape[1]
    nbytes = (x.numel() * x.element_size() + w_q.numel()
              + 2 * scales.numel() * scales.element_size()
              + m * n * x.element_size())
    return _counts.KernelCost(2.0 * m * k * n, float(nbytes))


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build(SOURCE, LIBRARY_NAME).path))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.quant_matmul_splitk_launch.argtypes = [P, P, P, P, P, P, I, I, I,
                                                   I, I, I, I, I, P]
        lib.quant_matmul_splitk_launch.restype = I
        lib.quant_matmul_wgmma_launch.argtypes = [P, P, P, P, P, P, I, I, I,
                                                  I, I, I, P]
        lib.quant_matmul_wgmma_launch.restype = I
        lib.quant_matmul_error_string.argtypes = [I]
        lib.quant_matmul_error_string.restype = ctypes.c_char_p
        _build.note_load(LIBRARY_NAME)
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
        if t.data_ptr() % 16:             # the kernels' vector loads
            raise ValueError(f"{name} must start on a 16-byte boundary")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    body = qmm_body(x.dtype, m, n, group_size)
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
            zeros.data_ptr(), out.data_ptr())
    plan = (wgmma_plan if body == "wgmma" else splitk_plan)(
        m, k, n, group_size, _sm_count(x.device))
    scratch = (torch.empty(plan.scratch, dtype=torch.float32,
                           device=x.device).data_ptr()
               if plan.scratch is not None else None)
    if body == "wgmma":
        err = lib.quant_matmul_wgmma_launch(
            *ptrs, scratch, m, k, n, group_size, plan.splits,
            plan.groups_per_split, stream)
    else:
        if -(-m // plan.rows) > _MAX_GRID_YZ:
            raise ValueError(f"quant_matmul takes at most "
                             f"{plan.rows * _MAX_GRID_YZ} rows, got m={m}")
        err = lib.quant_matmul_splitk_launch(
            *ptrs, scratch, m, k, n, group_size, _DTYPE_CODES[x.dtype],
            plan.rows, plan.splits, plan.groups_per_split, stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul ({body}) launch failed: "
                           f"{lib.quant_matmul_error_string(err).decode()}")
    LAUNCHES["quant_matmul"] += 1
    if _counts.ACTIVE is not None:
        _counts.report_kernel("quant_matmul",
                              quant_matmul_cost(x, w_q, scales))
    BODY_LAUNCHES[body] += 1
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


__all__ = ["BODY_LAUNCHES", "LAUNCHES", "SplitPlan", "WGMMA_MIN_ROWS",
           "dequant_ref", "load_library", "qmm_body", "quant_matmul",
           "quant_matmul_cost",
           "quant_matmul_ref", "quantize_ref", "reset_launch_counts",
           "splitk_plan", "wgmma_plan"]
