"""Public wrappers of the grouped-LoRA kernel.

``grouped_lora`` takes the signature of the JAX package's
``kernels/grouped_lora/ops.py``; ``grouped_lora_qkv`` computes the deltas
of three projections of one ``x`` (q, k and v) in one launch.  For tensors
on a CUDA device they launch the hand-written Hopper kernels of
``csrc/grouped_lora.cu`` (built on first use, bound with ``ctypes``) on the
current stream, or raise; nothing falls back.  For tensors on the CPU they
compute the plain version of ``ref.py``.

The kernel runs in two launches: ``x @ A`` once, its k split over blocks
as :func:`split_plan` says, then ``@ B``.

``LAUNCHES`` counts the kernel's launches by wrapper (one per call of
either), so a run can show that its main path went through it.  Each
launch also reports its work (:func:`grouped_lora_cost`) to an active
work count (``repro_torch.core.counts``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import counts as _counts
from repro_torch.kernels import build as _build
from .ref import grouped_lora_pregathered, grouped_lora_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "grouped_lora.cu"
LIBRARY_NAME = "grouped_lora"

#: kernel launches per wrapper since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"grouped_lora": 0, "grouped_lora_qkv": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROWS = 16               # rows of x per block (the kernel's kRows)
COLS = 64               # output columns per tile (kCols)
MIN_K_SLICE = 64        # least k per slice of phase 1
MAX_SPLITS = 32         # most slices of k

_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class SplitPlan(NamedTuple):
    splits: int         # k slices of phase 1
    k_split: int        # k per slice, a multiple of 8
    col_tiles: int      # 64-column tiles per phase-2 block


def split_plan(S: int, T: int, k: int, ns: Sequence[int],
               sm_count: int) -> SplitPlan:
    """The kernel's grid on a card of ``sm_count`` SMs.  Phase 1 splits k
    until its (slices x row tiles x slots) blocks fill two per SM, each
    slice keeping at least 64 of k and at most 32 slices, since phase 2
    adds a row's slices in a chain (on an H100, 64 slices cost more there
    than they saved in phase 1).  Phase 2 gives a block up to 4 column
    tiles while its grid still fills two blocks per SM, so that each block
    re-reads the partial sums for more columns."""
    blocks = -(-T // ROWS) * S
    want = max(1, min(-(-2 * sm_count // blocks), k // MIN_K_SLICE,
                      MAX_SPLITS))
    k_split = 8 * -(-k // (8 * want))
    splits = -(-k // k_split)
    tiles = sum(-(-n // COLS) for n in ns)
    col_tiles = max(1, min(4, tiles * blocks // (2 * sm_count)))
    return SplitPlan(splits, k_split, col_tiles)


def grouped_lora_cost(x: torch.Tensor,
                      factors: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                      ) -> _counts.KernelCost:
    """K4's work for x (S, T, k) and each ``(A (P, k, R), B (P, R, n))``:
    ``x @ A[idx]`` and ``@ B[idx]`` for every slot (2·k·R + 2·R·n FLOPs
    per row and projection); bytes: x and the outputs once, each slot's
    factors once, idx."""
    S, T, k = x.shape
    flops = nbytes = 0.0
    for A, B in factors:
        R, n = A.shape[-1], B.shape[-1]
        flops += 2.0 * S * T * (k * R + R * n)
        nbytes += (S * T * n * x.element_size()
                   + S * (k * R + R * n) * A.element_size())
    return _counts.KernelCost(flops, nbytes + x.numel() * x.element_size()
                              + 4 * S)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build(SOURCE, LIBRARY_NAME).path))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.grouped_lora_launch.argtypes = (
            [P, P] + [P, P, P, I] * 3
            + [I, I, I, I, I, I, I, I, ctypes.c_float, P, I, I, I, P])
        lib.grouped_lora_launch.restype = I
        lib.grouped_lora_max_rank.argtypes = []
        lib.grouped_lora_max_rank.restype = I
        lib.grouped_lora_error_string.argtypes = [I]
        lib.grouped_lora_error_string.restype = ctypes.c_char_p
        _build.note_load(LIBRARY_NAME)
        _lib = lib
    return _lib


def _launch(wrapper: str, x: torch.Tensor,
            factors: Sequence[Tuple[torch.Tensor, torch.Tensor]],
            idx: torch.Tensor, scale: float) -> Tuple[torch.Tensor, ...]:
    """Check the operands, launch the kernel for every (A, B) of ``x``,
    and return the deltas."""
    if x.dim() != 3:
        raise ValueError(f"grouped LoRA takes x (S,T,k), got {tuple(x.shape)}")
    S, T, k = x.shape
    A0 = factors[0][0]
    if A0.dim() != 3:
        raise ValueError(f"grouped LoRA takes A (P,k,R), got {tuple(A0.shape)}")
    P, _, R = A0.shape
    for A, B in factors:
        if A.dim() != 3 or B.dim() != 3 or tuple(A.shape) != (P, k, R) \
                or tuple(B.shape[:2]) != (P, R):
            raise ValueError(f"inconsistent grouped-LoRA operands: x "
                             f"{tuple(x.shape)}, A {tuple(A.shape)}, "
                             f"B {tuple(B.shape)}")
        if x.dtype not in _DTYPE_CODES or A.dtype not in _DTYPE_CODES \
                or B.dtype != A.dtype or A.dtype != A0.dtype:
            raise TypeError(f"grouped LoRA takes f32/bf16 x and factors of "
                            f"one f32/bf16 dtype, got {x.dtype}, "
                            f"{A.dtype}/{B.dtype}")
        for name, t in (("A", A), ("B", B)):
            if t.device != x.device or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"x must be contiguous on {x.device}")
    if (idx.dtype != torch.int32 or tuple(idx.shape) != (S,)
            or idx.device != x.device or not idx.is_contiguous()):
        raise ValueError(f"idx must be a contiguous int32 ({S},) tensor on "
                         f"{x.device}, got {idx.dtype} {tuple(idx.shape)} "
                         f"on {idx.device}")
    ns = [B.shape[2] for _, B in factors]
    outs = tuple(torch.empty((S, T, n), dtype=x.dtype, device=x.device)
                 for n in ns)
    if S * T == 0 or k == 0:
        for o in outs:
            o.zero_()
        return outs
    lib = load_library()
    if not 1 <= R <= lib.grouped_lora_max_rank():
        raise ValueError(f"grouped LoRA takes a padded pool rank in "
                         f"[1, {lib.grouped_lora_max_rank()}], got {R}")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = split_plan(S, T, k, ns, sms)
    partial = torch.empty((plan.splits, S, T, len(factors) * R),
                          dtype=torch.float32, device=x.device)
    projections = []
    for (A, B), o in zip(factors, outs):
        projections += [A.data_ptr(), B.data_ptr(), o.data_ptr(), o.shape[2]]
    projections += [None, None, None, 0] * (3 - len(factors))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.grouped_lora_launch(
        x.data_ptr(), idx.data_ptr(), *projections, len(factors), S, T, k,
        R, P, _DTYPE_CODES[x.dtype], _DTYPE_CODES[A0.dtype], float(scale),
        partial.data_ptr(), plan.splits, plan.k_split, plan.col_tiles, stream)
    if err != 0:
        raise RuntimeError(f"{wrapper} launch failed: "
                           f"{lib.grouped_lora_error_string(err).decode()}")
    LAUNCHES[wrapper] += 1
    if _counts.ACTIVE is not None:
        _counts.report_kernel(wrapper, grouped_lora_cost(x, factors))
    return outs


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
    return _launch("grouped_lora", x, [(A, B)], idx, scale)[0]


def grouped_lora_qkv(x: torch.Tensor,
                     q: Tuple[torch.Tensor, torch.Tensor],
                     k: Tuple[torch.Tensor, torch.Tensor],
                     v: Tuple[torch.Tensor, torch.Tensor],
                     idx: torch.Tensor, scale: float = 1.0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The q, k and v deltas of one ``x`` from one launch: each
    ``(A, B)`` pair as :func:`grouped_lora` takes it, one pool (P, k, R)
    for the three A's, each B its own n.  Returns ``(dq, dk, dv)``; on
    the CPU, three :func:`grouped_lora_ref` calls."""
    if not x.is_cuda:
        return tuple(grouped_lora_ref(x, A, B, idx, scale)
                     for A, B in (q, k, v))
    return _launch("grouped_lora_qkv", x, [q, k, v], idx, scale)


def make_sharded_grouped_lora(group, *, qkv=grouped_lora_qkv,
                              one=grouped_lora):
    """Grouped LoRA over the rank axis of a tensor-parallel ``group`` (the
    reference's ``shard_map`` of the kernel, its ``ops.py:46``).

    Each rank holds ``R/tp`` rank lanes of every pooled adapter: A's
    columns ``(P, k, R/tp)`` and B's rows ``(P, R/tp, n)``; ``x`` and
    ``idx`` are whole.  Its delta over those lanes is a partial sum of the
    whole delta (disjoint lanes: the unsharded contraction reassociated),
    and the partials are summed over the group.  Returns ``(qkv, one)``:

    * ``qkv(x, (A_q, B_q), (A_k, B_k), (A_v, B_v), idx)`` computes the
      three deltas (one launch of the kernel) and sums them in one
      ``all_reduce`` of their concatenation;
    * ``one(x, A, B, idx)`` returns the rank's partial delta unsummed: its
      caller adds it to a row-parallel product whose own ``all_reduce``
      then sums both (the engine's o projection), one collective fewer.

    ``qkv`` and ``one`` default to the kernel's wrappers; the engine's
    ``gather`` route passes its plain pregathered products."""
    from repro_torch.core.collectives import all_reduce

    def sharded_qkv(x, q, k, v, idx):
        parts = qkv(x, q, k, v, idx)
        flat = torch.cat(parts, dim=-1)
        all_reduce(flat, group)
        return tuple(flat.split([d.shape[-1] for d in parts], dim=-1))

    return sharded_qkv, one


__all__ = ["LAUNCHES", "SplitPlan", "grouped_lora", "grouped_lora_cost",
           "grouped_lora_pregathered", "grouped_lora_qkv", "grouped_lora_ref",
           "load_library", "make_sharded_grouped_lora",
           "reset_launch_counts", "split_plan"]
