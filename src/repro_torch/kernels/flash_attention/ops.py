"""Public wrapper of the flash attention kernels.

``flash_attention`` takes the signature of the JAX package's
``kernels/flash_attention/ops.py`` and is differentiable: a
``torch.autograd.Function`` whose forward launches ``flash_fwd_kernel``
(saving q, k, v, o and the rows' log-sum-exp) and whose backward launches
the backward kernels of ``csrc/flash_attention.cu`` (built on first use,
bound with ``ctypes``, on the current stream).  For CUDA tensors it
launches them or raises; nothing falls back.  For tensors on the CPU it
computes the plain version of ``ref.py`` as the JAX package's function
does on the CPU: the forward is the oracle's output with every row that
sees no key set to 0 (what the kernels write), and the backward is the
oracle's VJP (the reference's ``_fa_bwd``).

Each direction has two bodies (:func:`flash_body`): bf16 q, k, v with a
head dim that is a multiple of 16 up to 128 run on the tensor cores
(``mma``: ``flash_fwd_mma_kernel``, ``flash_bwd_dkdv_mma_kernel``,
``flash_bwd_dq_mma_kernel``); f32, or a head dim the tensor-core body
does not take, keep the f32 CUDA-core body (``fma``: ``flash_fwd_kernel``
and its three backward kernels).  :func:`mma_tiles`,
:func:`key_tile_range` and :func:`query_tile_range` are the ``mma``
body's tiles and loop bounds, as the CUDA source computes them.

``LAUNCHES`` counts kernel launches: ``flash_fwd`` one per forward launch
(under per-layer remat the forward runs twice per layer and step),
``flash_bwd`` one per backward call (its three kernels together);
``BODY_LAUNCHES`` counts each by body.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build as _build
from .ref import attention_ref, live_rows

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
LIBRARY_NAME = "flash_attention"

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd": 0}
#: each wrapper's launches by body
BODY_LAUNCHES: Dict[str, Dict[str, int]] = {
    "flash_fwd": {"mma": 0, "fma": 0}, "flash_bwd": {"mma": 0, "fma": 0}}
BODIES = ("mma", "fma")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256

_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for counts in BODY_LAUNCHES.values():
        for k in counts:
            counts[k] = 0


def flash_body(dtype: torch.dtype, d: int) -> str:
    """The body a call runs on, forward and backward alike.

    ``"mma"`` (tensor cores: bf16 products, f32 sums and softmax, P.V as
    P_hi.V + P_lo.V) for bf16 with ``d % 16 == 0`` and ``16 <= d <= 128``
    (one k16 step per 16 columns; 128 keeps the dK/dV accumulators in
    registers).  ``"fma"`` (f32 on the CUDA cores) for everything else:
    f32 inputs, whose gradients must stay within 1e-5 of the f32 plain
    version, which bf16 tensor-core operands would not; a bf16 head dim
    that is not a multiple of 16; and d > 128 (up to 256).
    """
    if dtype == torch.bfloat16 and d % 16 == 0 and 16 <= d <= 128:
        return "mma"
    return "fma"


@dataclasses.dataclass(frozen=True)
class MmaTiles:
    """The ``mma`` body's tiles for one head dim (``flash_attention.cu``):
    ``dp`` the head dim padded to 64 or 128 (zero columns); the forward's
    query rows and keys per step; dK/dV's keys per block and query rows
    per step; dQ's query rows per block and keys per step."""
    dp: int
    fwd_rows: int
    fwd_keys: int
    dkdv_keys: int
    dkdv_rows: int
    dq_rows: int
    dq_keys: int


def mma_tiles(d: int) -> MmaTiles:
    """Four warps of 16 rows (or keys) per block; at dp = 128 the
    backward's inner tile halves so that its f32 accumulators, the score
    tile and dP stay in registers."""
    if flash_body(torch.bfloat16, d) != "mma":
        raise ValueError(f"the mma body takes d % 16 == 0 <= 128, got {d}")
    dp = 64 if d <= 64 else 128
    inner = 64 if dp == 64 else 32
    return MmaTiles(dp=dp, fwd_rows=64, fwd_keys=64, dkdv_keys=64,
                    dkdv_rows=inner, dq_rows=64, dq_keys=inner)


def key_tile_range(i0: int, rows: int, s: int, L: int, *, causal: bool,
                   window: Optional[int], q_offset: int,
                   tile: int) -> range:
    """Starts of the key tiles that query rows ``[i0, i0 + rows)`` visit:
    every tile holding a key one of them attends; the tiles outside it
    are masked wholly for these rows, and skipping them changes nothing."""
    last = min(i0 + rows, s) - 1
    k_hi = min(L, q_offset + last + 1) if causal else L
    k_lo = max(0, q_offset + i0 - window + 1) if window else 0
    return range((k_lo // tile) * tile, k_hi, tile)


def query_tile_range(t0: int, keys: int, s: int, L: int, *, causal: bool,
                     window: Optional[int], q_offset: int,
                     tile: int) -> range:
    """Starts of the query tiles that attend keys ``[t0, t0 + keys)``
    (the dK/dV block's loop, per query head of its group)."""
    t_last = min(t0 + keys, L) - 1
    i_lo = max(0, t0 - q_offset) if causal else 0
    i_hi = min(s, t_last + window - q_offset) if window else s
    return range((i_lo // tile) * tile, i_hi, tile)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build(SOURCE, LIBRARY_NAME).path))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd_launch.argtypes = [P, P, P, P, P] + [I] * 10 + [
            ctypes.c_float, P]
        lib.flash_fwd_launch.restype = I
        lib.flash_bwd_launch.argtypes = [P] * 10 + [I] * 10 + [
            ctypes.c_float, P]
        lib.flash_bwd_launch.restype = I
        lib.flash_fwd_mma_launch.argtypes = [P, P, P, P, P] + [I] * 9 + [
            ctypes.c_float, P]
        lib.flash_fwd_mma_launch.restype = I
        lib.flash_bwd_mma_launch.argtypes = [P] * 10 + [I] * 9 + [
            ctypes.c_float, P]
        lib.flash_bwd_mma_launch.restype = I
        lib.flash_mma_tiles.argtypes = [I, P]
        lib.flash_mma_tiles.restype = I
        lib.flash_error_string.argtypes = [I]
        lib.flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], q_offset: int) -> Tuple[int, ...]:
    """Validate what the kernels take; returns (b, s, L, H, Hk, d)."""
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernels take f32 or bf16 q, k, v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (b, s, H, d) and k, v (b, L, Hk, d), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, H, d = q.shape
    _, L, Hk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or Hk < 1 or H % Hk:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (batch, head dim, H % Hk)")
    if not (s >= 1 and L >= 1 and 1 <= d <= _MAX_HEAD_DIM):
        raise ValueError(f"flash attention kernels take s, L >= 1 and "
                         f"1 <= d <= {_MAX_HEAD_DIM}, got s={s} L={L} d={d}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    return b, s, L, H, Hk, d


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.flash_error_string(err).decode()}")


def _pick_body(q: torch.Tensor, d: int, body: Optional[str],
               tensors) -> str:
    """:func:`flash_body`'s choice, or ``body`` where the caller forces
    one (the tests hold both bodies on the same inputs); the ``mma``
    body's 16-byte copies need 16-byte aligned tensors."""
    rule = flash_body(q.dtype, d)
    if body is None:
        body = rule
    if body not in BODIES:
        raise ValueError(f"body must be one of {BODIES}, got {body!r}")
    if body == "mma":
        if rule != "mma":
            raise ValueError(f"the mma body takes bf16 with d % 16 == 0 "
                             f"<= 128, got {q.dtype}, d={d}")
        for t in tensors:
            if t.data_ptr() % 16:
                raise ValueError("the mma body needs 16-byte aligned "
                                 "tensors")
    return body


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, body: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel of :func:`flash_body`'s body (or of
    ``body``): (o (b, s, H, d) in q's dtype, the rows' log-sum-exp
    (b, H, s) f32).  CUDA tensors only."""
    if not q.is_cuda:
        raise ValueError("flash_fwd launches the CUDA kernel; CPU tensors "
                         "go through flash_attention's plain version")
    b, s, L, H, Hk, d = _check(q, k, v, window, q_offset)
    body = _pick_body(q, d, body, (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((b, H, s), dtype=torch.float32, device=q.device)
    lib = load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, s, L, H, Hk, d, int(causal), window or 0,
            q_offset)
    if body == "mma":
        err = lib.flash_fwd_mma_launch(*args, d ** -0.5, stream)
    else:
        err = lib.flash_fwd_launch(*args, _DTYPE_CODES[q.dtype], d ** -0.5,
                                   stream)
    _raise_on(lib, err, f"flash_fwd ({body})")
    LAUNCHES["flash_fwd"] += 1
    BODY_LAUNCHES["flash_fwd"][body] += 1
    return o, lse


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, body: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels of :func:`flash_body`'s body (or of
    ``body``): D = rowsum(dO*O), then dK/dV per KV head and key tile,
    then dQ per query head and tile; (dq, dk, dv) in the inputs' dtype,
    accumulated in f32.  CUDA tensors only."""
    if not q.is_cuda:
        raise ValueError("flash_bwd launches the CUDA kernels; CPU tensors "
                         "go through flash_attention's plain version")
    b, s, L, H, Hk, d = _check(q, k, v, window, q_offset)
    for name, t in (("o", o), ("do", do)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {q.dtype} "
                             f"{tuple(q.shape)} tensor on {q.device}")
    if (lse.shape != (b, H, s) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous f32 {(b, H, s)} tensor "
                         f"on {q.device}")
    body = _pick_body(q, d, body, (q, k, v, do))
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    lib = load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, s, L, H, Hk, d, int(causal),
            window or 0, q_offset)
    if body == "mma":
        err = lib.flash_bwd_mma_launch(*args, d ** -0.5, stream)
    else:
        err = lib.flash_bwd_launch(*args, _DTYPE_CODES[q.dtype], d ** -0.5,
                                   stream)
    _raise_on(lib, err, f"flash_bwd ({body})")
    LAUNCHES["flash_bwd"] += 1
    BODY_LAUNCHES["flash_bwd"][body] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        o, lse = flash_fwd(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(),
                               causal=causal, window=window,
                               q_offset=q_offset)
        return dq, dk, dv, None, None, None


class _FlashAttentionPlain(torch.autograd.Function):
    """The CPU path: forward = the oracle with dead rows zeroed (the
    kernels' output), backward = the oracle's VJP (the reference's
    ``_fa_bwd``, which recomputes through ``attention_ref``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset)
        o = attention_ref(q, k, v, **ctx.mask)
        live = live_rows(q.shape[1], k.shape[1], device=q.device, **ctx.mask)
        return torch.where(live[None, :, None, None], o, o.new_zeros(()))

    @staticmethod
    def backward(ctx, do):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = attention_ref(*leaves, **ctx.mask)
            grads = torch.autograd.grad(out, leaves, do)
        return (*grads, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Fused (flash) attention.  q: (b, s, H, d); k, v: (b, L, Hk, d).

    ``block_q`` / ``block_k`` are the reference's TPU tile sizes; they do
    not change the result, and the CUDA kernels pick their own tiles from
    the head dim (``csrc/flash_attention.cu``), so they are only checked.
    """
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be >= 1, got {block_q}, "
                         f"{block_k}")
    if not q.is_cuda:
        return _FlashAttentionPlain.apply(q, k, v, causal, window, q_offset)
    return _FlashAttention.apply(q, k, v, causal, window, q_offset)


__all__ = ["BODY_LAUNCHES", "LAUNCHES", "MmaTiles", "attention_ref",
           "flash_attention", "flash_body", "flash_bwd", "flash_fwd",
           "key_tile_range", "load_library", "mma_tiles",
           "query_tile_range", "reset_launch_counts"]
