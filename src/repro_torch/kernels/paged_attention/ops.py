"""Public wrappers of the paged attention kernels.

``paged_decode``, ``paged_prefill`` and ``paged_verify`` take the
signatures of the JAX package's ``kernels/paged_attention/ops.py``.  For tensors on a CUDA
device they launch the hand-written Hopper kernels of
``csrc/paged_attention.cu`` (built on first use, bound with ``ctypes``) on
the current stream, or raise; nothing falls back.  For tensors on the CPU
they compute the plain versions of ``ref.py``.

``paged_decode`` has one body, ``split``: the slot's keys split over
blocks by :func:`decode_split_plan` (``paged_decode_split_kernel``), the
splits' f32 partials combined in split order (``paged_decode_combine_kernel``).
``paged_prefill`` and ``paged_verify`` have two bodies each, by one rule
(:func:`prefill_body`, :func:`verify_body`): bf16 q with bf16 or int8 KV
and a head dim that is a multiple of 16 up to 128 runs on the tensor cores
(``mma``: ``attend_mma``, entered as ``paged_prefill_mma_kernel`` or
``paged_verify_mma_kernel``); any other (q, KV, d) keeps the f32 body
(``rows``, ``attend_rows``).

``LAUNCHES`` counts the calls of each wrapper that launched, so a run can
show that its main path went through the kernels; ``BODY_LAUNCHES``
counts them by body.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build as _build
from .ref import paged_decode_ref, paged_prefill_ref, paged_verify_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
LIBRARY_NAME = "paged_attention"

#: kernel launches per wrapper since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"paged_decode": 0, "paged_prefill": 0,
                            "paged_verify": 0}
#: each wrapper's launches by body
BODY_LAUNCHES: Dict[str, Dict[str, int]] = {
    "paged_decode": {"split": 0},
    "paged_prefill": {"mma": 0, "rows": 0},
    "paged_verify": {"mma": 0, "rows": 0}}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_Q_DTYPES = (torch.float32, torch.bfloat16)
_SMEM_LIMIT = 232_448      # bytes of shared memory one block may use on H100
#: K1's split plan: query rows of one block (the kernel's kDecodeRows; a
#: larger G takes row groups), the blocks per SM it aims for, and the
#: fewest keys a split may hold (chip_smoke.py's "split sweep" times every
#: split length at llama2-7b's and qwen2-7b's heads; PERF.md section 6)
DECODE_ROWS = 8
DECODE_BLOCKS_PER_SM = 2
DECODE_MIN_SPLIT_KEYS = 64

_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, *BODY_LAUNCHES.values()):
        for k in counts:
            counts[k] = 0


def verify_body(q_dtype: torch.dtype, kv_dtype: torch.dtype, d: int,
                rows: int) -> Tuple[str, int]:
    """paged_verify's and paged_prefill's body for a call, and its key
    splits (a prefill chunk is one slot's verify at ``pos = start`` with
    the keys cut at ``start + valid``).

    ``("mma", ks)`` for bf16 q with bf16 or int8 KV and d a multiple of
    16 up to 128: ``ks = 4`` when a slot's ``rows`` (``Q * G``, or
    ``C * G`` for a chunk) fit one 16-row warp tile (the four warps then
    split the keys), else 1 (four 16-row warps per block).  ``("rows",
    1)`` for anything else: f32 q must stay exact in f32, which a bf16
    tensor-core path would not be.
    """
    if (q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16, torch.int8)
            and d % 16 == 0 and 16 <= d <= 128):
        return "mma", 4 if rows <= 16 else 1
    return "rows", 1


#: paged_prefill's rule is paged_verify's
prefill_body = verify_body


class DecodePlan(NamedTuple):
    splits: int          # splits of each (slot, KV head)'s table
    split_blocks: int    # table entries (KV blocks) per split


def decode_split_plan(S: int, Hk: int, G: int, nb: int, bs: int,
                      sm_count: int) -> DecodePlan:
    """K1's grid on a card of ``sm_count`` SMs, from shapes alone: the
    table's ``nb`` entries of ``bs`` keys are cut into equal splits until
    the (splits x KV heads x row groups x slots) blocks fill
    ``DECODE_BLOCKS_PER_SM`` per SM, each split keeping at least
    ``DECODE_MIN_SPLIT_KEYS`` keys (a block's fixed cost, its q rows in
    registers, two merges and a partial, is then spread over enough
    keys).

    The cursors are never read: that would sync the host on the hot path,
    and a grid that depends on them could not be held in a CUDA graph.
    Splits past a slot's cursor cost a block that returns at once."""
    blocks = S * Hk * -(-G // DECODE_ROWS)
    want = -(-DECODE_BLOCKS_PER_SM * sm_count // max(1, blocks))
    per = min(nb, max(nb // want, -(-DECODE_MIN_SPLIT_KEYS // bs), 1))
    return DecodePlan(-(-nb // per), per)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build(SOURCE, LIBRARY_NAME).path))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.paged_decode_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I,
                                            I, I, I, I, I, ctypes.c_float, P]
        lib.paged_decode_launch.restype = I
        lib.paged_decode_smem_bytes.argtypes = [I, I]
        lib.paged_decode_smem_bytes.restype = ctypes.c_longlong
        lib.paged_prefill_launch.argtypes = [P, P, P, P, P, I, I, I, I, I, I,
                                             I, I, I, I, ctypes.c_float, P]
        lib.paged_prefill_launch.restype = I
        lib.paged_verify_launch.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I,
                                            I, I, I, ctypes.c_float, P]
        lib.paged_verify_launch.restype = I
        lib.paged_verify_mma_launch.argtypes = [P, P, P, P, P, P, I, I, I, I,
                                                I, I, I, I, I, ctypes.c_float,
                                                P]
        lib.paged_verify_mma_launch.restype = I
        lib.paged_prefill_mma_launch.argtypes = [P, P, P, P, P, I, I, I, I,
                                                 I, I, I, I, I, I,
                                                 ctypes.c_float, P]
        lib.paged_prefill_mma_launch.restype = I
        lib.paged_verify_mma_smem_bytes.argtypes = [I, I]
        lib.paged_verify_mma_smem_bytes.restype = ctypes.c_longlong
        lib.paged_smem_bytes.argtypes = [I, I, I]
        lib.paged_smem_bytes.restype = ctypes.c_longlong
        lib.paged_prefill_rows.argtypes = []
        lib.paged_prefill_rows.restype = I
        lib.paged_error_string.argtypes = [I]
        lib.paged_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_pool(q: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor) -> None:
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"paged attention kernels take f32/bf16 queries, "
                        f"got {q.dtype}")
    if cache_k.dtype != cache_v.dtype or cache_k.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged attention kernels take f32/bf16/int8 KV of "
                        f"one dtype, got {cache_k.dtype}/{cache_v.dtype}")
    if cache_k.shape != cache_v.shape or cache_k.dim() != 4:
        raise ValueError(f"caches must both be (N, bs, Hk, d), got "
                         f"{tuple(cache_k.shape)} / {tuple(cache_v.shape)}")
    if cache_k.shape[2:] != q.shape[1:2] + q.shape[3:4]:
        raise ValueError(f"cache heads/dim {tuple(cache_k.shape[2:])} do not "
                         f"match q {tuple(q.shape)}")
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")


def _check_index(name: str, t: torch.Tensor, shape, device) -> None:
    if (t.dtype != torch.int32 or tuple(t.shape) != tuple(shape)
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous int32 {tuple(shape)} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.paged_error_string(err).decode()}")


def _check_aligned(q: torch.Tensor, cache_k: torch.Tensor,
                   cache_v: torch.Tensor) -> None:
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v)):
        if t.data_ptr() % 16:             # 16-byte loads and copies
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _smem_check(lib: ctypes.CDLL, rows: int, d: int, bs: int,
                need: Optional[int] = None) -> None:
    if need is None:
        need = lib.paged_smem_bytes(rows, d, bs)
    if need > _SMEM_LIMIT:
        raise ValueError(f"paged attention needs {need} B of shared memory "
                         f"(rows={rows}, d={d}, bs={bs}); a block has "
                         f"{_SMEM_LIMIT}")


def paged_decode(q: torch.Tensor, cache_k: torch.Tensor,
                 cache_v: torch.Tensor, block_tables: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """Paged flash decode: one query token per slot against its table.

    q: (S, Hk, G, d); caches: (N, bs, Hk, d); tables: (S, max_bps) int32;
    pos: (S,) cursors — the key at ``pos[s]`` is the newest attended.
    """
    if not q.is_cuda:
        return paged_decode_ref(q, cache_k, cache_v, block_tables, pos)
    _check_pool(q, cache_k, cache_v)
    S, Hk, G, d = q.shape
    bs = cache_k.shape[1]
    nb = block_tables.shape[-1]
    _check_index("block_tables", block_tables, (S, nb), q.device)
    _check_index("pos", pos, (S,), q.device)
    if d % 8 or not 8 <= d <= 256 or nb == 0:
        raise ValueError(f"paged_decode takes a head dim that is a multiple "
                         f"of 8 up to 256 and a table of at least one "
                         f"block, got d={d}, nb={nb}")
    _check_aligned(q, cache_k, cache_v)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = load_library()
    plan = decode_split_plan(S, Hk, G, nb, bs, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    _smem_check(lib, G, d, bs,
                lib.paged_decode_smem_bytes(d, plan.split_blocks))
    scratch = torch.empty(S * Hk * plan.splits * G * (d + 2),
                          dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_decode_launch(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        block_tables.data_ptr(), pos.data_ptr(), scratch.data_ptr(),
        out.data_ptr(), S, Hk, G, d, bs, nb, plan.splits, plan.split_blocks,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[cache_k.dtype], d ** -0.5, stream)
    _raise_on(lib, err, "paged_decode (split)")
    LAUNCHES["paged_decode"] += 1
    BODY_LAUNCHES["paged_decode"]["split"] += 1
    return out


def paged_prefill(q: torch.Tensor, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, block_table: torch.Tensor,
                  start, valid) -> torch.Tensor:
    """Paged chunked prefill: one slot's chunk at absolute positions.

    q: (C, Hk, G, d); ``start`` is the absolute position of q[0] (cached
    prefix included), ``valid`` the live chunk tokens (the tail is padding).
    """
    if not q.is_cuda:
        return paged_prefill_ref(q, cache_k, cache_v, block_table, start,
                                 valid)
    _check_pool(q, cache_k, cache_v)
    C, Hk, G, d = q.shape
    bs = cache_k.shape[1]
    nb = block_table.shape[-1]
    _check_index("block_table", block_table, (nb,), q.device)
    start, valid = int(start), int(valid)
    if start < 0 or not 0 < valid <= C or start + valid > nb * bs:
        raise ValueError(f"chunk span start={start} valid={valid} does not "
                         f"fit C={C} and the table's {nb * bs} positions")
    out = torch.empty_like(q)
    lib = load_library()
    body, key_splits = prefill_body(q.dtype, cache_k.dtype, d, C * G)
    kv_code = _DTYPE_CODES[cache_k.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            block_table.data_ptr(), out.data_ptr())
    if body == "mma":
        _check_aligned(q, cache_k, cache_v)
        _smem_check(lib, C * G, d, bs,
                    lib.paged_verify_mma_smem_bytes(d, kv_code))
        err = lib.paged_prefill_mma_launch(
            *ptrs, C, Hk, G, d, bs, nb, start, valid, kv_code, key_splits,
            d ** -0.5, stream)
    else:
        _smem_check(lib, lib.paged_prefill_rows(), d, bs)
        err = lib.paged_prefill_launch(
            *ptrs, C, Hk, G, d, bs, nb, start, valid, _DTYPE_CODES[q.dtype],
            kv_code, d ** -0.5, stream)
    _raise_on(lib, err, f"paged_prefill ({body})")
    LAUNCHES["paged_prefill"] += 1
    BODY_LAUNCHES["paged_prefill"][body] += 1
    return out


def paged_verify(q: torch.Tensor, cache_k: torch.Tensor,
                 cache_v: torch.Tensor, block_tables: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """Paged flash speculative verify: Q candidate tokens per slot.

    q: (S, Q, Hk, G, d) — slot ``s``'s queries sit at absolute positions
    ``pos[s] .. pos[s]+Q-1`` (the pending token plus k=Q-1 drafts, or a
    bucketed-admission chunk, whose K/V were written before this call);
    caches: (N, bs, Hk, d); tables: (S, max_bps) int32; pos: (S,) cursors.
    """
    if not q.is_cuda:
        return paged_verify_ref(q, cache_k, cache_v, block_tables, pos)
    if q.dim() != 5:
        raise ValueError(f"q must be (S, Q, Hk, G, d), got {tuple(q.shape)}")
    S, Q, Hk, G, d = q.shape
    if not q.is_contiguous():
        raise ValueError(f"q must be contiguous on {q.device}")
    _check_pool(q.view(S * Q, Hk, G, d), cache_k, cache_v)
    bs = cache_k.shape[1]
    nb = block_tables.shape[-1]
    _check_index("block_tables", block_tables, (S, nb), q.device)
    _check_index("pos", pos, (S,), q.device)
    out = torch.empty_like(q)
    if S == 0 or Q == 0:
        return out
    lib = load_library()
    body, key_splits = verify_body(q.dtype, cache_k.dtype, d, Q * G)
    kv_code = _DTYPE_CODES[cache_k.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            block_tables.data_ptr(), pos.data_ptr(), out.data_ptr())
    if body == "mma":
        _check_aligned(q, cache_k, cache_v)
        _smem_check(lib, Q * G, d, bs,
                    lib.paged_verify_mma_smem_bytes(d, kv_code))
        err = lib.paged_verify_mma_launch(
            *ptrs, S, Q, Hk, G, d, bs, nb, kv_code, key_splits, d ** -0.5,
            stream)
    else:
        _smem_check(lib, lib.paged_prefill_rows(), d, bs)
        err = lib.paged_verify_launch(
            *ptrs, S, Q, Hk, G, d, bs, nb, _DTYPE_CODES[q.dtype], kv_code,
            d ** -0.5, stream)
    _raise_on(lib, err, f"paged_verify ({body})")
    LAUNCHES["paged_verify"] += 1
    BODY_LAUNCHES["paged_verify"][body] += 1
    return out


__all__ = ["BODY_LAUNCHES", "DecodePlan", "LAUNCHES", "decode_split_plan",
           "load_library", "paged_decode", "paged_decode_ref",
           "paged_prefill", "paged_prefill_ref", "paged_verify",
           "paged_verify_ref", "prefill_body", "reset_launch_counts",
           "verify_body"]
