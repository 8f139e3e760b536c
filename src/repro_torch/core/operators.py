"""Foundational analytical operators (paper Table 1 + Appendix 8.1).

Every function estimates ``(compute ops, mem_rd bytes, mem_wr bytes,
dispatch calls)`` for one operator invocation and records it into a
:class:`repro_torch.core.stats.StatsDB`.  No tensor math is performed — this is the
paper's core abstraction that makes LIFE hardware- and dataset-agnostic.

Conventions (following the paper's Appendix 8.1 code, which we treat as the
executable ground truth where it disagrees with Table 1):

* GEMM opcount      = 2·m·k·n − m·n   (+ m·n when bias is enabled)
* BMM opcount       = 2·b·m·k·n − b·m·n
* int-quantized weights add a dequant term 2·k·n and per-group scale/zero
  reads (group size ``g``).
* LoRA (inline / dynamic merge) adds 2·k·r·n (A@B) + k·n (add into W) and
  reads of A (k·r) and B (r·n).
* ``read_input`` / ``write_output`` flags let derived operators model fusion
  (elided intermediate traffic); parameter reads are never elided.
"""
from __future__ import annotations

from math import ceil
from typing import Optional

from . import dtypes
from .stats import StatsDB


def _nb(name: str) -> float:
    return dtypes.nbytes(name)


#: Closed ``op_class`` vocabulary of every record the analytical model may
#: emit.  The static auditor (``repro_torch.analysis``) lints emitted OpRecord
#: streams against this set — a new operator class must be added HERE
#: (with pricing semantics) before any scenario method may tag records with it:
#:
#:   gemm / bmm   — matmul-family compute (reconciled against HLO ``dot``)
#:   elemw / nlf / softmax — pointwise & non-linear-function work
#:   quant        — quantize/dequantize passes
#:   embedding    — table-lookup gathers of the token embedding
#:   conv         — (depthwise) convolutions
#:   gather       — paged-KV page rematerialization + block-table reads
#:   kv           — KV-cache (or recurrent-state) reads/writes
#:   scan         — sequential recurrent-state update kernels (SSM/RG-LRU)
#:   collective   — cross-chip wire traffic (all-reduce/all-to-all/hops)
OP_CLASSES = frozenset({
    "gemm", "bmm", "elemw", "nlf", "softmax", "quant", "embedding",
    "conv", "gather", "kv", "scan", "collective",
})


# ---------------------------------------------------------------------------
# Linear / GEMM (+ bias, quantized weights, LoRA)
# ---------------------------------------------------------------------------

def linear(
    db: StatsDB,
    m: int,
    k: int,
    n: int,
    *,
    dtype_act: str = "bf16",
    dtype_w: str = "bf16",
    dtype_out: Optional[str] = None,
    bias: bool = False,
    group_size: int = 128,
    lora_rank: Optional[int] = None,
    dtype_lora: str = "bf16",
    read_input: bool = True,
    write_output: bool = True,
    dispatches: int = 1,
    name: str = "gemm",
) -> tuple[int, int]:
    """Paper Appendix 8.1 ``gemm``: y[m,n] = x[m,k] @ W[k,n] (+ b[n])."""
    dtype_out = dtype_out or dtype_act
    wdt = dtypes.get(dtype_w)

    opcount = 2.0 * m * k * n - (m * n)
    mem_rd = (m * k) * _nb(dtype_act) if read_input else 0.0
    mem_wr = (m * n) * _nb(dtype_out) if write_output else 0.0
    # parameter reads are never elided by fusion
    param_rd = (k * n) * wdt.bytes_per_el

    if bias:
        opcount += m * n
        param_rd += n * _nb(dtype_act)

    if wdt.is_quantized:
        # inline dequant: shift + scale per weight element
        opcount += (k * n) * 2.0
        if wdt.mx_block:
            param_rd += (k * n / wdt.mx_block) * wdt.mx_scale_bytes
        else:
            groups = ceil(k / group_size)
            param_rd += groups * n * wdt.scale_bytes    # scales
            param_rd += groups * n * wdt.zero_bytes     # zero points

    if lora_rank:
        # dynamic (inline) adapter merge: W' = W + B@A per call
        param_rd += (k * lora_rank) * _nb(dtype_lora)
        param_rd += (lora_rank * n) * _nb(dtype_lora)
        opcount += 2.0 * k * lora_rank * n   # A @ B
        opcount += float(k * n)              # W + AB

    db.record(name, ops=opcount, mem_rd=mem_rd + param_rd, mem_wr=mem_wr,
              dispatches=dispatches, op_class="gemm")
    return (m, n)


def lora_merge(
    db: StatsDB,
    k: int,
    n: int,
    rank: int,
    *,
    dtype_w: str = "bf16",
    dtype_lora: str = "bf16",
) -> None:
    """One-time ahead-of-time adapter merge for a single linear (Eq. 7)."""
    opcount = 2.0 * k * rank * n + k * n
    mem_rd = (k * rank + rank * n) * _nb(dtype_lora) + (k * n) * _nb(dtype_w)
    mem_wr = (k * n) * _nb(dtype_w)
    db.record("lora_merge", ops=opcount, mem_rd=mem_rd, mem_wr=mem_wr,
              dispatches=1, op_class="gemm")


# ---------------------------------------------------------------------------
# Batched matmul
# ---------------------------------------------------------------------------

def bmm(
    db: StatsDB,
    b: int,
    m: int,
    k: int,
    n: int,
    *,
    dtype: str = "bf16",
    dtype_b_operand: Optional[str] = None,
    read_a: bool = True,
    read_b: bool = True,
    write_output: bool = True,
    kv_operand: str = "",      # "" | "b" — tag operand-B bytes as KV reads
    pad_m: int = 1,
    pad_n: int = 1,
    dispatches: int = 1,
    name: str = "bmm",
) -> tuple[int, int, int]:
    """BMM[b,m,k]@[b,k,n]; optional padding of m/n to tile multiples.

    ``pad_m``/``pad_n`` model §3.2.2 dynamic-shape padding: the *compute*
    (and dispatch) cost is that of the padded shape while the memory cost
    reflects the true tensors (padded regions are zero-fill, not re-read).
    """
    dt_b = dtype_b_operand or dtype
    m_eff = ceil(m / pad_m) * pad_m
    n_eff = ceil(n / pad_n) * pad_n

    opcount = 2.0 * b * m_eff * k * n_eff - b * m_eff * n_eff
    mem_rd = 0.0
    kv_rd = 0.0
    if read_a:
        mem_rd += (b * m * k) * _nb(dtype)
    if read_b:
        bbytes = (b * k * n) * _nb(dt_b)
        mem_rd += bbytes
        if kv_operand == "b":
            kv_rd = bbytes
    mem_wr = (b * m * n) * _nb(dtype) if write_output else 0.0

    db.record(name, ops=opcount, mem_rd=mem_rd, mem_wr=mem_wr, kv_rd=kv_rd,
              dispatches=dispatches, op_class="bmm")
    return (b, m, n)


# ---------------------------------------------------------------------------
# Elementwise
# ---------------------------------------------------------------------------

def elemw(
    db: StatsDB,
    num_el: int,
    *,
    n_operands: int = 2,
    ops_per_el: float = 1.0,
    dtype: str = "bf16",
    read_input: bool = True,
    write_output: bool = True,
    dispatches: int = 1,
    name: str = "elemw",
) -> int:
    """Elementwise add/mul/…: paper models ``mn`` ops, 2mn rd + mn wr bytes."""
    opcount = num_el * ops_per_el
    mem_rd = (n_operands * num_el) * _nb(dtype) if read_input else 0.0
    mem_wr = num_el * _nb(dtype) if write_output else 0.0
    db.record(name, ops=opcount, mem_rd=mem_rd, mem_wr=mem_wr,
              dispatches=dispatches, op_class="elemw")
    return num_el


# ---------------------------------------------------------------------------
# Non-linear activation approximations
# ---------------------------------------------------------------------------

def nonlinear_pwl(
    db: StatsDB,
    num_el: int,
    *,
    table_size: int = 256,
    dtype: str = "bf16",
    read_input: bool = True,
    write_output: bool = True,
    dispatches: int = 1,
    name: str = "nlf_pwl",
    op_class: str = "nlf",
) -> int:
    """Piecewise-linear approximation: 2 ops/element (slope·x + intercept)."""
    opcount = 2.0 * num_el
    mem_rd = ((num_el if read_input else 0) + table_size) * _nb(dtype)
    mem_wr = num_el * _nb(dtype) if write_output else 0.0
    db.record(name, ops=opcount, mem_rd=mem_rd, mem_wr=mem_wr,
              dispatches=dispatches, op_class=op_class)
    return num_el


def nonlinear_poly(
    db: StatsDB,
    num_el: int,
    *,
    degree: int = 3,
    dtype: str = "bf16",
    read_input: bool = True,
    write_output: bool = True,
    dispatches: int = 1,
    name: str = "nlf_poly",
    op_class: str = "nlf",
) -> int:
    """Polynomial (Horner) approximation: (n(n+1)/2 + n) ops per element."""
    n = degree
    opcount = (n * (n + 1) / 2.0 + n) * num_el
    mem_rd = ((num_el if read_input else 0) + n) * _nb(dtype)
    mem_wr = num_el * _nb(dtype) if write_output else 0.0
    db.record(name, ops=opcount, mem_rd=mem_rd, mem_wr=mem_wr,
              dispatches=dispatches, op_class=op_class)
    return num_el


# ---------------------------------------------------------------------------
# (De)quantize
# ---------------------------------------------------------------------------

def quantize(
    db: StatsDB,
    num_el: int,
    *,
    dtype_from: str = "bf16",
    dtype_to: str = "int4",
    group_size: int = 128,
    read_input: bool = True,
    write_output: bool = True,
    dispatches: int = 1,
    name: str = "quantize",
) -> int:
    """Shift+scale: 2 ops/element; reads hi-precision, writes quantized."""
    qdt = dtypes.get(dtype_to)
    opcount = 2.0 * num_el
    num_qparams = num_el / group_size if not qdt.mx_block else num_el / qdt.mx_block
    mem_rd = (num_el * _nb(dtype_from) if read_input else 0.0)
    mem_wr = 0.0
    if write_output:
        mem_wr = num_el * qdt.bytes_per_el + num_qparams * (
            qdt.mx_scale_bytes if qdt.mx_block else qdt.scale_bytes + qdt.zero_bytes
        )
    db.record(name, ops=opcount, mem_rd=mem_rd, mem_wr=mem_wr,
              dispatches=dispatches, op_class="quant")
    return num_el


def dequantize(
    db: StatsDB,
    num_el: int,
    *,
    dtype_from: str = "int4",
    dtype_to: str = "bf16",
    group_size: int = 128,
    read_input: bool = True,
    write_output: bool = True,
    kv: bool = False,
    dispatches: int = 1,
    name: str = "dequantize",
) -> int:
    qdt = dtypes.get(dtype_from)
    opcount = 2.0 * num_el
    num_qparams = num_el / group_size if not qdt.mx_block else num_el / qdt.mx_block
    mem_rd = 0.0
    kv_rd = 0.0
    if read_input:
        mem_rd = num_el * qdt.bytes_per_el + num_qparams * (
            qdt.mx_scale_bytes if qdt.mx_block else qdt.scale_bytes + qdt.zero_bytes
        )
        if kv:
            kv_rd = mem_rd
    mem_wr = num_el * _nb(dtype_to) if write_output else 0.0
    db.record(name, ops=opcount, mem_rd=mem_rd, mem_wr=mem_wr, kv_rd=kv_rd,
              dispatches=dispatches, op_class="quant")
    return num_el


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embedding(
    db: StatsDB,
    n_tokens: int,
    vocab_size: int,
    hidden_size: int,
    *,
    dtype: str = "bf16",
    full_table_read: bool = False,
    name: str = "embedding",
) -> tuple[int, int]:
    """Token-embedding gather.

    Table 1 charges a full-table read; physically a gather reads one row per
    token. Default is per-row (gather) accounting; ``full_table_read=True``
    reproduces Table 1 exactly.
    """
    opcount = float(n_tokens)  # index/gather op per token (Table 1: 1)
    if full_table_read:
        mem_rd = vocab_size * hidden_size * _nb(dtype) + n_tokens * _nb(dtype)
    else:
        mem_rd = n_tokens * hidden_size * _nb(dtype) + n_tokens * 4.0  # rows + ids
    mem_wr = n_tokens * hidden_size * _nb(dtype)
    db.record(name, ops=opcount, mem_rd=mem_rd, mem_wr=mem_wr,
              dispatches=1, op_class="embedding")
    return (n_tokens, hidden_size)


# ---------------------------------------------------------------------------
# Conv1d (Whisper frontend / Mamba local conv)
# ---------------------------------------------------------------------------

def conv1d(
    db: StatsDB,
    n_frames: int,
    in_ch: int,
    out_ch: int,
    kernel: int,
    *,
    dtype: str = "bf16",
    depthwise: bool = False,
    read_input: bool = True,
    write_output: bool = True,
    dispatches: int = 1,
    name: str = "conv1d",
) -> tuple[int, int]:
    if depthwise:
        opcount = 2.0 * n_frames * out_ch * kernel
        w_el = out_ch * kernel
    else:
        opcount = 2.0 * n_frames * in_ch * out_ch * kernel
        w_el = in_ch * out_ch * kernel
    mem_rd = (n_frames * in_ch * _nb(dtype) if read_input else 0.0) + w_el * _nb(dtype)
    mem_wr = n_frames * out_ch * _nb(dtype) if write_output else 0.0
    db.record(name, ops=opcount, mem_rd=mem_rd, mem_wr=mem_wr,
              dispatches=dispatches, op_class="conv")
    return (n_frames, out_ch)
