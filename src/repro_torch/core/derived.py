"""Derived analytical operators (paper Table 2) + family extensions.

Derived operators compose foundational ones (``repro_torch.core.operators``).
Fusion (§3.2.1) is modeled by eliding the activation reads/writes *between*
the composed foundational ops — parameter and KV reads are never elided.

Beyond the paper (§7 leaves these to future work — see DESIGN.md §5):
``moe_layer`` (shared + routed experts), ``ssm_block`` (Mamba-1),
``rglru_block`` (RecurrentGemma), ``cross_attention`` (enc-dec).
"""
from __future__ import annotations

from typing import Optional

from . import operators as F
from . import dtypes
from .stats import StatsDB


def _nb(name: str) -> float:
    return dtypes.nbytes(name)


# ---------------------------------------------------------------------------
# Scalar non-linear helpers (Table 2: Inverse, Inverse-Sqrt as Elemw Add/Mul)
# ---------------------------------------------------------------------------

def inverse(db: StatsDB, num_el: int, *, dtype: str = "bf16",
            fused: bool = False, dispatches: int = 1,
            name: str = "inverse") -> None:
    """Newton-Raphson reciprocal (Moroz et al.): ~4 ops/el."""
    F.elemw(db, num_el, n_operands=1, ops_per_el=4.0, dtype=dtype,
            read_input=not fused, write_output=not fused,
            dispatches=dispatches, name=name)


def inverse_sqrt(db: StatsDB, num_el: int, *, dtype: str = "bf16",
                 fused: bool = False, dispatches: int = 0,
                 name: str = "rsqrt") -> None:
    """Fast inverse sqrt (1 NR iteration): ~4 ops/el."""
    F.elemw(db, num_el, n_operands=1, ops_per_el=4.0, dtype=dtype,
            read_input=not fused, write_output=not fused,
            dispatches=dispatches, name=name)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(
    db: StatsDB,
    n_tokens: int,
    n_heads: int,
    head_dim: int,
    *,
    dtype: str = "bf16",
    table_size: int = 4096,
    fused: bool = False,
) -> None:
    """Rotate-half RoPE: per element 2 mul + 2 add; reads sin/cos tables."""
    num_el = n_tokens * n_heads * head_dim
    # sin/cos table rows for the processed tokens
    table_rd = min(n_tokens, table_size) * head_dim * 2 * _nb(dtype)
    F.elemw(db, num_el, n_operands=1, ops_per_el=4.0, dtype=dtype,
            read_input=not fused, write_output=not fused, name="rope")
    db.record("rope_tables", ops=0.0, mem_rd=table_rd, mem_wr=0.0,
              dispatches=0, op_class="elemw")


# ---------------------------------------------------------------------------
# Normalization (RMSNorm / LayerNorm)
# ---------------------------------------------------------------------------

def norm(
    db: StatsDB,
    n_tokens: int,
    hidden: int,
    *,
    kind: str = "rmsnorm",
    dtype: str = "bf16",
    fused: bool = False,
) -> None:
    num_el = n_tokens * hidden
    # sum of squares (mul+add = 2 ops/el), optional mean for LN
    stat_ops = 2.0 if kind == "rmsnorm" else 3.0
    F.elemw(db, num_el, n_operands=1, ops_per_el=stat_ops, dtype=dtype,
            read_input=not fused, write_output=False,
            dispatches=0 if fused else 1, name=f"{kind}_stats")
    inverse_sqrt(db, n_tokens, dtype=dtype, fused=True)
    # normalize + gamma scale (2 ops/el), read gamma, write out
    db.record(f"{kind}_scale", ops=2.0 * num_el,
              mem_rd=hidden * _nb(dtype),
              mem_wr=0.0 if fused else num_el * _nb(dtype),
              dispatches=0, op_class="elemw")


# ---------------------------------------------------------------------------
# Softmax (Table 2: NLF + Elemw Add, Mul + Inverse)
# ---------------------------------------------------------------------------

def softmax(
    db: StatsDB,
    n_rows: int,
    row_len: int,
    *,
    dtype: str = "bf16",
    actfn_algo: str = "pwl",
    actfn_table_size: int = 256,
    fused: bool = False,
) -> None:
    num_el = n_rows * row_len
    # exp via approximation
    if actfn_algo == "poly":
        F.nonlinear_poly(db, num_el, degree=3, dtype=dtype,
                         read_input=not fused, write_output=False,
                         dispatches=0 if fused else 1,
                         name="softmax_exp", op_class="softmax")
    else:
        F.nonlinear_pwl(db, num_el, table_size=actfn_table_size, dtype=dtype,
                        read_input=not fused, write_output=False,
                        dispatches=0 if fused else 1,
                        name="softmax_exp", op_class="softmax")
    # row max subtract + row sum (2 ops/el), reciprocal per row, scale mul
    db.record("softmax_norm", ops=2.0 * num_el + 4.0 * n_rows + num_el,
              mem_rd=0.0, mem_wr=0.0 if fused else num_el * _nb(dtype),
              dispatches=0, op_class="softmax")


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU or plain GELU)
# ---------------------------------------------------------------------------

def mlp(
    db: StatsDB,
    n_tokens: int,
    hidden: int,
    d_ff: int,
    *,
    gated: bool = True,
    dtype_act: str = "bf16",
    dtype_w: str = "bf16",
    group_size: int = 128,
    bias: bool = False,
    actfn_algo: str = "pwl",
    actfn_table_size: int = 256,
    fused: bool = False,
    lora_rank: Optional[int] = None,
) -> None:
    """SwiGLU: down( act(gate(x)) * up(x) ); plain: down( act(up(x)) )."""
    with db.scope("mlp"):
        if gated:
            F.linear(db, n_tokens, hidden, d_ff, dtype_act=dtype_act,
                     dtype_w=dtype_w, group_size=group_size, bias=bias,
                     lora_rank=lora_rank, write_output=not fused, name="gate_proj")
            F.linear(db, n_tokens, hidden, d_ff, dtype_act=dtype_act,
                     dtype_w=dtype_w, group_size=group_size, bias=bias,
                     lora_rank=lora_rank, write_output=not fused, name="up_proj")
        else:
            F.linear(db, n_tokens, hidden, d_ff, dtype_act=dtype_act,
                     dtype_w=dtype_w, group_size=group_size, bias=bias,
                     lora_rank=lora_rank, write_output=not fused, name="up_proj")
        num_el = n_tokens * d_ff
        if actfn_algo == "poly":
            F.nonlinear_poly(db, num_el, degree=3, dtype=dtype_act,
                             read_input=not fused, write_output=not fused,
                             dispatches=0 if fused else 1, name="actfn")
        else:
            F.nonlinear_pwl(db, num_el, table_size=actfn_table_size,
                            dtype=dtype_act, read_input=not fused,
                            write_output=not fused,
                            dispatches=0 if fused else 1, name="actfn")
        if gated:
            F.elemw(db, num_el, n_operands=2, dtype=dtype_act,
                    read_input=not fused, write_output=not fused,
                    dispatches=0 if fused else 1, name="gate_mul")
        F.linear(db, n_tokens, d_ff, hidden, dtype_act=dtype_act,
                 dtype_w=dtype_w, group_size=group_size, bias=bias,
                 lora_rank=lora_rank, read_input=not fused, name="down_proj")


# ---------------------------------------------------------------------------
# KV cache helpers
# ---------------------------------------------------------------------------

def kv_cache_write(
    db: StatsDB,
    n_tokens: int,
    n_kv_heads: int,
    head_dim: int,
    *,
    kv_dtype: str = "bf16",
    group_size: int = 128,
) -> None:
    """Append K and V for ``n_tokens`` (+ quantize op when KV is quantized)."""
    qdt = dtypes.get(kv_dtype)
    num_el = n_tokens * n_kv_heads * head_dim * 2  # K and V
    if qdt.is_quantized:
        F.quantize(db, num_el, dtype_from="bf16", dtype_to=kv_dtype,
                   group_size=group_size, read_input=False, write_output=False,
                   dispatches=0, name="kv_quant")
    kv_bytes = qdt.storage_bytes(num_el, group_size)
    db.record("kv_write", ops=0.0, mem_rd=0.0, mem_wr=kv_bytes,
              kv_wr=kv_bytes, dispatches=1, op_class="kv")


def _kv_read_bytes(kv_len: int, n_kv_heads: int, head_dim: int,
                   kv_dtype: str, group_size: int) -> float:
    qdt = dtypes.get(kv_dtype)
    return qdt.storage_bytes(kv_len * n_kv_heads * head_dim, group_size)


def page_rematerialization(
    db: StatsDB,
    batch: int,
    kv_len: int,
    n_kv_heads: int,
    head_dim: int,
    *,
    kv_dtype: str = "bf16",
    group_size: int = 128,
    name: str = "page_remat",
) -> None:
    """Traffic of the block-paged *gather* attention path.

    The XLA engine gathers each slot's KV blocks back into a contiguous
    page buffer before attending: per layer pass it re-reads the slot's
    K and V span from the pool and writes it back as a new contiguous
    page (the attention core's ``kv_rd`` then covers reading that page).
    The Pallas paged flash kernel elides this buffer entirely — pricing it
    here is what makes the gather-vs-paged delta forecastable.

    Priced at the useful span (``kv_len`` tokens, not the padded virtual
    width), linear in ``kv_len`` so the mixed-decode affine identity of
    ``WorkloadModel.decode_totals_mixed`` holds.
    """
    qdt = dtypes.get(kv_dtype)
    span = qdt.storage_bytes(
        batch * kv_len * n_kv_heads * head_dim * 2, group_size)  # K and V
    db.record(name, ops=0.0, mem_rd=span, mem_wr=span, kv_rd=span,
              dispatches=1, op_class="gather")


# ---------------------------------------------------------------------------
# Attention: MHA / GQA / MQA (eager + fused), with KV quant and padding
# ---------------------------------------------------------------------------

def attention(
    db: StatsDB,
    batch: int,
    q_len: int,
    kv_len: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    *,
    dtype: str = "bf16",
    kv_dtype: str = "bf16",
    kv_group_size: int = 128,
    fused: bool = False,
    pad_to: int = 1,
    actfn_algo: str = "pwl",
    actfn_table_size: int = 256,
    write_kv: bool = True,
    window: Optional[int] = None,
) -> None:
    """Scaled-dot-product attention core (post-projection, pre-output-proj).

    ``q_len`` new queries attend to ``kv_len`` total keys (``kv_len`` includes
    the new tokens).  ``window`` caps the attended span (local attention).
    Compute is charged for the full q_len×kv_len rectangle (paper convention —
    no causal halving; the Pallas flash kernel *does* skip masked blocks, an
    optimization tracked separately in EXPERIMENTS.md §Perf).
    """
    if window is not None:
        kv_len = min(kv_len, window)
    qdt = dtypes.get(kv_dtype)

    with db.scope("attn_core"):
        if write_kv:
            kv_cache_write(db, q_len * batch, n_kv_heads, head_dim,
                           kv_dtype=kv_dtype, group_size=kv_group_size)
        # dequantize cached K and V when KV is quantized (2 tensors)
        if qdt.is_quantized:
            num_el = batch * kv_len * n_kv_heads * head_dim * 2
            F.dequantize(db, num_el, dtype_from=kv_dtype, dtype_to=dtype,
                         group_size=kv_group_size, read_input=False,
                         write_output=not fused, kv=False,
                         dispatches=0 if fused else 1, name="kv_dequant")
        kv_rd_one = batch * _kv_read_bytes(kv_len, n_kv_heads, head_dim,
                                           kv_dtype, kv_group_size)
        # QK^T — compute is per q-head; K bytes are per kv-head
        b = batch * n_heads
        F.bmm(db, b, q_len, head_dim, kv_len, dtype=dtype,
              read_a=True, read_b=False, write_output=not fused,
              pad_n=pad_to, name="bmm_qk")
        db.record("kv_read_k", ops=0.0, mem_rd=kv_rd_one, kv_rd=kv_rd_one,
                  dispatches=0, op_class="kv")
        softmax(db, b * q_len, kv_len, dtype=dtype, actfn_algo=actfn_algo,
                actfn_table_size=actfn_table_size, fused=fused)
        # P @ V
        F.bmm(db, b, q_len, kv_len, head_dim, dtype=dtype,
              read_a=not fused, read_b=False, write_output=True,
              pad_m=1, dispatches=0 if fused else 1, name="bmm_pv")
        db.record("kv_read_v", ops=0.0, mem_rd=kv_rd_one, kv_rd=kv_rd_one,
                  dispatches=0, op_class="kv")


def mha_block(
    db: StatsDB,
    batch: int,
    q_len: int,
    kv_len: int,
    hidden: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    *,
    dtype_act: str = "bf16",
    dtype_w: str = "bf16",
    group_size: int = 128,
    kv_dtype: str = "bf16",
    qkv_bias: bool = False,
    fused: bool = False,
    pad_to: int = 1,
    rope_table: int = 4096,
    lora_rank: Optional[int] = None,
    window: Optional[int] = None,
    attn_fused: Optional[bool] = None,
) -> None:
    """Full attention block: QKV proj + RoPE + attention core + O proj.

    ``attn_fused`` overrides ``fused`` for the attention core only — the
    paged flash kernel fuses QK^T→softmax→PV regardless of whether the
    surrounding variant is fused (score/prob intermediates elided).
    """
    ntok = batch * q_len
    with db.scope("attn"):
        F.linear(db, ntok, hidden, n_heads * head_dim, dtype_act=dtype_act,
                 dtype_w=dtype_w, group_size=group_size, bias=qkv_bias,
                 lora_rank=lora_rank, name="q_proj")
        F.linear(db, ntok, hidden, n_kv_heads * head_dim, dtype_act=dtype_act,
                 dtype_w=dtype_w, group_size=group_size, bias=qkv_bias,
                 lora_rank=lora_rank, name="k_proj")
        F.linear(db, ntok, hidden, n_kv_heads * head_dim, dtype_act=dtype_act,
                 dtype_w=dtype_w, group_size=group_size, bias=qkv_bias,
                 lora_rank=lora_rank, name="v_proj")
        rope(db, ntok, n_heads, head_dim, dtype=dtype_act,
             table_size=rope_table, fused=fused)
        rope(db, ntok, n_kv_heads, head_dim, dtype=dtype_act,
             table_size=rope_table, fused=fused)
        attention(db, batch, q_len, kv_len, n_heads, n_kv_heads, head_dim,
                  dtype=dtype_act, kv_dtype=kv_dtype, kv_group_size=group_size,
                  fused=fused if attn_fused is None else attn_fused,
                  pad_to=pad_to, window=window)
        F.linear(db, ntok, n_heads * head_dim, hidden, dtype_act=dtype_act,
                 dtype_w=dtype_w, group_size=group_size,
                 lora_rank=lora_rank, name="o_proj")


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention, paper §3.3.2/§5.4)
# ---------------------------------------------------------------------------

def mla_block(
    db: StatsDB,
    batch: int,
    q_len: int,
    kv_len: int,
    hidden: int,
    n_heads: int,
    *,
    q_lora_rank: int = 128,
    kv_lora_rank: int = 128,
    qk_nope_head_dim: int = 128,
    qk_rope_head_dim: int = 64,
    v_head_dim: int = 128,
    dtype_act: str = "bf16",
    dtype_w: str = "bf16",
    group_size: int = 128,
    kv_dtype: str = "bf16",
    fused: bool = False,
    rope_table: int = 4096,
) -> None:
    """MLA: low-rank Q and compressed-latent KV; cache stores the latent.

    Cache per token = kv_lora_rank + qk_rope_head_dim elements (the paper's
    "KV compression without quantizing" §2.3).  The latent is decompressed
    *online* for the attended span — which is why the paper finds MLA decode
    memory above GQA unless the up-projection weights are amortized.
    """
    ntok = batch * q_len
    qk_head_dim = qk_nope_head_dim + qk_rope_head_dim
    with db.scope("mla"):
        # Q path: down then up (low rank)
        F.linear(db, ntok, hidden, q_lora_rank, dtype_act=dtype_act,
                 dtype_w=dtype_w, group_size=group_size, name="q_down")
        norm(db, ntok, q_lora_rank, dtype=dtype_act, fused=fused)
        F.linear(db, ntok, q_lora_rank, n_heads * qk_head_dim,
                 dtype_act=dtype_act, dtype_w=dtype_w, group_size=group_size,
                 name="q_up")
        rope(db, ntok, n_heads, qk_rope_head_dim, dtype=dtype_act,
             table_size=rope_table, fused=fused)
        # KV path: compress to latent + decoupled rope key
        F.linear(db, ntok, hidden, kv_lora_rank + qk_rope_head_dim,
                 dtype_act=dtype_act, dtype_w=dtype_w, group_size=group_size,
                 name="kv_down")
        norm(db, ntok, kv_lora_rank, dtype=dtype_act, fused=fused)
        rope(db, ntok, 1, qk_rope_head_dim, dtype=dtype_act,
             table_size=rope_table, fused=fused)
        # cache write: latent + rope-key
        qdt = dtypes.get(kv_dtype)
        cache_el = ntok * (kv_lora_rank + qk_rope_head_dim)
        if qdt.is_quantized:
            F.quantize(db, cache_el, dtype_from=dtype_act, dtype_to=kv_dtype,
                       group_size=group_size, read_input=False,
                       write_output=False, name="kv_quant")
        cache_bytes = qdt.storage_bytes(cache_el, group_size)
        db.record("kv_write", ops=0.0, mem_wr=cache_bytes, kv_wr=cache_bytes,
                  dispatches=0, op_class="kv")
        # online decompression of the attended latent span: latent -> K,V
        span = batch * kv_len
        F.linear(db, span, kv_lora_rank,
                 n_heads * (qk_nope_head_dim + v_head_dim),
                 dtype_act=dtype_act, dtype_w=dtype_w, group_size=group_size,
                 write_output=not fused, name="kv_up")
        latent_bytes = qdt.storage_bytes(
            span * (kv_lora_rank + qk_rope_head_dim), group_size)
        db.record("kv_read_latent", ops=0.0, mem_rd=latent_bytes,
                  kv_rd=latent_bytes, dispatches=0, op_class="kv")
        if qdt.is_quantized:
            F.dequantize(db, span * (kv_lora_rank + qk_rope_head_dim),
                         dtype_from=kv_dtype, dtype_to=dtype_act,
                         group_size=group_size, read_input=False,
                         write_output=not fused, name="kv_dequant")
        # attention over decompressed K/V (already in on-chip/fused scope:
        # K/V activation traffic elided when fused)
        b = batch * n_heads
        F.bmm(db, b, q_len, qk_head_dim, kv_len, dtype=dtype_act,
              read_a=True, read_b=not fused, write_output=not fused,
              name="bmm_qk")
        softmax(db, b * q_len, kv_len, dtype=dtype_act, fused=fused)
        F.bmm(db, b, q_len, kv_len, v_head_dim, dtype=dtype_act,
              read_a=not fused, read_b=not fused, write_output=True,
              name="bmm_pv")
        F.linear(db, ntok, n_heads * v_head_dim, hidden, dtype_act=dtype_act,
                 dtype_w=dtype_w, group_size=group_size, name="o_proj")


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec): KV computed once from encoder, read every step
# ---------------------------------------------------------------------------

def cross_attention_block(
    db: StatsDB,
    batch: int,
    q_len: int,
    enc_len: int,
    hidden: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    *,
    compute_enc_kv: bool,
    dtype_act: str = "bf16",
    dtype_w: str = "bf16",
    group_size: int = 128,
    kv_dtype: str = "bf16",
    fused: bool = False,
) -> None:
    ntok = batch * q_len
    with db.scope("cross_attn"):
        F.linear(db, ntok, hidden, n_heads * head_dim, dtype_act=dtype_act,
                 dtype_w=dtype_w, group_size=group_size, name="q_proj")
        if compute_enc_kv:
            F.linear(db, batch * enc_len, hidden, n_kv_heads * head_dim,
                     dtype_act=dtype_act, dtype_w=dtype_w,
                     group_size=group_size, name="k_proj")
            F.linear(db, batch * enc_len, hidden, n_kv_heads * head_dim,
                     dtype_act=dtype_act, dtype_w=dtype_w,
                     group_size=group_size, name="v_proj")
            kv_cache_write(db, batch * enc_len, n_kv_heads, head_dim,
                           kv_dtype=kv_dtype, group_size=group_size)
        attention(db, batch, q_len, enc_len, n_heads, n_kv_heads, head_dim,
                  dtype=dtype_act, kv_dtype=kv_dtype, kv_group_size=group_size,
                  fused=fused, write_kv=False)
        F.linear(db, ntok, n_heads * head_dim, hidden, dtype_act=dtype_act,
                 dtype_w=dtype_w, group_size=group_size, name="o_proj")


# ---------------------------------------------------------------------------
# MoE layer (beyond paper — DESIGN.md §5)
# ---------------------------------------------------------------------------

def moe_layer(
    db: StatsDB,
    n_tokens: int,
    hidden: int,
    d_ff_expert: int,
    n_experts: int,
    top_k: int,
    *,
    n_shared: int = 0,
    d_ff_shared: Optional[int] = None,
    dtype_act: str = "bf16",
    dtype_w: str = "bf16",
    group_size: int = 128,
    fused: bool = False,
    actfn_algo: str = "pwl",
) -> None:
    """Router + top-k routed experts + always-on shared experts.

    Weight-read accounting: the expected number of *distinct* routed experts
    touched by ``n_tokens`` tokens is n_e·(1−(1−k/n_e)^T) — ≈ all experts in
    prefill, ≈ top_k in single-token decode.  Compute is charged per
    (token × active expert) — the "active-parameter" FLOPs that define
    MODEL_FLOPS for MoE (6·N_active·D).
    """
    d_ff_shared = d_ff_shared or d_ff_expert
    with db.scope("moe"):
        # router: linear + softmax + top-k select
        F.linear(db, n_tokens, hidden, n_experts, dtype_act=dtype_act,
                 dtype_w="bf16", name="router")
        softmax(db, n_tokens, n_experts, dtype=dtype_act, fused=fused)
        F.elemw(db, n_tokens * n_experts, n_operands=1, ops_per_el=1.0,
                dtype=dtype_act, read_input=not fused,
                write_output=not fused, name="topk_select")

        # distinct routed experts whose weights stream from memory
        frac_active = 1.0 - (1.0 - top_k / n_experts) ** n_tokens
        distinct = min(n_experts * frac_active, float(n_experts))

        # compute: every token runs top_k routed experts
        expert_tokens = n_tokens * top_k
        _expert_mlp(db, expert_tokens, hidden, d_ff_expert,
                    weight_copies=distinct, per_copy_tokens=None,
                    dtype_act=dtype_act, dtype_w=dtype_w,
                    group_size=group_size, fused=fused, actfn_algo=actfn_algo,
                    tag="routed")
        if n_shared:
            _expert_mlp(db, n_tokens * n_shared, hidden, d_ff_shared,
                        weight_copies=float(n_shared), per_copy_tokens=None,
                        dtype_act=dtype_act, dtype_w=dtype_w,
                        group_size=group_size, fused=fused,
                        actfn_algo=actfn_algo, tag="shared")
        # combine: weighted sum of top_k expert outputs
        F.elemw(db, n_tokens * hidden, n_operands=top_k, ops_per_el=2.0 * top_k,
                dtype=dtype_act, read_input=not fused, write_output=True,
                name="moe_combine")


def _expert_mlp(db, expert_tokens, hidden, d_ff, *, weight_copies,
                per_copy_tokens, dtype_act, dtype_w, group_size, fused,
                actfn_algo, tag):
    """Gated expert MLP with compute per token and weight-reads per expert."""
    wdt = dtypes.get(dtype_w)
    # compute ops (per token-expert): gate+up+down GEMMs + act + mul
    gemm_ops = (2.0 * expert_tokens * hidden * d_ff) * 2 \
        + 2.0 * expert_tokens * d_ff * hidden - 3.0 * expert_tokens * d_ff
    if wdt.is_quantized:
        gemm_ops += 3.0 * 2.0 * hidden * d_ff * weight_copies  # dequant
    act_ops = 2.0 * expert_tokens * d_ff + expert_tokens * d_ff
    w_el = 3.0 * hidden * d_ff * weight_copies
    w_bytes = wdt.storage_bytes(int(w_el), group_size)
    act_rd = 0.0 if fused else 2.0 * expert_tokens * hidden * _nb(dtype_act)
    act_wr = expert_tokens * hidden * _nb(dtype_act)
    db.record(f"expert_mlp_{tag}", ops=gemm_ops + act_ops,
              mem_rd=w_bytes + act_rd, mem_wr=act_wr,
              dispatches=3, op_class="gemm")


# ---------------------------------------------------------------------------
# Mamba-1 SSM block (beyond paper; attention-free — DESIGN.md §5)
# ---------------------------------------------------------------------------

def ssm_block(
    db: StatsDB,
    batch: int,
    n_tokens_per_seq: int,
    hidden: int,
    *,
    d_state: int = 16,
    expand: int = 2,
    conv_kernel: int = 4,
    dt_rank: Optional[int] = None,
    dtype_act: str = "bf16",
    dtype_w: str = "bf16",
    group_size: int = 128,
    fused: bool = False,
    read_write_state: bool = True,
) -> None:
    """Mamba-1: in_proj → conv1d → x_proj/dt_proj → selective scan → out_proj."""
    d_inner = expand * hidden
    dt_rank = dt_rank or max(1, hidden // 16)
    ntok = batch * n_tokens_per_seq
    with db.scope("ssm"):
        F.linear(db, ntok, hidden, 2 * d_inner, dtype_act=dtype_act,
                 dtype_w=dtype_w, group_size=group_size, name="in_proj")
        F.conv1d(db, ntok, d_inner, d_inner, conv_kernel, dtype=dtype_act,
                 depthwise=True, read_input=not fused,
                 write_output=not fused, name="conv1d")
        F.nonlinear_pwl(db, ntok * d_inner, dtype=dtype_act,
                        read_input=not fused, write_output=not fused,
                        name="silu_conv")
        F.linear(db, ntok, d_inner, dt_rank + 2 * d_state,
                 dtype_act=dtype_act, dtype_w=dtype_w, group_size=group_size,
                 read_input=not fused, name="x_proj")
        F.linear(db, ntok, dt_rank, d_inner, dtype_act=dtype_act,
                 dtype_w=dtype_w, group_size=group_size, name="dt_proj")
        # selective scan: per token/channel: discretize A,B (~4 ops/state),
        # h = Ā⊙h + B̄·x (2/state), y = C·h (2/state), + D skip & gate
        scan_ops = ntok * d_inner * d_state * 8.0 + ntok * d_inner * 4.0
        state_el = batch * d_inner * d_state
        state_bytes = state_el * 4.0  # fp32 recurrent state
        conv_state = batch * d_inner * (conv_kernel - 1) * _nb(dtype_act)
        rd = state_bytes + conv_state if read_write_state else 0.0
        wr = state_bytes + conv_state if read_write_state else 0.0
        # A matrix (d_inner × d_state) + D read
        a_bytes = d_inner * d_state * 4.0 + d_inner * 4.0
        db.record("selective_scan", ops=scan_ops,
                  mem_rd=rd + a_bytes + (0.0 if fused else ntok * d_inner * _nb(dtype_act)),
                  mem_wr=wr + (0.0 if fused else ntok * d_inner * _nb(dtype_act)),
                  kv_rd=rd, kv_wr=wr,  # state plays the KV role for SSMs
                  dispatches=1, op_class="scan")
        F.nonlinear_pwl(db, ntok * d_inner, dtype=dtype_act,
                        read_input=not fused, write_output=not fused,
                        name="silu_gate")
        F.elemw(db, ntok * d_inner, n_operands=2, dtype=dtype_act,
                read_input=not fused, write_output=not fused, name="gate_mul")
        F.linear(db, ntok, d_inner, hidden, dtype_act=dtype_act,
                 dtype_w=dtype_w, group_size=group_size, name="out_proj")


# ---------------------------------------------------------------------------
# RG-LRU block (RecurrentGemma; beyond paper — DESIGN.md §5)
# ---------------------------------------------------------------------------

def rglru_block(
    db: StatsDB,
    batch: int,
    n_tokens_per_seq: int,
    hidden: int,
    *,
    lru_width: Optional[int] = None,
    conv_kernel: int = 4,
    dtype_act: str = "bf16",
    dtype_w: str = "bf16",
    group_size: int = 128,
    fused: bool = False,
) -> None:
    """Griffin recurrent block: dual linear in, conv1d, RG-LRU, linear out."""
    width = lru_width or hidden
    ntok = batch * n_tokens_per_seq
    with db.scope("rglru"):
        F.linear(db, ntok, hidden, width, dtype_act=dtype_act,
                 dtype_w=dtype_w, group_size=group_size, name="linear_x")
        F.linear(db, ntok, hidden, width, dtype_act=dtype_act,
                 dtype_w=dtype_w, group_size=group_size, name="linear_y")
        F.conv1d(db, ntok, width, width, conv_kernel, dtype=dtype_act,
                 depthwise=True, read_input=not fused,
                 write_output=not fused, name="conv1d")
        # input gate + recurrence gate (elementwise "diagonal linears")
        F.elemw(db, ntok * width, n_operands=1, ops_per_el=4.0,
                dtype=dtype_act, read_input=not fused,
                write_output=not fused, name="gates")
        # recurrence h = a⊙h + sqrt(1-a²)⊙x : ~6 ops/el; fp32 state rd+wr
        state_bytes = batch * width * 4.0
        db.record("rglru_scan", ops=ntok * width * 6.0,
                  mem_rd=state_bytes, mem_wr=state_bytes,
                  kv_rd=state_bytes, kv_wr=state_bytes,
                  dispatches=1, op_class="scan")
        F.nonlinear_pwl(db, ntok * width, dtype=dtype_act,
                        read_input=not fused, write_output=not fused,
                        name="gelu_gate")
        F.elemw(db, ntok * width, n_operands=2, dtype=dtype_act,
                read_input=not fused, write_output=not fused, name="gate_mul")
        F.linear(db, ntok, width, hidden, dtype_act=dtype_act,
                 dtype_w=dtype_w, group_size=group_size, name="linear_out")


# ---------------------------------------------------------------------------
# Residual add — shared by all block types
# ---------------------------------------------------------------------------

def residual_add(db: StatsDB, n_tokens: int, hidden: int, *,
                 dtype: str = "bf16", fused: bool = False) -> None:
    F.elemw(db, n_tokens * hidden, n_operands=2, dtype=dtype,
            read_input=not fused, write_output=True, name="residual")
