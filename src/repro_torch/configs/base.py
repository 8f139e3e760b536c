"""Architecture configuration schema for the PyTorch port.

A copy of ``ArchConfig`` (and the ``MLAConfig`` it refers to), ``Variant``
and ``PAPER_VARIANTS`` from the JAX package's ``configs/base.py``: the port
keeps its own copy so that it imports nothing of the JAX package.  Field
names, defaults and derived quantities are identical, so a config built
on either side describes the same model.

``Variant`` captures the paper's §3.2/§3.3 software+model optimization
settings (Table 3 rows are instances of it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 128
    kv_lora_rank: int = 128
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_kind: str = "rmsnorm"
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    max_position: int = 131072
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    # --- SSM (Mamba-1) ---
    ssm_d_state: int = 0
    ssm_expand: int = 2
    ssm_conv_kernel: int = 4
    ssm_dt_rank: int = 0
    # --- hybrid (RecurrentGemma / Griffin) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru","rglru","attn")
    local_window: int = 0                 # local-attention window
    lru_width: int = 0
    # --- encoder-decoder (Whisper) ---
    n_encoder_layers: int = 0
    encoder_len: int = 0                  # precomputed frame count (stub)
    # --- VLM (stub frontend) ---
    vision_prefix_len: int = 0            # patch-embedding count (stub)
    # --- MLA ---
    mla: Optional[MLAConfig] = None

    def __post_init__(self):
        if self.head_dim is None and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived quantities -------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_subquadratic(self) -> bool:
        """True when decode memory does not grow linearly without bound."""
        return self.family in ("ssm", "hybrid")

    @property
    def attn_dim(self) -> int:
        return (self.head_dim or 0) * self.n_heads

    def block_kinds(self) -> Tuple[str, ...]:
        """Per-layer temporal-mixer kind for the decoder stack."""
        if self.family == "ssm":
            return tuple("ssm" for _ in range(self.n_layers))
        if self.family == "hybrid":
            pat = self.block_pattern or ("rglru", "rglru", "attn")
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        return tuple("attn" for _ in range(self.n_layers))

    def param_count(self) -> float:
        """Total parameters N (analytical; used for MODEL_FLOPS = 6·N·D)."""
        return self._params(active_only=False)

    def active_param_count(self) -> float:
        """Active parameters per token (MoE: shared + top_k experts)."""
        return self._params(active_only=True)

    def _params(self, active_only: bool) -> float:
        d, hd = self.d_model, (self.head_dim or 0)
        total = float(self.vocab_size * d)           # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d             # lm head
        for kind in self.block_kinds():
            total += 2 * d                           # norms
            if kind == "attn":
                if self.mla:
                    m = self.mla
                    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                    total += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
                    total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    total += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    total += self.n_heads * m.v_head_dim * d
                else:
                    total += d * self.n_heads * hd                # Q
                    total += 2 * d * self.n_kv_heads * hd         # K,V
                    total += self.n_heads * hd * d                # O
                    if self.qkv_bias:
                        total += (self.n_heads + 2 * self.n_kv_heads) * hd
            elif kind == "ssm":
                di = self.ssm_expand * d
                dtr = self.ssm_dt_rank or max(1, d // 16)
                total += d * 2 * di + di * self.ssm_conv_kernel
                total += di * (dtr + 2 * self.ssm_d_state) + dtr * di
                total += di * self.ssm_d_state + di   # A, D
                total += di * d                       # out_proj
            elif kind == "rglru":
                w = self.lru_width or d
                total += 2 * d * w + w * self.ssm_conv_kernel + 2 * w + w * d
            # MLP / MoE (mamba has none)
            if self.family == "moe":
                n_routed = self.n_experts if not active_only else self.top_k
                total += d * self.n_experts            # router
                total += n_routed * 3 * d * self.d_ff_expert
                total += self.n_shared_experts * 3 * d * self.d_ff_expert
            elif kind != "ssm" and self.d_ff > 0:
                mult = 3 if self.gated_mlp else 2
                total += mult * d * self.d_ff
        # encoder stack (whisper): self-attn + MLP per encoder layer,
        # + cross-attn params live in the decoder count above — add here
        if self.n_encoder_layers:
            per_enc = 4 * d * self.n_heads * hd / self.n_heads * self.n_heads  # QKVO square
            per_enc = 4 * d * d + (3 if self.gated_mlp else 2) * d * self.d_ff + 2 * d
            total += self.n_encoder_layers * per_enc
            # decoder cross-attention QKVO per decoder layer
            total += self.n_layers * 4 * d * d
        return total

    def kv_bytes_per_token(self, kv_dtype_bytes: float = 2.0) -> float:
        """KV-cache bytes appended per generated token (all layers)."""
        hd = self.head_dim or 0
        per_attn = 2 * self.n_kv_heads * hd * kv_dtype_bytes
        if self.mla:
            per_attn = (self.mla.kv_lora_rank + self.mla.qk_rope_head_dim) * kv_dtype_bytes
        n_attn = sum(1 for k in self.block_kinds() if k == "attn")
        return n_attn * per_attn


@dataclasses.dataclass(frozen=True)
class Variant:
    """Software/model-optimization operating point (paper Table 3)."""
    name: str = "bf16-bf16"
    dtype_act: str = "bf16"
    dtype_w: str = "bf16"
    kv_dtype: str = "bf16"
    fused: bool = False                 # operator fusion (§3.2.1)
    group_size: int = 128               # weight-quant group size
    lora_rank: Optional[int] = None     # LoRA adapter rank
    lora_inline: bool = False           # dynamic per-GEMM merge vs one-time
    use_mla: bool = False               # MHA→MLA conversion (§3.3.2)
    actfn_algo: str = "pwl"             # pwl | poly
    actfn_table_size: int = 256
    pad_to: int = 1                     # decode BMM padding tile (§3.2.2)
    chunk_size: Optional[int] = None    # chunked prefill (§3.3.4)


# Paper Table 3: Llama2-7B variants studied.
PAPER_VARIANTS = {
    "bf16-bf16": Variant(name="bf16-bf16"),
    "bf16-int4": Variant(name="bf16-int4", dtype_w="int4"),
    "bf16-int4-fused": Variant(name="bf16-int4-fused", dtype_w="int4", fused=True),
    "bf16-int4-kv4": Variant(name="bf16-int4-kv4", dtype_w="int4",
                             kv_dtype="int4", fused=True),
    "bf16-int4-kv8": Variant(name="bf16-int4-kv8", dtype_w="int4",
                             kv_dtype="int8", fused=True),
    "bf16-int4-mla": Variant(name="bf16-int4-mla", dtype_w="int4",
                             fused=True, use_mla=True),
    "bf16-int4-lora": Variant(name="bf16-int4-lora", dtype_w="int4",
                              fused=True, lora_rank=64, lora_inline=True),
    "quarot-w4a4kv4": Variant(name="quarot-w4a4kv4", dtype_act="int8",
                              dtype_w="int4", kv_dtype="int4", fused=True),
    "fp16-fp16": Variant(name="fp16-fp16", dtype_act="fp16", dtype_w="fp16",
                         kv_dtype="fp16"),
}
