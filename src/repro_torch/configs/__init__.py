"""Architecture config registry of the port: ``--arch <id>`` resolution.

The port's engine serves the dense GQA decoders of its main path,
Llama-2-7B (the paper's study model) and Qwen2-7B (GQA with QKV bias),
the MoE decoders (Qwen1.5-MoE-A2.7B, DeepSeekMoE-16B) and InternVL2-26B's
language stack; its lockstep server also serves the SSM, hybrid, MLA and
encoder-decoder families (Falcon-Mamba-7B, RecurrentGemma-2B,
Llama-2-7B-MLA, Whisper-base).  It trains Granite-3.0-2B (the training
launcher's example).  Every architecture of the JAX package's registry
is here, for the models and for the analytical half (``core``, ``api``).
"""
from __future__ import annotations

import dataclasses

from .base import PAPER_VARIANTS, ArchConfig, MLAConfig, Variant

#: default tokens per KV block of the paged cache (the JAX package keeps
#: the same constant in ``core/workload.py``)
DEFAULT_KV_BLOCK_SIZE = 16

# Llama-2-7B [arXiv:2307.09288]: the paper's study model
LLAMA2_7B = ArchConfig(
    name="llama2-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab_size=32000, head_dim=128,
    max_position=4096,
)

# Qwen2-7B [arXiv:2407.10671]: dense, GQA kv=4, QKV bias
QWEN2_7B = ArchConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128, qkv_bias=True,
)

# Granite-3.0-2B [hf:ibm-granite/granite-3.0-2b-base]: dense, GQA kv=8,
# tied embeddings (the training launcher's example)
GRANITE_3_2B = ArchConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=49155, head_dim=64, tie_embeddings=True,
)

# MLA-converted Llama-2-7B twin (paper Appendix 8.2 config: Q/KV rank 128)
LLAMA2_7B_MLA = ArchConfig(
    name="llama2-7b-mla", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab_size=32000, head_dim=128,
    max_position=4096,
    mla=MLAConfig(q_lora_rank=128, kv_lora_rank=128,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
)

# The JAX package's other architectures, as data for the analytical half.
# GLM-4-9B [hf:THUDM/glm-4-9b]: dense, RoPE, GQA kv=2
GLM4_9B = ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=151552, head_dim=128,
)

# Llama-3-405B [arXiv:2407.21783]: dense, GQA kv=8, 128k vocab
LLAMA3_405B = ArchConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab_size=128256, head_dim=128,
    rope_theta=500000.0,
)

# InternVL2-26B [arXiv:2404.16821]: VLM, InternLM2-20B backbone with
# stub patch embeddings prepended to the text sequence
INTERNVL2_26B = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92553, head_dim=128,
    vision_prefix_len=256,
)

# Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 4 shared + 60 routed top-4
QWEN2_MOE_A2_7B = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936, head_dim=128,
    n_experts=60, top_k=4, n_shared_experts=4, d_ff_expert=1408,
)

# DeepSeekMoE-16B [arXiv:2401.06066]: 2 shared + 64 routed top-6
DEEPSEEK_MOE_16B = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400, head_dim=128,
    n_experts=64, top_k=6, n_shared_experts=2, d_ff_expert=1408,
)

# Whisper-base [arXiv:2212.04356]: encoder-decoder, conv frontend stub
WHISPER_BASE = ArchConfig(
    name="whisper-base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51865, head_dim=64,
    norm_kind="layernorm", gated_mlp=False,
    n_encoder_layers=6, encoder_len=1500,
)

# RecurrentGemma-2B [arXiv:2402.19427]: RG-LRU + local attention, 1:2
RECURRENTGEMMA_2B = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "attn"),
    local_window=2048, lru_width=2560, tie_embeddings=True,
    gated_mlp=True,
)

# Falcon-Mamba-7B [arXiv:2410.05355]: Mamba-1, attention-free
FALCON_MAMBA_7B = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65024, head_dim=0,
    ssm_d_state=16, ssm_expand=2, ssm_conv_kernel=4, ssm_dt_rank=256,
    gated_mlp=False,
)

ARCHS = {
    "glm4-9b": GLM4_9B,
    "llama3-405b": LLAMA3_405B,
    "qwen2-7b": QWEN2_7B,
    "granite-3-2b": GRANITE_3_2B,
    "internvl2-26b": INTERNVL2_26B,
    "qwen2-moe-a2.7b": QWEN2_MOE_A2_7B,
    "deepseek-moe-16b": DEEPSEEK_MOE_16B,
    "whisper-base": WHISPER_BASE,
    "recurrentgemma-2b": RECURRENTGEMMA_2B,
    "falcon-mamba-7b": FALCON_MAMBA_7B,
    "llama2-7b": LLAMA2_7B,
    "llama2-7b-mla": LLAMA2_7B_MLA,
}


#: The 10 assigned architectures (the dry-run grid; the reference's list).
ASSIGNED = [
    "glm4-9b", "llama3-405b", "qwen2-7b", "granite-3-2b", "internvl2-26b",
    "qwen2-moe-a2.7b", "deepseek-moe-16b", "whisper-base",
    "recurrentgemma-2b", "falcon-mamba-7b",
]

#: Assigned input-shape set (LM-family): name -> (seq_len, global_batch,
#: kind), the reference's
SHAPES = {
    "train_4k":    (4096,   256, "train"),
    "prefill_32k": (32768,  32,  "prefill"),
    "decode_32k":  (32768,  128, "decode"),
    "long_500k":   (524288, 1,   "decode"),
}


def get(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}") from None


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Tiny same-family config for CPU tests (few layers, narrow widths).

    Produces the same config as the JAX package's ``configs.reduced`` for
    the dense families registered here.
    """
    small = dict(
        n_layers=min(cfg.n_layers, 2 if not cfg.block_pattern else len(cfg.block_pattern)),
        d_model=128,
        n_heads=min(cfg.n_heads, 4) if cfg.n_heads else 0,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)) if cfg.n_heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32 if cfg.n_heads else 0,
        max_position=1024,
    )
    if cfg.family == "moe":
        small.update(n_experts=8, top_k=2, n_shared_experts=min(2, cfg.n_shared_experts),
                     d_ff_expert=64)
    if cfg.family == "ssm":
        small.update(ssm_d_state=8, ssm_dt_rank=8)
    if cfg.family == "hybrid":
        small.update(local_window=64, lru_width=128)
    if cfg.family == "encdec":
        small.update(n_encoder_layers=2, encoder_len=64)
    if cfg.family == "vlm":
        small.update(vision_prefix_len=8)
    if cfg.mla is not None:
        small.update(mla=MLAConfig(q_lora_rank=32, kv_lora_rank=32,
                                   qk_nope_head_dim=32, qk_rope_head_dim=16,
                                   v_head_dim=32))
    small.update(overrides)
    small["name"] = cfg.name + "-reduced"
    return dataclasses.replace(cfg, **small)


__all__ = ["ArchConfig", "MLAConfig", "Variant", "PAPER_VARIANTS", "ARCHS",
           "DEFAULT_KV_BLOCK_SIZE", "GRANITE_3_2B", "LLAMA2_7B",
           "LLAMA2_7B_MLA", "QWEN2_7B", "get", "reduced"]
