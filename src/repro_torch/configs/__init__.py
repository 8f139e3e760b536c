"""Architecture config registry of the port: ``--arch <id>`` resolution.

The port serves the dense GQA decoders the engine's main path runs:
Llama-2-7B (the paper's study model) and Qwen2-7B (GQA with QKV bias),
and trains Granite-3.0-2B (the training launcher's example).
"""
from __future__ import annotations

import dataclasses

from .base import ArchConfig, MLAConfig

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

ARCHS = {
    "llama2-7b": LLAMA2_7B,
    "qwen2-7b": QWEN2_7B,
    "granite-3-2b": GRANITE_3_2B,
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


__all__ = ["ArchConfig", "MLAConfig", "ARCHS", "DEFAULT_KV_BLOCK_SIZE",
           "GRANITE_3_2B", "LLAMA2_7B", "QWEN2_7B", "get", "reduced"]
