"""Leaf helpers of the engine: KV dtype map, token sampling and the
saturating cast into integer KV storage."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import act_sharding

KV_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16,
             "int8": torch.int8, "fp32": torch.float32}


def kv_torch_dtype(name: str) -> torch.dtype:
    return KV_DTYPES[name]


def to_kv(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast activations into KV storage.

    int8 KV is a plain cast with no scale, as in the reference
    (``.astype(int8)``).  XLA saturates a float->int8 conversion, while
    torch wraps it (bf16 300 -> 44), so the values are clamped to
    [-128, 127] first; the cast itself truncates toward zero in both.
    """
    if dtype == torch.int8:
        return x.clamp(-128, 127).to(torch.int8)
    return x.to(dtype)


def sample(logits: torch.Tensor, temperature: float,
           generator: Optional[torch.Generator] = None, *,
           vocab: int) -> torch.Tensor:
    """Greedy (T=0) or temperature sampling over the last axis -> int64.

    ``vocab`` is the whole vocabulary's size; ``logits`` hold all of it
    or a tp rank's block of it.  Greedy takes ``act_sharding.tp_argmax``,
    and temperature sampling draws from ``act_sharding.tp_whole_logits``,
    the same draw with the same generator on every rank.  Temperature
    draws come from ``generator``; they follow the same categorical
    distribution as the reference's ``jax.random.categorical`` but not
    its bits."""
    if temperature <= 0.0:
        return act_sharding.tp_argmax(logits, vocab)
    logits = act_sharding.tp_whole_logits(logits, vocab)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draw = torch.multinomial(flat, 1, generator=generator)
    return draw.reshape(probs.shape[:-1])
