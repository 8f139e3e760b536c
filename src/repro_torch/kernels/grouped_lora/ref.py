"""Plain PyTorch versions of the grouped-LoRA kernel.

``grouped_lora_ref`` gathers each slot's adapter factors out of the pool
and runs the two low-rank contractions as batched einsums in f32 — the
straightforward formulation the CUDA kernel of ``csrc/`` must match, and
what the wrapper in ``ops.py`` computes for tensors on the CPU.
``grouped_lora_pregathered`` is the same after the pool gather has been
hoisted out of the step and layer loops (the engine's ``gather`` path).
"""
from __future__ import annotations

import torch


def grouped_lora_ref(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                     idx: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``scale·(x @ A[idx]) @ B[idx]`` with exact zeros where idx < 0.

    x: (S, T, k); A: (P, k, R) and B: (P, R, n) rank-padded pools; idx:
    (S,) pool slot per batch slot (-1 = no adapter).  Products accumulate
    in f32; the result is in x's dtype."""
    idx = idx.to(x.device).long()
    safe = idx.clamp(min=0)
    a = A[safe].float()                                   # (S, k, R)
    b = B[safe].float()                                   # (S, R, n)
    xa = torch.einsum("stk,skr->str", x.float(), a)
    d = torch.einsum("str,srn->stn", xa, b) * scale
    d = torch.where((idx >= 0)[:, None, None], d, torch.zeros((), device=x.device))
    return d.to(x.dtype)


def grouped_lora_pregathered(x: torch.Tensor, a: torch.Tensor,
                             b: torch.Tensor, idx=None,
                             scale: float = 1.0) -> torch.Tensor:
    """:func:`grouped_lora_ref` after the pool gather: ``a`` (S, k, R) and
    ``b`` (S, R, n) are each slot's factors with hole slots (idx < 0)
    already zeroed, so hole deltas are exact zeros (``x @ 0 @ 0``);
    ``idx`` is ignored."""
    xa = torch.einsum("stk,skr->str", x.float(), a.float())
    d = torch.einsum("str,srn->stn", xa, b.float()) * scale
    return d.to(x.dtype)


def pregather(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(L, P, ...)`` pool buffer -> ``(L, S, ...)`` per-slot factors,
    hole slots (idx < 0) zeroed (the reference's ``_pregather_lora``)."""
    idx = idx.to(pool.device).long()
    got = pool[:, idx.clamp(min=0)]
    live = (idx >= 0).reshape(1, -1, *([1] * (pool.dim() - 2)))
    return torch.where(live, got, torch.zeros((), dtype=pool.dtype,
                                              device=pool.device))
