"""Plain PyTorch version of the flash attention kernel (the JAX package's
``kernels/flash_attention/ref.py`` oracle).

Scores and probabilities are f32, masked to -1e30, and the output is cast
to q's dtype.  Its backward is PyTorch's autograd through it, as the
reference's ``_fa_bwd`` takes ``jax.vjp`` of its oracle.  The wrapper in
``ops.py`` runs it only for tensors on the CPU; ``chip_smoke.py`` holds the
CUDA kernels to it on the card.

One difference from the kernel: a row with no live key (possible only
with a window, or with ``q_offset`` past the keys) gets a softmax over
-1e30 everywhere here, i.e. the mean of v, where the kernel (like the TPU
kernel) writes 0.  No training shape has such a row: causal attention at
``q_offset >= 0`` always keeps the diagonal.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q: (b, s, H, d); k, v: (b, L, Hk, d); GQA by head grouping."""
    b, s, H, d = q.shape
    _, L, Hk, _ = k.shape
    group = H // Hk
    qg = q.reshape(b, s, Hk, group, d)
    scores = torch.einsum("bskgd,blkd->bkgsl", qg.float(),
                          k.float()) * (d ** -0.5)
    q_pos = q_offset + torch.arange(s, device=q.device)
    k_pos = torch.arange(L, device=q.device)
    mask = torch.ones((s, L), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    scores = torch.where(mask[None, None, None], scores,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgsl,blkd->bskgd", probs, v.float())
    return out.reshape(b, s, H, d).to(q.dtype)
