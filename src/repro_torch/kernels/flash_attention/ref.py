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
kernel) writes 0.  ``flash_attention``'s CPU path therefore zeroes those
rows of the oracle's output (:func:`live_rows`), as the JAX package's
``flash_attention`` does on the CPU by running its kernel; its backward
stays the oracle's, as the reference's custom VJP is.
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


def live_rows(s: int, L: int, *, causal: bool = True,
              window: Optional[int] = None, q_offset: int = 0,
              device=None) -> torch.Tensor:
    """(s,) bool: which query rows see at least one key under the mask of
    :func:`attention_ref` (a row sees keys ``[lo, hi)``)."""
    q_pos = q_offset + torch.arange(s, device=device)
    hi = torch.clamp(q_pos + 1, max=L) if causal else torch.full_like(q_pos, L)
    lo = (torch.clamp(q_pos - window + 1, min=0) if window is not None
          else torch.zeros_like(q_pos))
    return lo < hi
