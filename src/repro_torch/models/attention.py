"""Grouped-query attention (MHA / GQA / MQA, no KV repeat): the PyTorch
counterparts of the JAX package's ``models/attention.py`` for the dense
decoders the port serves."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from .layers import apply_rope

#: the reference switches to blockwise (flash-style) attention at this
#: sequence length; that schedule is not ported yet
BLOCKWISE_THRESHOLD = 4096


def _gqa_scores_softmax_out(q, k, v, mask, scale):
    """q: (b,s,Hk,G,hd); k,v: (b,L,Hk,hd); mask: (1|b,1,1,s,L) bool.

    Scores masked to -1e30, softmax in f32, probabilities cast to q's
    dtype before the PV product (as the reference)."""
    scores = torch.einsum("bskgd,blkd->bkgsl", q, k) * scale
    scores = torch.where(mask, scores.float(),
                         torch.tensor(-1e30, dtype=torch.float32,
                                      device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgsl,blkd->bskgd", probs, v)
    b, s = q.shape[0], q.shape[1]
    return out.reshape(b, s, -1)


def _mask(q_pos, k_pos, *, causal: bool):
    """(1,1,1,s,L) boolean attention mask from query/key positions."""
    m = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = m & (k_pos[None, :] <= q_pos[:, None])
    return m[None, None, None]


def _project_qkv(cfg: ArchConfig, p: Dict, x: torch.Tensor, positions,
                 deltas: Optional[Tuple] = None):
    """q (b,s,Hk,G,hd) and k, v (b,s,Hk,hd), RoPE applied to q and k.

    ``deltas`` (dq (b,s,H,hd), dk, dv (b,s,Hk,hd)) are per-request
    low-rank (LoRA) deltas, added before RoPE so a merged-weight run
    (W + A@B) produces the same rotated q/k."""
    b, s, d = x.shape
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].reshape(d, H * hd)).view(b, s, H, hd)
    k = (x @ p["wk"].reshape(d, Hk * hd)).view(b, s, Hk, hd)
    v = (x @ p["wv"].reshape(d, Hk * hd)).view(b, s, Hk, hd)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if deltas is not None:
        dq, dk, dv = deltas
        q = q + dq.to(q.dtype)
        k = k + dk.to(k.dtype)
        v = v + dv.to(v.dtype)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q.reshape(b, s, Hk, H // Hk, hd), k, v


def out_proj(cfg: ArchConfig, p: Dict, out: torch.Tensor) -> torch.Tensor:
    """``einsum("bshd,hde->bse")`` of the flat attention output."""
    b, s = out.shape[0], out.shape[1]
    H, hd = cfg.n_heads, cfg.head_dim
    return out.reshape(b, s, H * hd) @ p["wo"].reshape(H * hd, -1)


def self_attention(cfg: ArchConfig, p: Dict, x: torch.Tensor, *,
                   causal: bool = True) -> torch.Tensor:
    """Self-attention over the current sequence (uncached forward)."""
    b, s, _ = x.shape
    if s >= BLOCKWISE_THRESHOLD:
        raise NotImplementedError(
            f"sequences of {s} >= {BLOCKWISE_THRESHOLD} tokens take the "
            f"reference's blockwise path, which is not ported yet")
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    q, k, v = _project_qkv(cfg, p, x, positions)
    mask = _mask(positions[0], positions[0], causal=causal)
    out = _gqa_scores_softmax_out(q, k, v, mask, cfg.head_dim ** -0.5)
    return out_proj(cfg, p, out)
