"""Grouped-query attention (MHA / GQA / MQA, no KV repeat): the PyTorch
counterparts of the JAX package's ``models/attention.py`` for the dense
decoders the port serves and trains."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from .layers import apply_rope

#: sequences at or above this length use blockwise (flash-style) attention
#: on the eager path, as the reference does
BLOCKWISE_THRESHOLD = 4096
BLOCK_Q = 1024
BLOCK_K = 1024


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


def _mask(q_pos, k_pos, *, causal: bool, window: Optional[int] = None):
    """(1,1,1,s,L) boolean attention mask from query/key positions."""
    m = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = m & (k_pos[None, :] <= q_pos[:, None])
    if window:
        m = m & (k_pos[None, :] > q_pos[:, None] - window)
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
                   causal: bool = True, window: Optional[int] = None,
                   use_flash: bool = False) -> torch.Tensor:
    """Self-attention over the current sequence (training / uncached).

    ``use_flash`` runs the flash attention kernels (forward and backward)
    on q reshaped to (b, s, H, hd); otherwise sequences of at least
    ``BLOCKWISE_THRESHOLD`` tokens take :func:`blockwise_attention` and
    shorter ones the eager grouped-query path."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    q, k, v = _project_qkv(cfg, p, x, positions)
    scale = cfg.head_dim ** -0.5
    if use_flash:
        qf = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
        out = flash_attention(qf, k, v, causal=causal, window=window)
        out = out.reshape(b, s, -1)
    elif s >= BLOCKWISE_THRESHOLD:
        out = blockwise_attention(q, k, v, scale, causal=causal,
                                  window=window)
    else:
        mask = _mask(positions[0], positions[0], causal=causal,
                     window=window)
        out = _gqa_scores_softmax_out(q, k, v, mask, scale)
    return out_proj(cfg, p, out)


def blockwise_attention(q, k, v, scale, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        block_q: int = BLOCK_Q,
                        block_k: int = BLOCK_K) -> torch.Tensor:
    """Flash-style online-softmax attention as a plain loop over blocks
    (the reference's XLA scan): scores exist only at (block_q x block_k)
    granularity, in f32.  q: (b,s,Hk,G,d); k,v: (b,L,Hk,d); returns
    (b, s, Hk*G*d) in q's dtype."""
    b, s, Hk, G, d = q.shape
    L = k.shape[1]
    block_q = min(block_q, s)
    block_k = min(block_k, L)
    if s % block_q or L % block_k:
        raise ValueError(f"blockwise attention needs s={s} and L={L} to be "
                         f"multiples of the blocks {block_q}, {block_k}")
    dev = q.device
    outs = []
    for i0 in range(0, s, block_q):
        q_i = q[:, i0:i0 + block_q].float()
        acc = torch.zeros((b, Hk, G, block_q, d), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, Hk, G, block_q, 1), -1e30, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, Hk, G, block_q, 1), dtype=torch.float32,
                        device=dev)
        q_pos = q_offset + i0 + torch.arange(block_q, device=dev)
        for j0 in range(0, L, block_k):
            k_j = k[:, j0:j0 + block_k].float()
            v_j = v[:, j0:j0 + block_k].float()
            srs = torch.einsum("bskgd,blkd->bkgsl", q_i, k_j) * scale
            k_pos = j0 + torch.arange(block_k, device=dev)
            msk = torch.ones((block_q, block_k), dtype=torch.bool,
                             device=dev)
            if causal:
                msk &= k_pos[None, :] <= q_pos[:, None]
            if window is not None:
                msk &= k_pos[None, :] > q_pos[:, None] - window
            srs = torch.where(msk, srs, torch.full((), -1e30, device=dev))
            m_new = torch.maximum(m, srs.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            pr = torch.where(msk, torch.exp(srs - m_new),
                             torch.zeros((), device=dev))
            l = l * alpha + pr.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bkgsl,blkd->bkgsd", pr, v_j)
            m = m_new
        out_i = acc / torch.clamp(l, min=1e-30)
        # (b, Hk, G, block_q, d) -> (b, block_q, Hk*G*d)
        outs.append(out_i.permute(0, 3, 1, 2, 4).reshape(
            b, block_q, Hk * G * d).to(q.dtype))
    return torch.cat(outs, dim=1)
