"""Attention: grouped-query (MHA / GQA / MQA, no KV repeat), MLA
(compressed-latent cache, decompressed on every call), cross-attention
for the encoder-decoder, and the static caches of the lockstep step —
the PyTorch counterparts of the JAX package's ``models/attention.py``.

Under a tensor-parallel hint (``models.act_sharding``) every function
runs on the heads a rank holds (``runtime.sharding``), read from its
leaves: q/k/v (MLA's ``q_up``/``kv_up``, cross-attention's projections)
cut by columns, the output projection ``wo`` by rows, whose partial is
summed over the tp group in one ``all_reduce`` (``tp_all_reduce``).
Where a replicated activation meets the rank's columns (the input of
q/k/v; MLA's latents and rotary key; whole K/V read by cut query heads;
cross-attention's queries and encoder output) it passes through
``tp_copy``, whose backward sums the ranks' partial gradients, so every
whole leaf gets the same whole gradient on every rank.  KV heads that tp does
not divide stay whole (recurrentgemma-2b's one KV head, MLA's latent):
every rank writes the same whole cache and reads the KV heads its query
heads use.  A layer whose query heads tp does not divide runs whole on
every rank, with no collective.  ``cfg`` is the model's; the engine's
bodies pass ``runtime.sharding.local_config`` to :func:`_project_qkv`
and :func:`out_proj`, which read their widths from the leaves and hold
no collective."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention, flash_fwd
from . import act_sharding
from .layers import apply_rope, dense, rmsnorm

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


def _q_groups(cfg: ArchConfig, p: Dict) -> Tuple[int, int]:
    """(Hk, G) of the rank's queries: the KV heads they read and the
    query heads per KV head.  With KV heads whole and query heads cut,
    a rank's heads all in one group read that one KV head; otherwise
    each reads its own (:func:`_rank_kv` selects them)."""
    H, Hk = p["wq"].shape[-2], p["wk"].shape[-2]
    if H == cfg.n_heads or Hk < cfg.n_kv_heads:
        return Hk, H // Hk
    G = cfg.n_heads // cfg.n_kv_heads
    return (1, H) if G % H == 0 else (H, 1)


def _rank_kv(cfg: ArchConfig, p: Dict, k: torch.Tensor, v: torch.Tensor):
    """K/V (b, L, Hk, d) cut to the KV heads :func:`_q_groups` reads:
    as they are unless the KV heads stayed whole and the query heads
    were cut (the whole K/V then pass ``tp_copy``)."""
    H, Hk = p["wq"].shape[-2], k.shape[-2]
    if H == cfg.n_heads or Hk < cfg.n_kv_heads:
        return k, v
    k, v = act_sharding.tp_copy(k), act_sharding.tp_copy(v)
    G = cfg.n_heads // cfg.n_kv_heads
    first = act_sharding.tp_rank() * H
    if G % H == 0:
        return k.narrow(2, first // G, 1), v.narrow(2, first // G, 1)
    idx = torch.div(first + torch.arange(H, device=k.device), G,
                    rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


def _sum_heads(cfg: ArchConfig, p: Dict, y: torch.Tensor) -> torch.Tensor:
    """The output projection's partial summed over the tp group when the
    rank holds a cut of the heads (``wo``'s rows)."""
    if p["wo"].shape[0] < cfg.n_heads:
        return act_sharding.tp_all_reduce(y)
    return y


def _project_qkv(cfg: ArchConfig, p: Dict, x: torch.Tensor, positions,
                 deltas: Optional[Tuple] = None):
    """q (b,s,Hk,G,hd) and k, v (b,s,Hk,hd), RoPE applied to q and k:
    the heads of the leaves ``p`` holds, q grouped by :func:`_q_groups`.

    ``deltas`` (dq (b,s,H,hd), dk, dv (b,s,Hk,hd)) are per-request
    low-rank (LoRA) deltas, added before RoPE so a merged-weight run
    (W + A@B) produces the same rotated q/k."""
    b, s, d = x.shape
    H, Hk, hd = p["wq"].shape[-2], p["wk"].shape[-2], p["wq"].shape[-1]
    xq = act_sharding.tp_copy(x) if H < cfg.n_heads else x
    xkv = xq if Hk < cfg.n_kv_heads else x
    q = (xq @ p["wq"].reshape(d, H * hd)).view(b, s, H, hd)
    k = (xkv @ p["wk"].reshape(d, Hk * hd)).view(b, s, Hk, hd)
    v = (xkv @ p["wv"].reshape(d, Hk * hd)).view(b, s, Hk, hd)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if deltas is not None:
        dq, dk, dv = deltas
        q = q + dq.to(q.dtype)
        k = k + dk.to(k.dtype)
        v = v + dv.to(v.dtype)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q.reshape(b, s, *_q_groups(cfg, p), hd), k, v


def out_proj(cfg: ArchConfig, p: Dict, out: torch.Tensor) -> torch.Tensor:
    """``einsum("bshd,hde->bse")`` of the flat attention output (the
    heads ``wo`` holds; a partial sum under a cut)."""
    b, s = out.shape[0], out.shape[1]
    H, hd = p["wo"].shape[0], p["wo"].shape[1]
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
    k, v = _rank_kv(cfg, p, k, v)
    scale = cfg.head_dim ** -0.5
    if use_flash:
        qf = q.reshape(b, s, -1, cfg.head_dim)
        out = flash_attention(qf, k, v, causal=causal, window=window)
        out = out.reshape(b, s, -1)
    elif s >= BLOCKWISE_THRESHOLD:
        out = blockwise_attention(q, k, v, scale, causal=causal,
                                  window=window)
    else:
        mask = _mask(positions[0], positions[0], causal=causal,
                     window=window)
        out = _gqa_scores_softmax_out(q, k, v, mask, scale)
    return _sum_heads(cfg, p, out_proj(cfg, p, out))


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
    _check_blocks(s, L, block_q, block_k)
    block_q = min(block_q, s)
    block_k = min(block_k, L)
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


def _check_blocks(s: int, L: int, block_q: int = BLOCK_Q,
                  block_k: int = BLOCK_K) -> None:
    """:func:`blockwise_attention`'s precondition (the reference's assert)."""
    bq, bk = min(block_q, s), min(block_k, L)
    if s % bq or L % bk:
        raise ValueError(f"blockwise attention needs s={s} and L={L} to be "
                         f"multiples of the blocks {bq}, {bk}")


def lockstep_blockwise(q, k, v, *, window: Optional[int],
                       q_offset: int) -> torch.Tensor:
    """The lockstep step's flash-schedule branches (a long prompt chunk
    over the dense cache, a chunk of at least a window over itself):
    q (b,s,Hk,G,d); k, v (b,L,Hk,d) in q's dtype; causal, scores scaled
    by d**-0.5; returns (b, s, Hk*G*d).

    On the card the flash attention forward kernel (K6) computes it
    (head h reads KV head h // G, the reference's (Hk, G) order); on the
    CPU the plain :func:`blockwise_attention`.  Both take what the
    reference's blockwise loop takes (s and L multiples of its blocks)."""
    b, s, Hk, G, d = q.shape
    _check_blocks(s, k.shape[1])
    if not q.is_cuda:
        return blockwise_attention(q, k, v, d ** -0.5, causal=True,
                                   window=window, q_offset=q_offset)
    o, _ = flash_fwd(q.reshape(b, s, Hk * G, d).contiguous(),
                     k.contiguous(), v.contiguous(), causal=True,
                     window=window, q_offset=q_offset)
    return o.reshape(b, s, Hk * G * d)


# ---------------------------------------------------------------------------
# static caches of the lockstep step
# ---------------------------------------------------------------------------

def kv_cache_shape(cfg: ArchConfig, batch: int, max_len: int) -> Tuple:
    """(k, v) buffer shapes of one attention layer: MLA keeps the latent
    and the rotary key part."""
    if cfg.mla is not None:
        m = cfg.mla
        return ((batch, max_len, m.kv_lora_rank),
                (batch, max_len, m.qk_rope_head_dim))
    return ((batch, max_len, cfg.n_kv_heads, cfg.head_dim),) * 2


def to_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Activations into cache storage: the engine's ``to_kv`` (int8
    saturates, then truncates, as XLA's cast does)."""
    # imported here: the engine package imports the models at its import
    from repro_torch.engine.sampling import to_kv
    return to_kv(x, dtype)


def _write(cache: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """``dynamic_update_slice(cache, new, (0, pos, ...))`` in place: the
    start is clamped to [0, L - s] as XLA clamps it, so a write past the
    end lands on the last s positions instead of raising (both packages
    do this)."""
    s, L = new.shape[1], cache.shape[1]
    start = max(0, min(pos, L - s))
    cache[:, start:start + s] = to_cache(new, cache.dtype)


def cached_attention(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     *, window: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill (s = chunk) or decode (s = 1) against a static cache of
    L positions, ``pos`` tokens already in it.  The caches are written in
    place and returned.  Chunks of at least ``BLOCKWISE_THRESHOLD``
    tokens attend through :func:`lockstep_blockwise` over the whole
    cache; shorter ones through the eager masked path."""
    b, s, _ = x.shape
    L = cache_k.shape[1]
    positions = pos + torch.arange(s, dtype=torch.int32,
                                   device=x.device)[None, :]
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    _write(cache_k, k_new, pos)
    _write(cache_v, v_new, pos)
    k, v = _rank_kv(cfg, p, cache_k.to(x.dtype), cache_v.to(x.dtype))
    if s >= BLOCKWISE_THRESHOLD:
        out = lockstep_blockwise(q, k, v, window=window, q_offset=pos)
    else:
        k_pos = torch.arange(L, dtype=torch.int32, device=x.device)
        mask = _mask(positions[0], k_pos, causal=True, window=window)
        out = _gqa_scores_softmax_out(q, k, v, mask, cfg.head_dim ** -0.5)
    return _sum_heads(cfg, p, out_proj(cfg, p, out)), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_qkv(cfg: ArchConfig, p: Dict, x: torch.Tensor, positions):
    m = cfg.mla
    cq = rmsnorm(dense(x, p["q_down"]), p["q_norm"])
    if p["q_up"].shape[1] < cfg.n_heads:
        cq = act_sharding.tp_copy(cq)
    q = torch.einsum("bsr,rhk->bshk", cq, p["q_up"])
    q_nope, q_pe = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    c_latent, k_pe = dense(x, p["kv_down"]).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_latent = rmsnorm(c_latent, p["kv_norm"])
    k_pe = apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_pe, c_latent, k_pe


def _mla_core(cfg: ArchConfig, p: Dict, q_nope, q_pe, c_latent, k_pe, mask):
    """Decompress the latent of every cached position and attend."""
    m = cfg.mla
    if p["kv_up"].shape[1] < cfg.n_heads:
        c_latent = act_sharding.tp_copy(c_latent)
        k_pe = act_sharding.tp_copy(k_pe)
    kv = torch.einsum("blr,rhk->blhk", c_latent, p["kv_up"])
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    scores = (torch.einsum("bshk,blhk->bhsl", q_nope, k_nope)
              + torch.einsum("bshk,blk->bhsl", q_pe, k_pe)) * scale
    scores = torch.where(mask[:, :, 0], scores.float(),
                         torch.tensor(-1e30, dtype=torch.float32,
                                      device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(q_nope.dtype)
    out = torch.einsum("bhsl,blhk->bshk", probs, v)
    return _sum_heads(cfg, p, torch.einsum("bshk,hkd->bsd", out, p["wo"]))


def mla_self_attention(cfg: ArchConfig, p: Dict, x: torch.Tensor, *,
                       causal: bool = True) -> torch.Tensor:
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    q_nope, q_pe, c_latent, k_pe = _mla_qkv(cfg, p, x, positions)
    mask = _mask(positions[0], positions[0], causal=causal)
    return _mla_core(cfg, p, q_nope, q_pe, c_latent, k_pe, mask)


def mla_cached_attention(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                         cache_latent: torch.Tensor, cache_kpe: torch.Tensor,
                         pos: int):
    """MLA against its latent cache (written in place and returned)."""
    s = x.shape[1]
    L = cache_latent.shape[1]
    positions = pos + torch.arange(s, dtype=torch.int32,
                                   device=x.device)[None, :]
    q_nope, q_pe, c_latent, k_pe = _mla_qkv(cfg, p, x, positions)
    _write(cache_latent, c_latent, pos)
    _write(cache_kpe, k_pe, pos)
    mask = _mask(positions[0], torch.arange(L, dtype=torch.int32,
                                            device=x.device), causal=True)
    y = _mla_core(cfg, p, q_nope, q_pe, cache_latent.to(x.dtype),
                  cache_kpe.to(x.dtype), mask)
    return y, cache_latent, cache_kpe


# ---------------------------------------------------------------------------
# cross-attention (the encoder-decoder's decoder)
# ---------------------------------------------------------------------------

def cross_attention(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                    enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """Decoder queries against encoder K/V (b, F, H, hd), unmasked.  K/V
    stored in another dtype (a bf16 or int8 cache) meet q in their
    promoted dtype, as ``jnp.einsum`` promotes them."""
    hd = cfg.head_dim
    if p["wq"].shape[1] < cfg.n_heads:
        x = act_sharding.tp_copy(x)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    dt = torch.promote_types(q.dtype, enc_k.dtype)
    scores = torch.einsum("bshk,bfhk->bhsf", q.to(dt), enc_k.to(dt)) \
        * hd ** -0.5
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    dt = torch.promote_types(probs.dtype, enc_v.dtype)
    out = torch.einsum("bhsf,bfhk->bshk", probs.to(dt), enc_v.to(dt))
    return _sum_heads(cfg, p, torch.einsum("bshk,hkd->bsd", out, p["wo"]))


def encode_cross_kv(cfg: ArchConfig, p: Dict, enc_out: torch.Tensor):
    if p["wk"].shape[1] < cfg.n_heads:
        enc_out = act_sharding.tp_copy(enc_out)
    k = torch.einsum("bfd,dhk->bfhk", enc_out, p["wk"])
    v = torch.einsum("bfd,dhk->bfhk", enc_out, p["wv"])
    return k, v
