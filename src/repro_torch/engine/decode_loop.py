"""Engine steps: chunked-prefill admission + fused multi-token decode over
all slots, attending through block tables (block-paged KV cache).

The PyTorch counterpart of the JAX package's ``engine/decode_loop.py``
(tp = pp = 1).  Where the reference scans over the stacked layers and
over ``decode_block`` tokens inside one ``jit``, the port runs Python
loops over both; the KV buffers are updated in place.

* ``prefill(params, state, tokens (1,C), slot, start, valid)`` admits one
  prompt chunk of one request at absolute positions ``start ..``; rows at
  or past ``valid`` are padding.
* ``decode(params, state, active, remaining, generator)`` runs
  ``decode_block`` greedy (or sampled) steps for every slot, with
  active-slot masking and EOS/budget attrition.

Two attention read paths (``attn_impl``):

* ``"gather"`` — plain PyTorch: gather the table's blocks back into the
  slot's contiguous virtual sequence and attend eagerly (bf16 probs).
* ``"paged"``  — the hand-written Hopper kernels of
  ``repro_torch.kernels.paged_attention`` (f32 probs, online softmax),
  which read K/V block by block through the table.

KV writes select their live rows explicitly.  The reference drops the
writes of padding rows and inactive slots by scattering them to the
out-of-range block id ``N``, which JAX discards; torch indexing would
raise (CPU) or fault (CUDA) instead.  Prefill writes only its first
``valid`` rows (a host integer).  Decode writes only the rows of slots
active when the block started (known on the host); a slot that stops
mid-block writes its own cache entry back unchanged, at a position it
owns, so no step needs the device's ``active`` mask on the host.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import attention as A
from repro_torch.models.blocks import mlp_forward
from repro_torch.models.layers import apply_norm
from repro_torch.models.model import _lm_head, layer_params

from .kv_cache import BlockPagedKVCache
from .sampling import sample, to_kv

ATTN_IMPLS = ("gather", "paged")

#: (block ids, in-block offsets, keep mask or None) of one step's KV writes
KVWrite = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def _write_kv(cache: torch.Tensor, dst: KVWrite, new: torch.Tensor) -> None:
    """Store ``new`` (n, Hk, hd) at ``cache[blk, off]`` in place; rows
    whose keep flag is False write the entry's current value back."""
    blk, off, keep = dst
    new = to_kv(new, cache.dtype)
    if keep is not None:
        new = torch.where(keep[:, None, None], new, cache[blk, off])
    cache[blk, off] = new


def _channel_mix(cfg: ArchConfig, p, x):
    h = apply_norm(cfg.norm_kind, x, p["ln2"])
    return x + mlp_forward(cfg, p["mlp"], h)


def _prefill_layer(cfg: ArchConfig, p, x, ck, cv, bt_slot, pos_q,
                   dst: KVWrite, start: int, valid: int,
                   attn_impl: str = "gather"):
    """One layer of a single-slot prompt chunk.

    x: (1, C, d); ck/cv: (N, bs, Hk, hd) this layer's block pool (written
    in place); bt_slot: (max_bps,) the slot's table; pos_q: (C,) absolute
    positions of the chunk; ``dst`` the targets of its first ``valid``
    rows, the live ones (padding rows are neither written nor used).
    """
    bs = ck.shape[1]
    L_virt = bt_slot.shape[0] * bs
    b, s = x.shape[0], x.shape[1]
    h = apply_norm(cfg.norm_kind, x, p["ln1"])
    q, k_new, v_new = A._project_qkv(cfg, p["attn"], h, pos_q[None, :])
    _write_kv(ck, dst, k_new[0, :valid])
    _write_kv(cv, dst, v_new[0, :valid])
    if attn_impl == "paged":
        # read K/V block by block through the table: no page buffer
        out = paged_ops.paged_prefill(q[0], ck, cv, bt_slot, start, valid).reshape(b, s, -1)
    else:
        page_k = ck[bt_slot].reshape(1, L_virt, *ck.shape[2:])
        page_v = cv[bt_slot].reshape(1, L_virt, *cv.shape[2:])
        k_pos = torch.arange(L_virt, device=x.device)
        mask = ((k_pos[None, :] <= pos_q[:, None])
                & (k_pos[None, :] < start + valid))[None, None, None]
        out = A._gqa_scores_softmax_out(q, page_k.to(x.dtype),
                                        page_v.to(x.dtype), mask,
                                        cfg.head_dim ** -0.5)
    y = A.out_proj(cfg, p["attn"], out)
    return _channel_mix(cfg, p, x + y)


def _decode_layer(cfg: ArchConfig, p, x, ck, cv, bt, pos, live,
                  dst: KVWrite, attn_impl: str = "gather"):
    """One layer of a one-token step for ALL slots.

    x: (S, 1, d); ck/cv: (N, bs, Hk, hd); bt: (S, max_bps) block tables;
    pos: (S,) per-slot cursors; ``live`` (n,) the slots whose K/V this
    step writes, at ``dst``.
    """
    bs = ck.shape[1]
    S_, max_bps = bt.shape
    L_virt = max_bps * bs
    h = apply_norm(cfg.norm_kind, x, p["ln1"])
    q, k_new, v_new = A._project_qkv(cfg, p["attn"], h, pos[:, None])
    _write_kv(ck, dst, k_new[live, 0])
    _write_kv(cv, dst, v_new[live, 0])
    if attn_impl == "paged":
        # block-by-block flash decode per slot table; blocks past each
        # slot's cursor are skipped inside the kernel
        out = paged_ops.paged_decode(q[:, 0], ck, cv, bt, pos).reshape(S_, 1, -1)
    else:
        page_k = ck[bt].reshape(S_, L_virt, *ck.shape[2:])
        page_v = cv[bt].reshape(S_, L_virt, *cv.shape[2:])
        k_pos = torch.arange(L_virt, device=x.device)
        # per-slot causal mask over its virtual sequence (keys strictly
        # before + the token just written at pos)
        mask = (k_pos[None, :] <= pos[:, None])[:, None, None, None, :]
        out = A._gqa_scores_softmax_out(q, page_k.to(x.dtype),
                                        page_v.to(x.dtype), mask,
                                        cfg.head_dim ** -0.5)
    y = A.out_proj(cfg, p["attn"], out)
    return _channel_mix(cfg, p, x + y)


def make_engine_fns(cfg: ArchConfig, cache: BlockPagedKVCache, *,
                    chunk_size: int, decode_block: int,
                    temperature: float = 0.0, eos_id: Optional[int] = None,
                    attn_impl: str = "gather"):
    """Returns ``(prefill_fn, decode_fn)``.

    prefill_fn(params, state, tokens (1,C), slot, start, valid)
        -> (logits (V,), state);  slot/start/valid are host integers
    decode_fn(params, state, active (S,), remaining (S,), generator)
        -> (tokens (n,S), produced (n,S), active (S,), state);  ``active``
        and ``remaining`` are host (numpy) arrays, the outputs stay on
        the device
    """
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                         f"got {attn_impl!r}")
    bs = cache.block_size

    def prefill(params, state, tokens, slot: int, start: int, valid: int):
        dev = state["pos"].device
        x = params["embed"][tokens]                              # (1, C, d)
        pos_q = start + torch.arange(chunk_size, dtype=torch.int32,
                                     device=dev)
        bt_slot = state["block_tables"][slot]                   # (max_bps,)
        wpos = pos_q[:valid].long()
        dst = (bt_slot[wpos // bs].long(), wpos % bs, None)
        ck_all, cv_all = state["cache_k"], state["cache_v"]
        for li, p in enumerate(layer_params(params)):
            x = _prefill_layer(cfg, p, x, ck_all[li], cv_all[li], bt_slot,
                               pos_q, dst, start, valid, attn_impl)
        x = apply_norm(cfg.norm_kind, x, params["ln_f"])
        logits = _lm_head(cfg, params, x[:, valid - 1:valid])[0, 0]  # (V,)
        state["pos"][slot] += valid
        return logits, state

    def decode(params, state, active: np.ndarray, remaining: np.ndarray,
               generator: Optional[torch.Generator] = None):
        dev = state["pos"].device
        bt = state["block_tables"]
        live = torch.as_tensor(np.flatnonzero(active), dtype=torch.long,
                               device=dev)
        act = torch.as_tensor(np.asarray(active, bool), device=dev)
        rem = torch.as_tensor(np.asarray(remaining, np.int32), device=dev)
        pos, tok = state["pos"].clone(), state["tok"].clone()
        # the last position each live slot writes in this block: its
        # allocation covers it, and a slot that stops early parks there
        cap = pos[live] + rem[live] - 1
        bt_live = bt[live].long()
        rows = torch.arange(live.shape[0], device=dev)
        layers = layer_params(params)
        ck_all, cv_all = state["cache_k"], state["cache_v"]
        toks, prods = [], []
        for _ in range(decode_block):
            x = params["embed"][tok][:, None]                    # (S, 1, d)
            wpos = torch.minimum(pos[live], cap).long()
            dst = (bt_live[rows, wpos // bs], wpos % bs, act[live])
            for li, p in enumerate(layers):
                x = _decode_layer(cfg, p, x, ck_all[li], cv_all[li], bt, pos,
                                  live, dst, attn_impl)
            x = apply_norm(cfg.norm_kind, x, params["ln_f"])
            logits = _lm_head(cfg, params, x[:, -1:])[:, 0]      # (S, V)
            nxt = sample(logits, temperature, generator).to(torch.int32)
            produced = act
            hit_eos = ((nxt == eos_id) if eos_id is not None
                       else torch.zeros_like(act))
            rem = rem - act.int()
            new_act = act & (rem > 0) & ~hit_eos
            pos = pos + act.int()
            tok = torch.where(act, nxt, tok)
            toks.append(torch.where(act, nxt, torch.full_like(nxt, -1)))
            prods.append(produced)
            act = new_act
        state["pos"].copy_(pos)
        state["tok"].copy_(tok)
        return torch.stack(toks), torch.stack(prods), act, state

    return prefill, decode
