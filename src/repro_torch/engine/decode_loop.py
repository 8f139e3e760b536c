"""Engine steps: chunked-prefill admission, fused multi-token decode,
speculative verify and bucketed batched prefill over all slots, attending
through block tables (block-paged KV cache).

The PyTorch counterpart of the JAX package's ``engine/decode_loop.py``.
Where the reference scans over the stacked layers and over
``decode_block`` tokens inside one ``jit``, the port runs Python loops
over both; the KV buffers are updated in place.

* ``prefill(params, state, tokens (1,C), slot, start, valid)`` admits one
  prompt chunk of one request at absolute positions ``start ..``; rows at
  or past ``valid`` are padding.
* ``decode(params, state, active, remaining, generator)`` runs
  ``decode_block`` greedy (or sampled) steps for every slot, with
  active-slot masking and EOS/budget attrition.
* ``verify(params, state, qtoks (S,Q), active, valid_q)`` scores every
  slot's pending token plus its drafts in one multi-query pass
  (:func:`make_verify_fn`).
* ``prefill_batch(params, state, qtoks (B,C), slots, valids)`` admits one
  chunk of each of up to B same-bucket requests in one pass
  (:func:`make_prefill_batch_fn`); it is a verify pass over the group's
  tables and cursors.

Two attention read paths (``attn_impl``):

* ``"gather"`` — plain PyTorch: gather the table's blocks back into the
  slot's contiguous virtual sequence and attend eagerly (bf16 probs).
* ``"paged"``  — the hand-written Hopper kernels of
  ``repro_torch.kernels.paged_attention`` (f32 probs, online softmax),
  which read K/V block by block through the table.

With a device adapter pool in the state (multi-tenant LoRA), every layer
body adds per-slot grouped low-rank deltas on q/k/v (pre-RoPE) and on the
attention output: the ``paged`` impl through the CUDA kernel of
``repro_torch.kernels.grouped_lora``, the ``gather`` impl through its
plain version on factors gathered once per dispatch (as the reference's
``_make_lora_fn`` splits them).

Tensor parallelism (a mesh whose ``"model"`` axis has ``tp > 1`` ranks,
``repro_torch.launch.mesh``): each rank holds its shard of the weights
(``runtime.sharding``) and of the block pool, ``n_kv_heads/tp`` heads of
every block, and runs the layer bodies on its ``n_heads/tp`` query heads
(``sharding.local_config``).  q/k/v and gate/up are column-parallel,
o_proj and down_proj row-parallel, and the only traffic between ranks is
one ``all_reduce`` after each row-parallel product, as in the reference,
where XLA inserts it.  The paged kernels run unchanged on the rank's
heads: a rank only ever holds its shard, so nothing needs the
reference's ``shard_map``.  Grouped LoRA splits the pool's rank lanes
(``grouped_lora.ops.make_sharded_grouped_lora``): the q/k/v deltas are
summed in one ``all_reduce``; the o projection's input is sharded by
head, so the rank first gathers it (an ``all_reduce`` of a zero-filled
buffer), and its partial delta joins o_proj's partial in that
projection's one ``all_reduce``.  An MoE layer runs expert-parallel
(``models.blocks.moe_forward``).

Pipeline parallelism (a ``"pipe"`` axis of ``pp > 1`` stages):
``models.act_sharding.staged_scan``, the reference's, runs the stage's
``L/pp`` contiguous layers against its own weights and pool; only the carried
activation crosses stages, by ``broadcast`` over a two-rank group, and
the last stage's logits (or sampled tokens) are broadcast back along the
pipeline column, so every rank keeps the same host state.  The op
sequence is the one-stage sequence's, so tokens do not depend on pp.

KV writes select their live rows explicitly.  The reference drops the
writes of padding rows, inactive slots and ``valid = 0`` members by
scattering them to the out-of-range block id ``N``, which JAX discards;
torch indexing would raise (CPU) or fault (CUDA) instead.  Prefill writes
only its first ``valid`` rows and verify only the live ``(slot, query)``
rows (both host integers).  Decode writes only the rows of slots active
when the block started (known on the host); a slot that stops mid-block
writes its own cache entry back unchanged, at a position it owns, so no
step needs the device's ``active`` mask on the host.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.grouped_lora import ops as lora_ops
from repro_torch.kernels.grouped_lora.ref import (grouped_lora_pregathered,
                                                  pregather)
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import act_sharding
from repro_torch.models.act_sharding import from_last_stage, staged_scan
from repro_torch.models import attention as A
from repro_torch.models.blocks import mlp_sharded, moe_forward
from repro_torch.models.layers import apply_norm
from repro_torch.models.model import _lm_head, layer_params
from repro_torch.runtime import sharding as S

from .adapter_pool import LORA_FACTORS
from .kv_cache import BlockPagedKVCache
from .sampling import sample, to_kv

ATTN_IMPLS = ("gather", "paged")

#: (block ids, in-block offsets, keep mask or None) of one step's KV writes
KVWrite = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]
#: (slot rows, query rows) of the live entries of a multi-query pass
KVRows = Tuple[torch.Tensor, torch.Tensor]


def _check_pp(cfg: ArchConfig, pp: int) -> None:
    if pp > 1 and cfg.n_layers % pp:
        raise ValueError(
            f"pipeline-parallel engine splits the layer scan into stages: "
            f"pp={pp} must divide n_layers={cfg.n_layers} of arch "
            f"{cfg.name!r}")


def _check_impl_and_plan(cfg: ArchConfig, mesh,
                         policy: S.ShardingPolicy, attn_impl: str):
    """Shared admission check for every step factory.

    Validates ``attn_impl`` against the engine's vocabulary and the mesh
    plan against the arch (tp must divide both head counts, pp must
    divide the layer stack) and returns ``(tp, pp)``.  All three
    factories go through here so a bad plan fails identically no matter
    which entry point is built first.
    """
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                         f"got {attn_impl!r}")
    tp = S.tp_degree(mesh, policy)
    if tp > 1 and (cfg.n_kv_heads % tp or cfg.n_heads % tp):
        raise ValueError(
            f"tensor-parallel engine shards attention over KV heads: tp={tp}"
            f" must divide n_heads={cfg.n_heads} and "
            f"n_kv_heads={cfg.n_kv_heads} of arch {cfg.name!r}")
    pp = S.pp_degree(mesh, policy)
    _check_pp(cfg, pp)
    return tp, pp


def _plan(cfg: ArchConfig, cache: BlockPagedKVCache, mesh, policy,
          attn_impl: str):
    """Check the plan, install the mesh hint (as the reference's
    factories do) and return the config of the rank's layer bodies."""
    tp, pp = _check_impl_and_plan(cfg, mesh, policy, attn_impl)
    if (cache.tp, cache.pp) != (tp, pp):
        raise ValueError(f"the cache is laid out for tp={cache.tp} x "
                         f"pp={cache.pp}, the mesh is tp={tp} x pp={pp}")
    act_sharding.set_mesh(mesh, policy.dp_axes, policy.tp_axis)
    return S.local_config(cfg, tp)


def _write_kv(cache: torch.Tensor, dst: KVWrite, new: torch.Tensor) -> None:
    """Store ``new`` (n, Hk, hd) at ``cache[blk, off]`` in place; rows
    whose keep flag is False write the entry's current value back."""
    blk, off, keep = dst
    new = to_kv(new, cache.dtype)
    if keep is not None:
        new = torch.where(keep[:, None, None], new, cache[blk, off])
    cache[blk, off] = new


# ---------------------------------------------------------------------------
# multi-tenant LoRA: per-slot grouped low-rank deltas
# ---------------------------------------------------------------------------

def _lora_layers(state, idx: Optional[torch.Tensor], attn_impl: str,
                 n_layers: int) -> List[Tuple]:
    """Per layer, the ``(lora, lora_idx, lora_fns)`` arguments of a layer
    body for one dispatch: that layer's adapter factors, the per-row pool
    slots ``idx`` and the delta functions ``(qkv, one)``: ``qkv(x, (A_q,
    B_q), (A_k, B_k), (A_v, B_v), idx)`` gives the q/k/v deltas, ``one(x,
    A, B, idx)`` the output projection's; all None without an adapter
    pool.

    ``paged`` hands the pool slices ``(P, k, R)`` to the CUDA kernel, which
    reads ``idx`` itself, and q, k and v share one launch; ``gather``
    gathers each slot's factors out of the pool once per dispatch, holes
    (idx < 0) zeroed, so each delta is two plain products (the
    reference's ``_pregather_lora``)."""
    if "adapter_slots" not in state:
        return [(None, None, None)] * n_layers
    if attn_impl == "paged":
        xs = {n: state["lora_" + n] for n in LORA_FACTORS}
        fns = (lora_ops.grouped_lora_qkv, lora_ops.grouped_lora)
    else:
        xs = {n: pregather(state["lora_" + n], idx) for n in LORA_FACTORS}
        fns = (_pregathered_qkv, grouped_lora_pregathered)
    group = act_sharding.tp_group()
    if group is not None:
        # each rank holds R/tp lanes of the pool: partial deltas, summed
        fns = lora_ops.make_sharded_grouped_lora(group, qkv=fns[0],
                                                 one=fns[1])
    return [({n: v[li] for n, v in xs.items()}, idx, fns)
            for li in range(n_layers)]


def _pregathered_qkv(x, q, k, v, idx):
    return tuple(grouped_lora_pregathered(x, A_, B_, idx)
                 for A_, B_ in (q, k, v))


def _qkv_deltas(cfg: ArchConfig, h, lora, lora_idx, lora_fns):
    """Grouped low-rank q/k/v deltas of the normed input, shaped for
    ``_project_qkv(deltas=...)`` (pre-RoPE, pre-GQA-reshape).  ``cfg`` is
    the rank's (its heads); under tensor parallelism the summed deltas
    are whole and the rank keeps its heads' columns."""
    b, s, _ = h.shape
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = h.contiguous()
    pairs = [(lora["A_" + n], lora["B_" + n]) for n in "qkv"]
    dq, dk, dv = lora_fns[0](h, *pairs, lora_idx)
    r = act_sharding.tp_rank()
    dq = dq.narrow(-1, r * H * hd, H * hd)
    dk = dk.narrow(-1, r * Hk * hd, Hk * hd)
    dv = dv.narrow(-1, r * Hk * hd, Hk * hd)
    return (dq.reshape(b, s, H, hd), dk.reshape(b, s, Hk, hd),
            dv.reshape(b, s, Hk, hd))


def _attn_out(cfg: ArchConfig, p, out, lora, lora_idx, lora_fns):
    """Output projection of the flat attention output plus its LoRA
    delta (when the dispatch has adapters).  Under tensor parallelism
    ``out`` holds the rank's heads and o_proj is row-parallel: the rank's
    partial product and its partial LoRA delta (over its rank lanes, of
    the gathered whole ``out``) are summed in one ``all_reduce``."""
    y = A.out_proj(cfg, p["attn"], out)
    if lora is not None:
        x_o = act_sharding.tp_all_gather(out.contiguous())
        y = y + lora_fns[1](x_o, lora["A_o"], lora["B_o"], lora_idx)
    return act_sharding.tp_all_reduce(y)


def _channel_mix(cfg: ArchConfig, p, x):
    """The layer's MLP on the pass's rows.  An MoE layer routes x as the
    reference's does, per row of the call: capacity counts each row's own
    tokens, padding rows of a prefill chunk included, and the aux loss is
    dropped.  Under tensor parallelism down_proj is row-parallel and its
    partial is summed in one ``all_reduce`` (the MoE layer sums its own,
    expert-parallel)."""
    if "mlp" not in p:
        return x
    h = apply_norm(cfg.norm_kind, x, p["ln2"])
    if cfg.family == "moe":
        y, _ = moe_forward(cfg, p["mlp"], h)
    else:
        y = mlp_sharded(cfg, p["mlp"], h)
    return x + y


# ---------------------------------------------------------------------------
# per-layer bodies against one block table / all block tables
# ---------------------------------------------------------------------------

def _prefill_layer(cfg: ArchConfig, p, x, ck, cv, bt_slot, pos_q,
                   dst: KVWrite, start: int, valid: int,
                   attn_impl: str = "gather", lora=None, lora_idx=None,
                   lora_fns=None):
    """One layer of a single-slot prompt chunk.

    x: (1, C, d); ck/cv: (N, bs, Hk, hd) this layer's block pool (written
    in place); bt_slot: (max_bps,) the slot's table; pos_q: (C,) absolute
    positions of the chunk; ``dst`` the targets of its first ``valid``
    rows, the live ones (padding rows are neither written nor used).
    ``lora`` (this layer's factors), ``lora_idx`` ((1,) the slot's pool
    slot, -1 = base model) and ``lora_fns`` add grouped low-rank deltas.
    """
    bs = ck.shape[1]
    L_virt = bt_slot.shape[0] * bs
    b, s = x.shape[0], x.shape[1]
    h = apply_norm(cfg.norm_kind, x, p["ln1"])
    deltas = (None if lora is None
              else _qkv_deltas(cfg, h, lora, lora_idx, lora_fns))
    q, k_new, v_new = A._project_qkv(cfg, p["attn"], h, pos_q[None, :],
                                     deltas)
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
    y = _attn_out(cfg, p, out, lora, lora_idx, lora_fns)
    return _channel_mix(cfg, p, x + y)


def _decode_layer(cfg: ArchConfig, p, x, ck, cv, bt, pos, live,
                  dst: KVWrite, attn_impl: str = "gather", lora=None,
                  lora_idx=None, lora_fns=None):
    """One layer of a one-token step for ALL slots.

    x: (S, 1, d); ck/cv: (N, bs, Hk, hd); bt: (S, max_bps) block tables;
    pos: (S,) per-slot cursors; ``live`` (n,) the slots whose K/V this
    step writes, at ``dst``; ``lora_idx`` (S,) per-slot pool slots.
    """
    bs = ck.shape[1]
    S_, max_bps = bt.shape
    L_virt = max_bps * bs
    h = apply_norm(cfg.norm_kind, x, p["ln1"])
    deltas = (None if lora is None
              else _qkv_deltas(cfg, h, lora, lora_idx, lora_fns))
    q, k_new, v_new = A._project_qkv(cfg, p["attn"], h, pos[:, None], deltas)
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
    y = _attn_out(cfg, p, out, lora, lora_idx, lora_fns)
    return _channel_mix(cfg, p, x + y)


def _verify_layer(cfg: ArchConfig, p, x, ck, cv, bt, pos, rows: KVRows,
                  dst: KVWrite, attn_impl: str = "gather", lora=None,
                  lora_idx=None, lora_fns=None):
    """One layer of a multi-query pass: Q queries per slot.

    x: (S, Q, d) — slot ``s``'s queries sit at absolute positions
    ``pos[s] .. pos[s]+Q-1`` (its pending token plus k drafts, or one
    chunk of a bucketed admission); ck/cv: (N, bs, Hk, hd); bt: (S,
    max_bps); pos: (S,) cursors; ``rows`` the live ``(slot, query)``
    pairs, whose K/V are written at ``dst`` before attention, so query
    ``i`` attends the candidates ``<= i`` like a prefill chunk attends
    its own tokens.  Padding queries neither write nor matter downstream;
    rejected candidates stay past the rolled-back cursor, unreachable
    under the causal mask and overwritten by the next step.
    """
    bs = ck.shape[1]
    S_, max_bps = bt.shape
    Q = x.shape[1]
    L_virt = max_bps * bs
    h = apply_norm(cfg.norm_kind, x, p["ln1"])
    pos_q = pos[:, None] + torch.arange(Q, dtype=pos.dtype,
                                        device=x.device)[None, :]  # (S, Q)
    deltas = (None if lora is None
              else _qkv_deltas(cfg, h, lora, lora_idx, lora_fns))
    q, k_new, v_new = A._project_qkv(cfg, p["attn"], h, pos_q, deltas)
    _write_kv(ck, dst, k_new[rows])
    _write_kv(cv, dst, v_new[rows])
    if attn_impl == "paged":
        # one batched multi-query flash pass through every slot's table
        out = paged_ops.paged_verify(q, ck, cv, bt, pos).reshape(S_, Q, -1)
    else:
        page_k = ck[bt].reshape(S_, L_virt, *ck.shape[2:])
        page_v = cv[bt].reshape(S_, L_virt, *cv.shape[2:])
        k_pos = torch.arange(L_virt, device=x.device)
        # per-slot, per-query causal mask over the virtual sequence
        mask = (k_pos[None, None, :] <= pos_q[:, :, None])[:, None, None]
        out = A._gqa_scores_softmax_out(q, page_k.to(x.dtype),
                                        page_v.to(x.dtype), mask,
                                        cfg.head_dim ** -0.5)
    y = _attn_out(cfg, p, out, lora, lora_idx, lora_fns)
    return _channel_mix(cfg, p, x + y)


def _multi_query_pass(cfg: ArchConfig, params, state, x, bt, pos,
                      live: np.ndarray, attn_impl: str, lora_idx, mesh):
    """The layer stack of a verify / bucketed-prefill pass.

    x: (S, Q, d); bt, pos: the tables and cursors of its S rows; ``live``
    (S, Q) host mask of the queries that write K/V.  Their targets are
    fixed for the pass: ``bt[s, (pos[s]+i) // bs]`` at ``(pos[s]+i) % bs``,
    which the scheduler's block accounting keeps inside the table.
    Returns the normed output on the last pipeline stage."""
    dev = x.device
    bs = state["cache_k"].shape[2]
    s_idx, i_idx = np.nonzero(live)
    rows = (torch.as_tensor(s_idx, dtype=torch.long, device=dev),
            torch.as_tensor(i_idx, dtype=torch.long, device=dev))
    wpos = pos[rows[0]].long() + rows[1]
    dst = (bt[rows[0], wpos // bs].long(), wpos % bs, None)
    layers = layer_params(params)
    loras = _lora_layers(state, lora_idx, attn_impl, len(layers))
    ck_all, cv_all = state["cache_k"], state["cache_v"]

    def body(li, x):
        return _verify_layer(cfg, layers[li], x, ck_all[li], cv_all[li], bt,
                             pos, rows, dst, attn_impl, *loras[li])
    x = staged_scan(mesh, x, body, len(layers))
    return apply_norm(cfg.norm_kind, x, params["ln_f"])


# ---------------------------------------------------------------------------
# engine entry points
# ---------------------------------------------------------------------------

def make_engine_fns(cfg: ArchConfig, cache: BlockPagedKVCache, *,
                    chunk_size: int, decode_block: int,
                    temperature: float = 0.0, eos_id: Optional[int] = None,
                    attn_impl: str = "gather", mesh=None,
                    policy: S.ShardingPolicy = S.ShardingPolicy()):
    """Returns ``(prefill_fn, decode_fn)``.

    prefill_fn(params, state, tokens (1,C), slot, start, valid)
        -> (logits (V,), state);  slot/start/valid are host integers
    decode_fn(params, state, active (S,), remaining (S,), generator)
        -> (tokens (n,S), produced (n,S), active (S,), state);  ``active``
        and ``remaining`` are host (numpy) arrays, the outputs stay on
        the device

    On a ``mesh`` (``repro_torch.launch.mesh``), ``params`` and ``state``
    are this rank's shards, and every rank gets the same logits and
    tokens.
    """
    lcfg = _plan(cfg, cache, mesh, policy, attn_impl)
    bs = cache.block_size

    def prefill(params, state, tokens, slot: int, start: int, valid: int):
        dev = state["pos"].device
        x = params["embed"][tokens]                              # (1, C, d)
        pos_q = start + torch.arange(chunk_size, dtype=torch.int32,
                                     device=dev)
        bt_slot = state["block_tables"][slot]                   # (max_bps,)
        wpos = pos_q[:valid].long()
        dst = (bt_slot[wpos // bs].long(), wpos % bs, None)
        layers = layer_params(params)
        lora_idx = (state["adapter_slots"][slot:slot + 1]
                    if "adapter_slots" in state else None)
        loras = _lora_layers(state, lora_idx, attn_impl, len(layers))
        ck_all, cv_all = state["cache_k"], state["cache_v"]

        def body(li, x):
            return _prefill_layer(lcfg, layers[li], x, ck_all[li],
                                  cv_all[li], bt_slot, pos_q, dst, start,
                                  valid, attn_impl, *loras[li])
        x = staged_scan(mesh, x, body, len(layers))
        logits = from_last_stage(
            mesh, lambda: _lm_head(cfg, params, apply_norm(
                cfg.norm_kind, x, params["ln_f"])[:, valid - 1:valid])[0, 0],
            (cfg.vocab_size,), x.dtype, dev)                     # (V,)
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
        loras = _lora_layers(state, state.get("adapter_slots"), attn_impl,
                             len(layers))
        ck_all, cv_all = state["cache_k"], state["cache_v"]
        toks, prods = [], []
        for _ in range(decode_block):
            x = params["embed"][tok][:, None]                    # (S, 1, d)
            wpos = torch.minimum(pos[live], cap).long()
            dst = (bt_live[rows, wpos // bs], wpos % bs, act[live])

            def body(li, x):
                return _decode_layer(lcfg, layers[li], x, ck_all[li],
                                     cv_all[li], bt, pos, live, dst,
                                     attn_impl, *loras[li])
            x = staged_scan(mesh, x, body, len(layers))

            def sample_next():
                h = apply_norm(cfg.norm_kind, x, params["ln_f"])
                logits = _lm_head(cfg, params, h[:, -1:])[:, 0]  # (S, V)
                return sample(logits, temperature, generator).to(torch.int32)
            nxt = from_last_stage(mesh, sample_next, tok.shape,
                                   torch.int32, dev)
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


def make_verify_fn(cfg: ArchConfig, cache: BlockPagedKVCache, *,
                   attn_impl: str = "gather", mesh=None,
                   policy: S.ShardingPolicy = S.ShardingPolicy()):
    """Speculative-verify entry point.

    verify_fn(params, state, qtoks (S, k+1), active (S,), valid_q (S,))
        -> (logits (S, k+1, V), state);  the three inputs are host (numpy)
        arrays

    ``qtoks[s]`` is slot ``s``'s pending token followed by its k draft
    proposals; their K/V land at absolute positions ``pos[s]..pos[s]+k``
    and every query's next-token logits come back so the scheduler can
    accept a prefix.  The KV cursor is NOT advanced here: acceptance
    decides the advance.  Only the live queries of active slots
    (``i < valid_q[s]``, budget-capped) write K/V.
    """
    lcfg = _plan(cfg, cache, mesh, policy, attn_impl)

    def verify(params, state, qtoks, active, valid_q):
        dev = state["pos"].device
        qtoks = np.asarray(qtoks)
        S_, Q = qtoks.shape
        x = params["embed"][torch.as_tensor(qtoks, dtype=torch.long,
                                            device=dev)]      # (S, Q, d)
        live = (np.asarray(active, bool)[:, None]
                & (np.arange(Q)[None, :] < np.asarray(valid_q)[:, None]))
        x = _multi_query_pass(lcfg, params, state, x, state["block_tables"],
                              state["pos"], live, attn_impl,
                              state.get("adapter_slots"), mesh)
        logits = from_last_stage(mesh, lambda: _lm_head(cfg, params, x),
                                  (S_, Q, cfg.vocab_size), x.dtype, dev)
        return logits, state                                  # (S, Q, V)

    return verify


def make_prefill_batch_fn(cfg: ArchConfig, cache: BlockPagedKVCache, *,
                          attn_impl: str = "gather", mesh=None,
                          policy: S.ShardingPolicy = S.ShardingPolicy()):
    """Bucketed batched prefill-and-insert (traffic admission).

    prefill_batch_fn(params, state, qtoks (B, C), slots (B,), valids (B,))
        -> (logits (B, V), state);  the three inputs are host (numpy)
        arrays

    Member ``i``'s chunk lands in slot ``slots[i]`` at absolute positions
    ``pos[slots[i]] .. pos[slots[i]] + valids[i] - 1``, and the cursor
    advances by ``valids[i]``.  A member with ``valids[i] == 0`` is
    padding (groups are padded to B with duplicates of a real slot id):
    it writes no K/V, its cursor does not move (the advance is an
    ``index_add_``, so a duplicate's +0 cannot overwrite the real member's
    advance), and its logits row is garbage the scheduler ignores.  The
    layer body is the verify pass over the group's tables and cursors;
    each member's first-token logits are read at its last valid position.
    """
    lcfg = _plan(cfg, cache, mesh, policy, attn_impl)

    def prefill_batch(params, state, qtoks, slots, valids):
        dev = state["pos"].device
        qtoks, valids = np.asarray(qtoks), np.asarray(valids)
        B, C = qtoks.shape
        slots_t = torch.as_tensor(np.asarray(slots), dtype=torch.long,
                                  device=dev)
        x = params["embed"][torch.as_tensor(qtoks, dtype=torch.long,
                                            device=dev)]      # (B, C, d)
        bt = state["block_tables"][slots_t]                   # (B, max_bps)
        pos = state["pos"][slots_t]                           # (B,)
        live = np.arange(C)[None, :] < valids[:, None]
        lora_idx = (state["adapter_slots"][slots_t]
                    if "adapter_slots" in state else None)
        x = _multi_query_pass(lcfg, params, state, x, bt, pos, live,
                              attn_impl, lora_idx, mesh)
        last = torch.as_tensor(np.clip(valids - 1, 0, C - 1),
                               dtype=torch.long, device=dev)
        logits = from_last_stage(
            mesh, lambda: _lm_head(cfg, params, x[torch.arange(
                B, device=dev), last][:, None])[:, 0],          # (B, V)
            (B, cfg.vocab_size), x.dtype, dev)
        adv = torch.as_tensor(np.maximum(valids, 0).astype(np.int32),
                              device=dev)
        state["pos"].index_add_(0, slots_t, adv)
        return logits, state

    return prefill_batch
