"""Model assembly for every family of the reference (dense, VLM, MoE,
SSM, hybrid RG-LRU / local attention, encoder-decoder; MLA attention
where the config has it): the uncached ``forward``, the cached lockstep
``step`` with its decode state, and the LM head (the PyTorch
counterparts of the JAX package's ``models/model.py``).

Homogeneous stacks are stored stacked on a leading ``(L, ...)`` axis as
in the reference; where the reference scans over it, the port loops over
:func:`layer_params` views (no copies).  Hybrid and encoder-decoder
stacks are unrolled as ``layers["l{i}"]``.  Per-layer remat is
``torch.utils.checkpoint`` around each layer (the reference's
``jax.checkpoint``): policy ``"full"`` saves nothing but the layer's
input and the backward recomputes the layer; ``"dots"`` and
``"dots_no_batch"`` also save the matmuls' outputs (selective
checkpointing, :data:`REMAT_POLICIES`).

Under a mesh hint (``models.act_sharding``, installed by
``runtime.serve.make_serve_fns`` and by ``runtime.train``'s step)
:func:`step` and :func:`forward` run a rank's shard
(``runtime.sharding``): the layer bodies on its heads, ``mlp`` columns
and ``inner`` channels (``attention``, ``blocks``), and under a pipe
axis (serving only) only its stage's layers, decoder and encoder alike,
through ``act_sharding.staged_scan``; the last stage's logits, and a
staged encoder's output, are broadcast back to every stage.  Under FSDP
:func:`forward` gathers each layer's leaves cut over the data axis
inside the function a layer's remat checkpoints, so the backward frees
the whole weights and gathers them again, as XLA does; the embedding,
the final norm, the LM head and a VLM's ``vision_proj`` are gathered
once, outside the stack (a tied embedding thereby serves both of its
uses from one gather).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint, noop_context_fn

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from . import act_sharding
from . import attention as A
from . import blocks as B
from .act_sharding import from_last_stage, staged_scan
from .layers import apply_norm, init_params, param_defs

__all__ = ["REMAT_POLICIES", "abstract_decode_state", "abstract_params",
           "decode_state_shapes", "forward", "init_decode_state",
           "init_params", "layer_params", "step", "vocab_held", "_lm_head"]


def _take(tree: Dict, i: int) -> Dict:
    return {k: (_take(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def abstract_params(cfg: ArchConfig,
                    dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The tree of :func:`init_params` on the meta device: every leaf's
    shape and dtype, no data (the dry-run's stand-ins)."""
    def walk(defs):
        return {k: (walk(d) if isinstance(d, dict) else torch.empty(
            d.shape, dtype=d.dtype or dtype, device="meta"))
            for k, d in defs.items()}
    return walk(param_defs(cfg))


def layer_params(params: Dict) -> List[Dict]:
    """Per-layer parameter dicts: views ``[...][i]`` of a stacked tree,
    or the ``layers["l{i}"]`` of an unrolled one in the order of ``i``
    (a pipeline stage holds its own ``l{i}`` only)."""
    layers = params["layers"]
    if "ln1" not in layers:
        return [layers[k] for k in sorted(layers, key=lambda k: int(k[1:]))]
    n = layers["ln1"]["gamma"].shape[0]
    return [_take(layers, i) for i in range(n)]


def vocab_held(cfg: ArchConfig, params: Dict) -> int:
    """The width of this rank's logits: ``cfg.vocab_size``, or its tp
    rank's block of it when the vocabulary is cut
    (``runtime.sharding``)."""
    if cfg.tie_embeddings:
        return params["embed"].shape[0]
    return params["lm_head"].shape[1]


def _lm_head(cfg: ArchConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """This rank's logits: over its block of the vocabulary when the
    head is cut (a column-parallel product, *f* at its input)."""
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    if w.shape[1] < cfg.vocab_size:
        x = act_sharding.tp_copy(x)
    return x @ w


def _embed(cfg: ArchConfig, params: Dict, token_ids: torch.Tensor,
           vision_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings; a VLM's ``vision_embeds`` (b, P, d) go through
    ``vision_proj`` and are prepended."""
    x = act_sharding.vocab_embed(params["embed"], token_ids, cfg.vocab_size)
    if cfg.family == "vlm" and vision_embeds is not None:
        # the reference's dense() promotes mixed dtypes (bf16 embeddings
        # against f32 weights compute in f32)
        w = params["vision_proj"]
        dt = torch.promote_types(vision_embeds.dtype, w.dtype)
        vp = vision_embeds.to(dt) @ w.to(dt)
        x = torch.cat([vp.to(x.dtype), x], dim=1)
    return x


def _channel_mix(cfg: ArchConfig, p: Dict, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's MLP (dense or MoE) with its residual, if it has one;
    returns (x, the MoE aux loss; 0 otherwise)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "mlp" in p:
        h = apply_norm(cfg.norm_kind, x, p["ln2"])
        if cfg.family == "moe":
            y, aux = B.moe_forward(cfg, p["mlp"], h)
        else:
            y = B.mlp_sharded(cfg, p["mlp"], h)
        x = x + y
    return x, aux


def _seq_block(cfg: ArchConfig, kind: str, p: Dict, x: torch.Tensor, *,
               use_flash: bool = False, enc_kv=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer over the whole sequence: its temporal mixer (attention,
    MLA, Mamba or RG-LRU; cross-attention after self-attention when
    ``enc_kv`` is given), then the channel mixer.  Returns (x, the layer's
    MoE aux loss; 0 otherwise)."""
    h = apply_norm(cfg.norm_kind, x, p["ln1"])
    if kind == "attn":
        if cfg.mla is not None:
            y = A.mla_self_attention(cfg, p["attn"], h)
        else:
            y = A.self_attention(cfg, p["attn"], h, causal=True,
                                 window=cfg.local_window or None,
                                 use_flash=use_flash)
        x = x + y
        if cfg.n_encoder_layers and enc_kv is not None:
            hx = apply_norm(cfg.norm_kind, x, p["ln_x"])
            x = x + A.cross_attention(cfg, p["xattn"], hx, *enc_kv)
    elif kind == "ssm":
        x = x + B.mamba_forward(cfg, p["ssm"], h)
    elif kind == "rglru":
        x = x + B.rglru_forward(cfg, p["rglru"], h)
    return _channel_mix(cfg, p, x)


def _layer_dims(dims: Optional[Dict], n: int) -> List[Optional[Dict]]:
    """Per-layer trees of FSDP's cut dims (``act_sharding.fsdp_dims``'
    ``layers`` subtree, whole-leaf dims): a stacked leaf's dims shift by
    its layer axis; None for every layer without FSDP."""
    if dims is None:
        return [None] * n
    if "ln1" not in dims:
        return [dims[k] for k in sorted(dims, key=lambda k: int(k[1:]))]

    def shift(t):
        return {k: (shift(v) if isinstance(v, dict) else
                    None if v is None else v - 1) for k, v in t.items()}
    return [shift(dims)] * n


def _layer(cfg: ArchConfig, kind: str, p: Dict, x: torch.Tensor,
           dims: Optional[Dict], enc_out: Optional[torch.Tensor],
           use_flash: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer from its (possibly FSDP-cut) leaves: gathered
    whole, an encoder-decoder's cross K/V projected from ``enc_out``,
    then :func:`_seq_block`.  The unit a layer's remat recomputes."""
    p = act_sharding.fsdp_gather_tree(p, dims)
    enc_kv = (None if enc_out is None
              else A.encode_cross_kv(cfg, p["xattn"], enc_out))
    return _seq_block(cfg, kind, p, x, use_flash=use_flash, enc_kv=enc_kv)


#: remat policy names -> the aten ops whose outputs a layer's remat
#: saves (the reference's ``jax.checkpoint`` policies: "full" saves
#: nothing; "dots" every matmul's output, ``checkpoint_dots``;
#: "dots_no_batch" those without a batch dim,
#: ``dots_with_no_batch_dims_saveable``)
REMAT_POLICIES = {
    "full": (),
    "dots": ("mm", "addmm", "bmm"),
    "dots_no_batch": ("mm", "addmm"),
}


def _remat_context(remat_policy: str):
    """``checkpoint``'s ``context_fn`` for a policy that saves ops'
    outputs (selective activation checkpointing); the default,
    ``noop_context_fn``, for "full"."""
    names = REMAT_POLICIES[remat_policy]
    if not names:
        return noop_context_fn
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    saved = {getattr(torch.ops.aten, n).default for n in names}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, policy)


def _run_stack(cfg: ArchConfig, params: Dict, x: torch.Tensor, *,
               use_flash: bool, remat: bool, enc_out=None,
               remat_policy: str = "full"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterate the decoder layers, each under checkpoint if ``remat``
    (saving what ``remat_policy`` names); the layers' aux losses are
    summed.  With ``enc_out`` (an encoder-decoder) each layer first
    projects its cross K/V from it."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = layer_params(params)
    dims = act_sharding.fsdp_dims()
    dims = _layer_dims(None if dims is None else dims["layers"], len(layers))
    ctx = _remat_context(remat_policy) if remat else None
    for kind, p, dm in zip(cfg.block_kinds(), layers, dims):
        if remat:
            x, aux = checkpoint(_layer, cfg, kind, p, x, dm, enc_out,
                                use_flash, use_reentrant=False,
                                context_fn=ctx)
        else:
            x, aux = _layer(cfg, kind, p, x, dm, enc_out, use_flash)
        aux_total = aux_total + aux
    return x, aux_total


def _encoder_block(cfg: ArchConfig, p: Dict, h: torch.Tensor,
                   dims: Optional[Dict] = None) -> torch.Tensor:
    p = act_sharding.fsdp_gather_tree(p, dims)
    z = apply_norm(cfg.norm_kind, h, p["ln1"])
    h = h + A.self_attention(cfg, p["attn"], z, causal=False)
    z = apply_norm(cfg.norm_kind, h, p["ln2"])
    return h + B.mlp_sharded(cfg, p["mlp"], z)


def _encoder_forward(cfg: ArchConfig, params: Dict, frames: torch.Tensor,
                     remat: bool = False) -> torch.Tensor:
    """The Whisper-style encoder over precomputed frame embeddings
    (b, F, d): bidirectional self-attention layers, then its norm.  Under
    a pipe axis each stage runs its block of the stacked encoder layers
    and every stage gets the last stage's output."""
    mesh = act_sharding.current_mesh()
    enc = layer_params(params["encoder"])
    dims = act_sharding.fsdp_dims()
    dims = _layer_dims(None if dims is None else
                       dims["encoder"]["layers"], len(enc))

    def body(li, x):
        if remat:
            return checkpoint(_encoder_block, cfg, enc[li], x, dims[li],
                              use_reentrant=False)
        return _encoder_block(cfg, enc[li], x, dims[li])
    # a later stage receives its input in place: never into the caller's
    x = frames if mesh is None or mesh.stage == 0 else torch.empty_like(
        frames)
    x = staged_scan(mesh, x, body, len(enc))
    return from_last_stage(
        mesh, lambda: apply_norm(cfg.norm_kind, x, params["encoder"]["ln_f"]),
        x.shape, x.dtype, x.device)


def _gather_outside_stack(params: Dict) -> Dict:
    """Under FSDP, ``params`` with every leaf outside the layer stacks
    gathered whole (``embed``, ``ln_f``, ``lm_head``, ``vision_proj``,
    the encoder's ``ln_f``); the layers are gathered one by one in
    :func:`_layer` and :func:`_encoder_block`."""
    dims = act_sharding.fsdp_dims()
    if dims is None:
        return params
    out = dict(params)
    for k, v in params.items():
        if k == "encoder":
            out[k] = dict(v, ln_f=act_sharding.fsdp_gather_tree(
                v["ln_f"], dims[k]["ln_f"]))
        elif k != "layers":
            out[k] = (act_sharding.fsdp_gather_tree(v, dims[k])
                      if isinstance(v, dict)
                      else act_sharding.fsdp_gather(v, dims[k]))
    return out


def forward(cfg: ArchConfig, params: Dict, token_ids: torch.Tensor, *,
            vision_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            use_flash: bool = False, remat: bool = False,
            remat_policy: str = "full"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (b, s, V), aux loss): the MoE layers' load-balance
    losses summed, 0 for other stacks.  On a tp rank whose vocabulary is
    cut the logits are its block of V (:func:`vocab_held`).

    A VLM's ``vision_embeds`` (b, P, d) are prepended, so the logits
    cover P + s positions; an encoder-decoder needs its encoder
    ``frames`` (b, F, d).  ``use_flash`` runs the decoder's (non-MLA)
    self-attention through the flash attention kernels; ``remat``
    recomputes each decoder layer in the backward, saving what
    ``remat_policy`` names (:data:`REMAT_POLICIES`)."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat_policy!r}; known: "
                         f"{sorted(REMAT_POLICIES)}")
    params = _gather_outside_stack(params)
    x = _embed(cfg, params, token_ids, vision_embeds)
    enc_out = None
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError("an encoder-decoder forward needs encoder "
                             "frames")
        enc_out = _encoder_forward(cfg, params, frames, remat=remat)
        use_flash = False           # the reference's encdec stack is eager
    x, aux = _run_stack(cfg, params, x, use_flash=use_flash, remat=remat,
                        enc_out=enc_out, remat_policy=remat_policy)
    x = apply_norm(cfg.norm_kind, x, params["ln_f"])
    return _lm_head(cfg, params, x), aux


# ---------------------------------------------------------------------------
# decode state and the cached step (the lockstep server's model calls)
# ---------------------------------------------------------------------------

#: each layer kind's slices of the stacked decode state
_STATE_KEYS = {"attn": ("cache_k", "cache_v", "cache_pos"),
               "ssm": ("conv_state", "ssm_state"),
               "rglru": ("rg_conv", "rg_h")}


def decode_state_shapes(cfg: ArchConfig, batch: int, max_len: int,
                        kv_dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Key -> (whole shape, dtype) of the decode state's tensors (the
    reference's ``abstract_decode_state`` without ``pos``)."""
    kinds = cfg.block_kinds()
    out: Dict = {}
    n_attn, n_ssm, n_rg = (kinds.count(k) for k in ("attn", "ssm", "rglru"))
    if n_attn:
        kv_len = (min(max_len, cfg.local_window) if cfg.local_window
                  else max_len)
        ks, vs = A.kv_cache_shape(cfg, batch, kv_len)
        out["cache_k"] = ((n_attn,) + ks, kv_dtype)
        out["cache_v"] = ((n_attn,) + vs, kv_dtype)
        if cfg.local_window:
            out["cache_pos"] = ((n_attn, batch, kv_len), torch.int32)
    if n_ssm:
        cs, ss = B.mamba_state_shapes(cfg, batch)
        out["conv_state"] = ((n_ssm,) + cs, torch.bfloat16)
        out["ssm_state"] = ((n_ssm,) + ss, torch.float32)
    if n_rg:
        cs, hs = B.rglru_state_shapes(cfg, batch)
        out["rg_conv"] = ((n_rg,) + cs, torch.bfloat16)
        out["rg_h"] = ((n_rg,) + hs, torch.float32)
    if cfg.family == "encdec":
        shape = (cfg.n_layers, batch, cfg.encoder_len, cfg.n_heads,
                 cfg.head_dim)
        out["cross_k"] = (shape, kv_dtype)
        out["cross_v"] = (shape, kv_dtype)
    return out


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      kv_dtype: torch.dtype = torch.bfloat16, *,
                      device="cuda") -> Dict:
    """The reference's decode state, stacked per layer kind:
    ``cache_k``/``cache_v`` (MLA: the latent and the rotary key part; a
    local window: a ring of min(max_len, window) positions with
    ``cache_pos``, -1 where empty), Mamba's ``conv_state`` (bf16) and
    ``ssm_state`` (f32), RG-LRU's ``rg_conv`` (bf16) and ``rg_h`` (f32),
    an encoder-decoder's ``cross_k``/``cross_v``.  ``pos``, the tokens
    cached, is a host int (the reference's device scalar), so no step
    reads the device back to learn it.  A rank of a mesh builds its cut
    with ``runtime.sharding.init_state_shard``."""
    dev = resolve_device(device)
    state: Dict = {"pos": 0}
    for key, (shape, dt) in decode_state_shapes(cfg, batch, max_len,
                                                kv_dtype).items():
        state[key] = torch.full(shape, -1 if key == "cache_pos" else 0,
                                dtype=dt, device=dev)
    return state


def abstract_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                          kv_dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The tree of :func:`init_decode_state` on the meta device (``pos``
    the host int 0)."""
    state: Dict = {"pos": 0}
    for key, (shape, dt) in decode_state_shapes(cfg, batch, max_len,
                                                kv_dtype).items():
        state[key] = torch.empty(shape, dtype=dt, device="meta")
    return state


def _local_cached_attention(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                            cache_k, cache_v, cache_pos, pos: int
                            ) -> torch.Tensor:
    """Ring-buffer local attention (a W-position ring, masked by global
    position), the caches written in place.

    A chunk of s >= W tokens attends over itself only, through
    :func:`attention.lockstep_blockwise` with window W, and writes its
    last W tokens to the ring.  Its first W - 1 queries thereby miss the
    keys of an earlier chunk that lie inside their window: the
    reference's behaviour, kept."""
    b, s, _ = x.shape
    W = cache_k.shape[1]
    dev = x.device
    positions = pos + torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    q, k_new, v_new = A._project_qkv(cfg, p, x, positions)
    if s >= W:
        out = A.lockstep_blockwise(q, *A._rank_kv(cfg, p, k_new, v_new),
                                   window=W, q_offset=0)
        slots = (pos + torch.arange(s - W, s, device=dev)) % W
        cache_k[:, slots] = A.to_cache(k_new[:, -W:], cache_k.dtype)
        cache_v[:, slots] = A.to_cache(v_new[:, -W:], cache_v.dtype)
        cache_pos[:, slots] = positions[:, -W:].expand(b, W)
    else:
        slots = (pos + torch.arange(s, device=dev)) % W
        cache_k[:, slots] = A.to_cache(k_new, cache_k.dtype)
        cache_v[:, slots] = A.to_cache(v_new, cache_v.dtype)
        cache_pos[:, slots] = positions.expand(b, s)
        kp = cache_pos[:, None, None, None, :]               # (b,1,1,1,W)
        qp = positions[:, None, None, :, None]               # (1,1,1,s,1)
        mask = (kp >= 0) & (kp <= qp) & (kp > qp - W)
        k, v = A._rank_kv(cfg, p, cache_k.to(x.dtype), cache_v.to(x.dtype))
        out = A._gqa_scores_softmax_out(q, k, v, mask, cfg.head_dim ** -0.5)
    return A._sum_heads(cfg, p, A.out_proj(cfg, p, out))


def _cached_block(cfg: ArchConfig, kind: str, p: Dict, x: torch.Tensor,
                  pos: int, ls: Dict, cross_kv=None
                  ) -> Tuple[torch.Tensor, Dict]:
    """One layer against its slices ``ls`` of the decode state.  The
    attention caches are written in place; returns (x, the layer's new
    recurrent states by state key)."""
    new: Dict = {}
    h = apply_norm(cfg.norm_kind, x, p["ln1"])
    if kind == "attn":
        if cfg.mla is not None:
            y, _, _ = A.mla_cached_attention(cfg, p["attn"], h, ls["cache_k"],
                                             ls["cache_v"], pos)
        elif cfg.local_window:
            y = _local_cached_attention(cfg, p["attn"], h, ls["cache_k"],
                                        ls["cache_v"], ls["cache_pos"], pos)
        else:
            y, _, _ = A.cached_attention(cfg, p["attn"], h, ls["cache_k"],
                                         ls["cache_v"], pos)
        x = x + y
        if cross_kv is not None:
            hx = apply_norm(cfg.norm_kind, x, p["ln_x"])
            x = x + A.cross_attention(cfg, p["xattn"], hx, *cross_kv)
    elif kind == "ssm":
        y, new["conv_state"], new["ssm_state"] = B.mamba_step(
            cfg, p["ssm"], h, ls["conv_state"], ls["ssm_state"])
        return x + y, new
    elif kind == "rglru":
        y, new["rg_conv"], new["rg_h"] = B.rglru_step(
            cfg, p["rglru"], h, ls["rg_conv"], ls["rg_h"])
        x = x + y
    return _channel_mix(cfg, p, x)[0], new


def _store(state: Dict, key: str, i: int, value: torch.Tensor) -> None:
    """Layer i's new recurrent state into the stacked ``state[key]``.  An
    f32 tree promotes the bf16 conv states of ``init_decode_state`` to
    f32 in the first step; the reference then carries f32 states, and so
    does the port (the stack is recast, exactly, before the write)."""
    if state[key].dtype != value.dtype:
        state[key] = state[key].to(value.dtype)
    state[key][i].copy_(value)


def step(cfg: ArchConfig, params: Dict, token_ids: torch.Tensor,
         state: Dict, *, vision_embeds: Optional[torch.Tensor] = None,
         frames: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, Dict]:
    """Cached model step: a prefill chunk (s tokens) or a decode step
    (s = 1) against ``state`` from :func:`init_decode_state`.

    Returns (logits of the last position (b, V), state); on a tp rank
    whose vocabulary is cut, its block of V (:func:`vocab_held`).  The state is
    updated in place (the reference's server donates it) and returned.
    A VLM's ``vision_embeds`` are prepended and advance ``pos`` with the
    tokens; an encoder-decoder given ``frames`` encodes them and stores
    every layer's cross K/V (otherwise they stay as they are: zeros
    before any frames).

    Under a pipe axis a stage runs model layers ``lo .. hi - 1``
    (``act_sharding.stage_layers``) against its shard of the params and
    of each per-kind state stack, whose entries count from the stage's
    first layer of that kind; every stage returns the same logits."""
    mesh = act_sharding.current_mesh()
    pos = state["pos"]
    x = _embed(cfg, params, token_ids, vision_embeds)
    layers = layer_params(params)
    lo, _ = act_sharding.stage_layers(cfg.n_layers)
    kinds = cfg.block_kinds()[lo:lo + len(layers)]
    if cfg.family == "encdec" and frames is not None:
        enc_out = _encoder_forward(cfg, params, frames)
        for i, p in enumerate(layers):
            k, v = A.encode_cross_kv(cfg, p["xattn"], enc_out)
            state["cross_k"][i] = A.to_cache(k, state["cross_k"].dtype)
            state["cross_v"][i] = A.to_cache(v, state["cross_v"].dtype)
    seen = dict.fromkeys(_STATE_KEYS, 0)
    index = []                     # each layer's entry in its kind's stack
    for kind in kinds:
        index.append(seen[kind])
        seen[kind] += 1

    def body(i, x):
        kind, j = kinds[i], index[i]
        ls = {k: state[k][j] for k in _STATE_KEYS[kind] if k in state}
        cross = ((state["cross_k"][i], state["cross_v"][i])
                 if cfg.family == "encdec" else None)
        x, new = _cached_block(cfg, kind, layers[i], x, pos, ls,
                               cross_kv=cross)
        for k, v in new.items():
            _store(state, k, j, v)
        return x

    x = staged_scan(mesh, x, body, len(layers))
    state["pos"] = pos + token_ids.shape[1] + (
        vision_embeds.shape[1] if (cfg.family == "vlm"
                                   and vision_embeds is not None) else 0)
    head = lambda: _lm_head(cfg, params, apply_norm(
        cfg.norm_kind, x[:, -1:], params["ln_f"]))[:, 0]
    return from_last_stage(mesh, head, (x.shape[0], vocab_held(cfg, params)),
                           x.dtype, x.device), state
