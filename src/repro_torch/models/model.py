"""Decoder assembly (dense, MoE and VLM stacks): uncached ``forward``
and the LM head (the PyTorch counterparts of the JAX package's
``models/model.py``).

The layer stack is stored stacked on a leading ``(L, ...)`` axis as in the
reference; where the reference scans over it, the port loops over
:func:`layer_params` views (no copies).  Per-layer remat is
``torch.utils.checkpoint`` around each layer (the reference's
``jax.checkpoint`` with policy ``"full"``: nothing but the layer's input
is saved, and the backward recomputes the layer).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from . import attention as A
from .blocks import mlp_forward, moe_forward
from .layers import FAMILIES, apply_norm, init_params

__all__ = ["forward", "init_params", "layer_params", "_lm_head"]


def _take(tree: Dict, i: int) -> Dict:
    return {k: (_take(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def layer_params(params: Dict) -> List[Dict]:
    """Per-layer views ``[params["layers"][...][i] for i in range(L)]``."""
    n = params["layers"]["ln1"]["gamma"].shape[0]
    return [_take(params["layers"], i) for i in range(n)]


def _lm_head(cfg: ArchConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].t()
    return x @ params["lm_head"]


def _seq_block(cfg: ArchConfig, p: Dict, x: torch.Tensor, *,
               use_flash: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer: attention, then the channel mixer (if the layer has
    one).  Returns (x, the layer's MoE aux loss; 0 for a dense MLP)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(cfg.norm_kind, x, p["ln1"])
    x = x + A.self_attention(cfg, p["attn"], h, causal=True,
                             window=cfg.local_window or None,
                             use_flash=use_flash)
    if "mlp" in p:
        h = apply_norm(cfg.norm_kind, x, p["ln2"])
        if cfg.family == "moe":
            y, aux = moe_forward(cfg, p["mlp"], h)
        else:
            y = mlp_forward(cfg, p["mlp"], h)
        x = x + y
    return x, aux


def _run_stack(cfg: ArchConfig, params: Dict, x: torch.Tensor, *,
               use_flash: bool, remat: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterate the stacked decoder layers, each under checkpoint if
    ``remat``; the layers' aux losses are summed."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in layer_params(params):
        if remat:
            x, aux = checkpoint(_seq_block, cfg, p, x, use_flash=use_flash,
                                use_reentrant=False)
        else:
            x, aux = _seq_block(cfg, p, x, use_flash=use_flash)
        aux_total = aux_total + aux
    return x, aux_total


def forward(cfg: ArchConfig, params: Dict, token_ids: torch.Tensor, *,
            vision_embeds: Optional[torch.Tensor] = None,
            use_flash: bool = False, remat: bool = False,
            remat_policy: str = "full"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (b, s, V), aux loss): the MoE layers' load-balance
    losses summed, 0 for dense stacks.

    A VLM's ``vision_embeds`` (b, P, d) go through ``vision_proj`` and are
    prepended to the text embeddings, so the logits cover P + s
    positions.  ``use_flash`` runs attention through the flash attention
    kernels; ``remat`` recomputes each layer in the backward (policy
    ``"full"``)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported (ROADMAP.md queue 1 "
            f"item 4)")
    if remat_policy != "full":
        raise NotImplementedError(
            f"remat policy {remat_policy!r} (saving matmul outputs) serves "
            f"the dry-run cells, not ported yet (ROADMAP.md queue 1, item 6)")
    x = params["embed"][token_ids]
    if cfg.family == "vlm" and vision_embeds is not None:
        # the reference's dense() promotes mixed dtypes (bf16 embeddings
        # against f32 weights compute in f32)
        w = params["vision_proj"]
        dt = torch.promote_types(vision_embeds.dtype, w.dtype)
        vp = vision_embeds.to(dt) @ w.to(dt)
        x = torch.cat([vp.to(x.dtype), x], dim=1)
    x, aux = _run_stack(cfg, params, x, use_flash=use_flash, remat=remat)
    x = apply_norm(cfg.norm_kind, x, params["ln_f"])
    return _lm_head(cfg, params, x), aux
