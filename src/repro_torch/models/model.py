"""Dense decoder assembly: uncached ``forward`` and the LM head (the
PyTorch counterparts of the JAX package's ``models/model.py``).

The layer stack is stored stacked on a leading ``(L, ...)`` axis as in the
reference; where the reference scans over it, the port loops over
:func:`layer_params` views (no copies).  Per-layer remat is
``torch.utils.checkpoint`` around each layer (the reference's
``jax.checkpoint`` with policy ``"full"``: nothing but the layer's input
is saved, and the backward recomputes the layer).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from . import attention as A
from .blocks import mlp_forward
from .layers import apply_norm, init_params

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
               use_flash: bool = False) -> torch.Tensor:
    h = apply_norm(cfg.norm_kind, x, p["ln1"])
    x = x + A.self_attention(cfg, p["attn"], h, causal=True,
                             window=cfg.local_window or None,
                             use_flash=use_flash)
    h = apply_norm(cfg.norm_kind, x, p["ln2"])
    return x + mlp_forward(cfg, p["mlp"], h)


def _run_stack(cfg: ArchConfig, params: Dict, x: torch.Tensor, *,
               use_flash: bool, remat: bool) -> torch.Tensor:
    """Iterate the stacked decoder layers, each under checkpoint if
    ``remat``."""
    for p in layer_params(params):
        if remat:
            x = checkpoint(_seq_block, cfg, p, x, use_flash=use_flash,
                           use_reentrant=False)
        else:
            x = _seq_block(cfg, p, x, use_flash=use_flash)
    return x


def forward(cfg: ArchConfig, params: Dict, token_ids: torch.Tensor, *,
            use_flash: bool = False, remat: bool = False,
            remat_policy: str = "full"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (b, s, V), aux loss) — aux is 0 for dense stacks.

    ``use_flash`` runs attention through the flash attention kernels;
    ``remat`` recomputes each layer in the backward (policy ``"full"``)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    if remat_policy != "full":
        raise NotImplementedError(
            f"remat policy {remat_policy!r} (saving matmul outputs) serves "
            f"the dry-run cells, not ported yet (ROADMAP queue 1, item 16)")
    x = params["embed"][token_ids]
    x = _run_stack(cfg, params, x, use_flash=use_flash, remat=remat)
    x = apply_norm(cfg.norm_kind, x, params["ln_f"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _lm_head(cfg, params, x), aux
