"""Channel-mixing blocks: the dense MLP and the MoE layer (top-k routing,
capacity-bounded scatter dispatch, shared experts) — the PyTorch
counterparts of ``blocks.mlp_forward`` and ``blocks.moe_forward``."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from .layers import dense, gelu, silu


def mlp_forward(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.gated_mlp:
        return dense(silu(dense(x, p["gate"])) * dense(x, p["up"]), p["down"])
    return dense(gelu(dense(x, p["up"])), p["down"])


# ---------------------------------------------------------------------------
# MoE: top-k routing, capacity-bounded scatter dispatch, shared experts
# ---------------------------------------------------------------------------

#: MoE dispatch mode, as the reference's: "local" (the default) keeps the
#: batch dimension, so capacity is counted per row; "global" dispatches
#: the flat tokens with capacity from all of them; "a2a" is the
#: reference's expert-parallel path, which on one device falls back to
#: "local" as the reference's does without a mesh
MOE_DISPATCH = "local"


def moe_forward(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                capacity_factor: float = 1.25
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d).  Returns (output (b, s, d), load-balance aux loss).

    The reference pads the expert axis to a multiple of 16 so that it
    divides an expert-parallel mesh.  The port runs on one device, and
    padded experts receive no token, so it does not pad: a one-hot over
    E gives the same slots and the same output, and padding in eager
    PyTorch would copy every expert's weights on every call."""
    if MOE_DISPATCH == "global":
        return _moe_forward_global(cfg, p, x, capacity_factor)
    return _moe_forward_local(cfg, p, x, capacity_factor)


def _router(cfg: ArchConfig, p: Dict, xt: torch.Tensor):
    """Top-k routing and the Switch-style load-balance aux.

    The router runs in x's dtype and the softmax in f32.  ``lax.top_k``
    puts the lower index first on ties (frequent among bf16 logits);
    ``torch.topk`` promises no order there, so the port selects with a
    stable descending sort."""
    E, k = cfg.n_experts, cfg.top_k
    logits = dense(xt, p["router"]).float()                      # (..., E)
    probs = torch.softmax(logits, dim=-1)
    weights, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, sel = weights[..., :k], sel[..., :k]                # (..., k)
    weights = weights / (weights.sum(-1, keepdim=True) + 1e-9)
    assign = F.one_hot(sel[..., 0], E).float()
    aux = E * torch.sum(assign.reshape(-1, E).mean(0)
                        * probs.reshape(-1, E).mean(0))
    return weights.to(xt.dtype), sel, aux


def _experts(p: Dict, buf: torch.Tensor) -> torch.Tensor:
    """Every expert's gated MLP on its capacity buffer: (b, E, C, d) ->
    (b, E, C, d), one batched product per weight over the expert axis."""
    b, E, C, d = buf.shape
    xe = buf.transpose(0, 1).reshape(E, b * C, d)
    h = silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    return torch.bmm(h, p["w_down"]).reshape(E, b, C, d).transpose(0, 1)


def _dispatch_combine(p: Dict, x: torch.Tensor, weights: torch.Tensor,
                      sel: torch.Tensor, n_experts: int,
                      capacity: int) -> torch.Tensor:
    """Per row of x (b, n, d): each (token, choice) pair takes the next
    slot of its expert's buffer in flat (n·k) order; pairs past
    ``capacity`` are dropped, and the combine reads zeros for them.

    Dropped pairs are scattered to an extra slot past the capacity, which
    the expert products never see, so no step reads a count back to the
    host."""
    b, n, d = x.shape
    k = sel.shape[-1]
    flat_e = sel.reshape(b, n * k)                               # (b, n·k)
    onehot = F.one_hot(flat_e, n_experts)
    pos = onehot.cumsum(dim=1) - onehot
    pos_in_e = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    keep = pos_in_e < capacity
    slot = torch.where(keep, pos_in_e, torch.full_like(pos_in_e, capacity))
    rows = torch.arange(b, device=x.device)[:, None].expand(b, n * k)
    buf = x.new_zeros((b, n_experts, capacity + 1, d))
    buf[rows, flat_e, slot] = x.repeat_interleave(k, dim=1)
    out_buf = _experts(p, buf[:, :, :capacity])
    y_rep = out_buf[rows, flat_e, slot.clamp(max=capacity - 1)]
    y_rep = y_rep.masked_fill(~keep[..., None], 0)
    return (y_rep.reshape(b, n, k, d) * weights[..., None]).sum(dim=2)


def _shared(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return dense(silu(dense(x, p["shared_gate"])) * dense(x, p["shared_up"]),
                 p["shared_down"])


def _moe_forward_local(cfg, p, x, capacity_factor):
    """Per-row dispatch: capacity from each row's own s·k pairs."""
    b, s, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    weights, sel, aux = _router(cfg, p, x)                       # (b, s, k)
    capacity = max(1, int(math.ceil(s * k * capacity_factor / E)))
    y = _dispatch_combine(p, x, weights, sel, E, capacity)
    if "shared_gate" in p:
        y = y + _shared(p, x)
    return y, aux


def _moe_forward_global(cfg, p, x, capacity_factor):
    """Flat-token dispatch: capacity from all b·s tokens at once."""
    b, s, d = x.shape
    T = b * s
    E, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, d)
    weights, sel, aux = _router(cfg, p, xt)
    capacity = max(1, int(math.ceil(T * k * capacity_factor / E)))
    y = _dispatch_combine(p, xt[None], weights[None], sel[None], E, capacity)
    if "shared_gate" in p:
        y = y + _shared(p, xt)
    return y.reshape(b, s, d), aux
