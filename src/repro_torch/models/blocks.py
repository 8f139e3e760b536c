"""Per-family blocks: the dense MLP, the MoE layer (top-k routing,
capacity-bounded scatter dispatch, shared experts), the Mamba-1
selective SSM and the RG-LRU (Griffin) recurrence — the PyTorch
counterparts of the JAX package's ``models/blocks.py``, each recurrence
with a sequence forward and a cached step.

The recurrences run as a loop over positions in the reference's order
(its ``lax.scan``), not as a parallel scan, whose sums round otherwise.

Under a tensor-parallel hint (``models.act_sharding``) each block runs
on the leaves a rank holds (``runtime.sharding``) and reads its widths
from them: the MLP on its ``mlp`` columns, Mamba and the RG-LRU on their
``inner`` channels (the input projections cut by columns, the conv,
gates, ``dt`` and the recurrence per channel).  A product that contracts
over a cut axis gives a partial sum, summed over the tp group in one
``all_reduce``: the MLP's ``down``, Mamba's ``x_proj`` (before dt, B and
C are split from it) and ``out_proj``, the RG-LRU's ``linear_out``.  A
replicated activation that meets the rank's columns passes
``act_sharding.tp_copy`` (its backward sums the partial gradients): the
input of ``gate``/``up``, of Mamba's ``in_proj`` and of the RG-LRU's
``linear_x``/``linear_y``, Mamba's summed ``x_proj`` output, and the
MoE dispatch's tokens and combine weights (the router itself runs whole
on every rank).  A block whose axis tp does not divide holds it whole
and runs as on one device, with no collective."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from . import act_sharding
from .layers import dense, gelu, silu


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), with no
    linear cut-off."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mlp_forward(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.gated_mlp:
        return dense(silu(dense(x, p["gate"])) * dense(x, p["up"]), p["down"])
    return dense(gelu(dense(x, p["up"])), p["down"])


def _sum_if_cut(y: torch.Tensor, held: int, whole: int) -> torch.Tensor:
    """The tp group's sum of a row-parallel partial ``y`` when the rank
    holds ``held`` of the contracted axis's ``whole`` width; ``y`` as it
    is when the axis stayed whole."""
    return act_sharding.tp_all_reduce(y) if held < whole else y


def _copy_if_cut(x: torch.Tensor, held: int, whole: int) -> torch.Tensor:
    """``act_sharding.tp_copy`` of an input the rank's cut columns read
    (``held`` of ``whole``); ``x`` as it is when the axis stayed whole."""
    return act_sharding.tp_copy(x) if held < whole else x


def mlp_sharded(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """:func:`mlp_forward` on a rank's ``mlp`` columns, its ``down``
    partial summed over the tp group (the identity without a cut)."""
    held = p["down"].shape[0]
    return _sum_if_cut(mlp_forward(cfg, p, _copy_if_cut(x, held, cfg.d_ff)),
                       held, cfg.d_ff)


# ---------------------------------------------------------------------------
# MoE: top-k routing, capacity-bounded scatter dispatch, shared experts
# ---------------------------------------------------------------------------

#: MoE dispatch mode, as the reference's: "local" (the default) keeps the
#: batch dimension, so capacity is counted per row; "global" dispatches
#: the flat tokens with capacity from all of them; "a2a" is the
#: reference's expert-parallel path, which without a tensor-parallel
#: mesh routes to "local", as the reference's does (its ``:179-181``)
MOE_DISPATCH = "local"
#: the stacked expert axis is padded to a multiple of this, so that it
#: divides an expert-parallel mesh axis (the reference's constant)
MOE_EXPERT_PAD_TO = 16


def padded_experts(E: int) -> int:
    """E rounded up to a multiple of :data:`MOE_EXPERT_PAD_TO`."""
    return -(-E // MOE_EXPERT_PAD_TO) * MOE_EXPERT_PAD_TO


def pad_experts(w: torch.Tensor, dim: int, to: int) -> torch.Tensor:
    """The reference's ``_pad_experts`` on one stacked expert leaf: its
    expert axis ``dim`` zero-padded to ``to`` experts (padded experts are
    exact zeros, and the router never selects them).  The port pads
    once, where ``runtime.sharding`` cuts a rank's block of experts, and
    not on every call as the reference does."""
    pad = list(w.shape)
    pad[dim] = to - w.shape[dim]
    return torch.cat([w, w.new_zeros(pad)], dim=dim) if pad[dim] else w


def moe_forward(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                capacity_factor: float = 1.25
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d).  Returns (output (b, s, d), load-balance aux loss).

    On one device the port does not pad the expert axis: padded experts
    receive no token, so a one-hot over E gives the same slots and the
    same output, and padding in eager PyTorch would copy every expert's
    weights on every call.

    Under a tensor-parallel hint (``models.act_sharding``) the layer runs
    expert-parallel, whatever the dispatch mode, as the reference's
    ``_moe_forward_a2a`` does: ``p`` holds this rank's ``E_pad/tp``
    experts (cut from the padded axis by ``runtime.sharding``) and its
    ``1/tp`` of the shared experts' columns, with the router whole.  The
    rank routes every token, builds the whole capacity buffer, computes
    its experts only and combines the entries routed to them; the routed
    and shared partial outputs are summed over the ranks in one
    ``all_reduce`` (the reference's single psum).  Capacity, drops and
    combine order are the one-device path's.  Experts (or shared
    columns) that tp does not divide stay whole on every rank, which
    then computes all of them and sums nothing for them."""
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
    assign = F.one_hot(sel[..., 0], E).float().reshape(-1, E)
    probs = probs.reshape(-1, E)
    if act_sharding.dp_size() == 1:
        aux = E * torch.sum(assign.mean(0) * probs.mean(0))
    else:
        # the reference's means run over the global batch: each replica's
        # sums added over the data-parallel group first
        n = assign.shape[0] * act_sharding.dp_size()
        aux = E * torch.sum((act_sharding.dp_all_reduce(assign.sum(0)) / n)
                            * (act_sharding.dp_all_reduce(probs.sum(0)) / n))
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
    host.  ``p`` holds experts ``lo .. lo + e_loc - 1`` (all of them on
    one device, this rank's under expert parallelism, ``lo`` from its tp
    rank): pairs routed elsewhere are treated as dropped here, so the
    result is this rank's share of the combine."""
    b, n, d = x.shape
    k = sel.shape[-1]
    e_loc = p["w_gate"].shape[0]
    lo = act_sharding.tp_rank() * e_loc if _experts_cut(n_experts) else 0
    flat_e = sel.reshape(b, n * k)                               # (b, n·k)
    onehot = F.one_hot(flat_e, n_experts)
    pos = onehot.cumsum(dim=1) - onehot
    pos_in_e = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    rel = flat_e - lo
    keep = (pos_in_e < capacity) & (rel >= 0) & (rel < e_loc)
    rel = rel.clamp(0, e_loc - 1)
    slot = torch.where(keep, pos_in_e, torch.full_like(pos_in_e, capacity))
    rows = torch.arange(b, device=x.device)[:, None].expand(b, n * k)
    buf = x.new_zeros((b, e_loc, capacity + 1, d))
    buf[rows, rel, slot] = x.repeat_interleave(k, dim=1)
    out_buf = _experts(p, buf[:, :, :capacity])
    y_rep = out_buf[rows, rel, slot.clamp(max=capacity - 1)]
    y_rep = y_rep.masked_fill(~keep[..., None], 0)
    return (y_rep.reshape(b, n, k, d) * weights[..., None]).sum(dim=2)


def _shared(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return dense(silu(dense(x, p["shared_gate"])) * dense(x, p["shared_up"]),
                 p["shared_down"])


def _experts_cut(n_experts: int) -> bool:
    """Whether the rank holds a block of the padded experts (tp divides
    them, ``runtime.sharding``'s rule) rather than all of them."""
    tp = act_sharding.tp_size()
    return tp > 1 and padded_experts(n_experts) % tp == 0


def _routed_and_shared(cfg, p, x, weights, sel, capacity):
    """The routed experts' combine plus the shared experts' output, each
    summed over the tp group where the rank holds a cut of it: one
    ``all_reduce`` of their sum when both are cut (the reference's single
    psum); a part held whole is added after the sum."""
    cut = _experts_cut(cfg.n_experts)
    shared_cut = ("shared_gate" in p and p["shared_down"].shape[0]
                  < cfg.n_shared_experts * cfg.d_ff_expert)
    # the rank's experts and shared columns read the tokens through f;
    # the router ran whole on every rank
    xc = act_sharding.tp_copy(x) if cut or shared_cut else x
    if cut:
        weights = act_sharding.tp_copy(weights)
    y = _dispatch_combine(p, xc if cut else x, weights, sel, cfg.n_experts,
                          capacity)
    if "shared_gate" not in p:
        return act_sharding.tp_all_reduce(y) if cut else y
    ys = _shared(p, xc if shared_cut else x)
    if cut == shared_cut:
        y = y + ys
        return act_sharding.tp_all_reduce(y) if cut else y
    if cut:
        return act_sharding.tp_all_reduce(y) + ys
    return y + act_sharding.tp_all_reduce(ys)


def _moe_forward_local(cfg, p, x, capacity_factor):
    """Per-row dispatch: capacity from each row's own s·k pairs."""
    b, s, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    weights, sel, aux = _router(cfg, p, x)                       # (b, s, k)
    capacity = max(1, int(math.ceil(s * k * capacity_factor / E)))
    return _routed_and_shared(cfg, p, x, weights, sel, capacity), aux


def _moe_forward_global(cfg, p, x, capacity_factor):
    """Flat-token dispatch: capacity from all b·s tokens at once."""
    b, s, d = x.shape
    T = b * s
    E, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, d)
    weights, sel, aux = _router(cfg, p, xt)
    capacity = max(1, int(math.ceil(T * k * capacity_factor / E)))
    y = _routed_and_shared(cfg, p, xt[None], weights[None], sel[None],
                           capacity)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Mamba-1 selective SSM
# ---------------------------------------------------------------------------

#: sequences longer than this, and a multiple of it, stream through the
#: SSM in pieces of this many tokens, as the reference's forward does
SSM_CHUNK = 1024


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor,
                           state: Optional[torch.Tensor] = None):
    """x: (b, s, C); w: (C, K).  Returns (y, new state (b, K-1, C)).

    The state and x are joined in their promoted dtype, as
    ``jnp.concatenate`` joins them: a bf16 state meets f32 activations
    of an f32 tree and comes back f32."""
    K = w.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    dt = torch.promote_types(state.dtype, x.dtype)
    xp = torch.cat([state.to(dt), x.to(dt)], dim=1)      # (b, K-1+s, C)
    s = x.shape[1]
    y = sum(xp[:, i:i + s, :] * w[:, i] for i in range(K)) + b
    new_state = xp[:, -(K - 1):, :] if K > 1 else state
    return y, new_state


def _inner(cfg: ArchConfig) -> int:
    """Mamba's whole inner width (``ssm_expand · d_model``)."""
    return cfg.ssm_expand * cfg.d_model


def _ssm_params(cfg: ArchConfig, p: Dict, x_c: torch.Tensor):
    """dt (softplus, f32), A = -exp(A_log), and B, C in f32.  ``x_proj``
    contracts over ``inner``: a rank's partial is summed before the
    split."""
    dtr = cfg.ssm_dt_rank or max(1, cfg.d_model // 16)
    n = cfg.ssm_d_state
    held = p["D"].shape[0]
    # summed over the tp group, then read by the rank's channels again
    xp = _copy_if_cut(_sum_if_cut(dense(x_c, p["x_proj"]), held,
                                  _inner(cfg)), held, _inner(cfg))
    dt_raw, B, C = xp.split([dtr, n, n], dim=-1)
    dt = _softplus(dense(dt_raw, p["dt_proj"]).float()
                   + p["dt_bias"].float())
    A = -torch.exp(p["A_log"])                              # (di, n)
    return dt, A, B.float(), C.float()


def _ssm_update(h, dt_t, A, B_t, C_t, x_t):
    """One position of the selective scan: h (b, di, n) <- h * exp(dt A)
    + dt B x; returns (h, y = h . C (b, di)), all f32."""
    dA = torch.exp(dt_t[..., None] * A)
    h = h * dA + dt_t[..., None] * B_t[:, None, :] * x_t[..., None]
    return h, (h * C_t[:, None, :]).sum(-1)


def _mamba_seq(cfg: ArchConfig, p: Dict, x: torch.Tensor, conv_state,
               ssm_state):
    """One contiguous piece; threads (conv_state, ssm_state) through."""
    x = _copy_if_cut(x, p["D"].shape[0], _inner(cfg))
    x_in, z = dense(x, p["in_proj"]).chunk(2, dim=-1)
    x_c, conv_state = _causal_depthwise_conv(x_in, p["conv_w"], p["conv_b"],
                                             conv_state)
    x_c = silu(x_c)
    dt, A, B, C = _ssm_params(cfg, p, x_c)
    xf = x_c.float()
    # each position's views taken once, as in _rglru_scan
    ys = []
    for dt_t, B_t, C_t, x_t in zip(dt.unbind(1), B.unbind(1), C.unbind(1),
                                   xf.unbind(1)):
        ssm_state, y_t = _ssm_update(ssm_state, dt_t, A, B_t, C_t, x_t)
        ys.append(y_t)
    y = torch.stack(ys, dim=1) + xf * p["D"]
    out = y.to(x.dtype) * silu(z)
    return _mamba_out(cfg, p, out), conv_state, ssm_state


def _mamba_out(cfg: ArchConfig, p: Dict, out: torch.Tensor) -> torch.Tensor:
    return _sum_if_cut(dense(out, p["out_proj"]), p["D"].shape[0],
                       _inner(cfg))


def mamba_forward(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Sequence forward; long sequences stream in ``SSM_CHUNK`` pieces."""
    b, s, d = x.shape
    di = p["D"].shape[0]
    conv = x.new_zeros((b, cfg.ssm_conv_kernel - 1, di))
    ssm = torch.zeros((b, di, cfg.ssm_d_state), dtype=torch.float32,
                      device=x.device)
    if s <= SSM_CHUNK or s % SSM_CHUNK:
        return _mamba_seq(cfg, p, x, conv, ssm)[0]
    ys = []
    for x_i in x.split(SSM_CHUNK, dim=1):
        y_i, conv, ssm = _mamba_seq(cfg, p, x_i, conv, ssm)
        ys.append(y_i)
    return torch.cat(ys, dim=1)


def mamba_step(cfg: ArchConfig, p: Dict, x_t: torch.Tensor,
               conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """The cached step, as the reference's: the conv state takes all s
    tokens of x_t (b, s, d), but the SSM state takes the first token only
    and its output is broadcast over the s positions (a chunked prefill
    thereby differs from ``mamba_forward``; both packages do this)."""
    x_in, z = dense(x_t, p["in_proj"]).chunk(2, dim=-1)
    x_c, conv_state = _causal_depthwise_conv(x_in, p["conv_w"], p["conv_b"],
                                             conv_state)
    x_c = silu(x_c)
    dt, A, B, C = _ssm_params(cfg, p, x_c)
    xf = x_c.float()[:, 0]
    ssm_state, y = _ssm_update(ssm_state, dt[:, 0], A, B[:, 0], C[:, 0], xf)
    y = y + xf * p["D"]
    out = y[:, None, :].to(x_t.dtype) * silu(z)
    return _mamba_out(cfg, p, out), conv_state, ssm_state


def mamba_state_shapes(cfg: ArchConfig, batch: int):
    di = _inner(cfg)
    return ((batch, cfg.ssm_conv_kernel - 1, di),      # conv state (bf16)
            (batch, di, cfg.ssm_d_state))              # ssm state (f32)


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma recurrent block)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def _rglru_gates(p: Dict, x_c: torch.Tensor):
    """Input gate i (f32), decay a = exp(-c softplus(a_param) r) and the
    input scale sqrt(1 - a^2) (f32)."""
    i = torch.sigmoid(x_c * p["gate_i_w"] + p["gate_i_b"])
    r = torch.sigmoid(x_c * p["gate_r_w"] + p["gate_r_b"])
    log_a = -_RGLRU_C * _softplus(p["a_param"]) * r.float()
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-6))
    return i.float(), a, mult


def _rglru_seq(cfg: ArchConfig, p: Dict, x: torch.Tensor, conv_state,
               h_state):
    x = _copy_if_cut(x, p["a_param"].shape[0], cfg.lru_width or cfg.d_model)
    xb = dense(x, p["linear_x"])
    yb = gelu(dense(x, p["linear_y"]))
    x_c, conv_state = _causal_depthwise_conv(xb, p["conv_w"], p["conv_b"],
                                             conv_state)
    i, a, mult = _rglru_gates(p, x_c)
    gated = (i * x_c.float()) * mult
    h, h_state = _rglru_scan(a, gated, h_state)
    return _rglru_out(cfg, p, h.to(x.dtype) * yb), conv_state, h_state


def _rglru_scan(a: torch.Tensor, gated: torch.Tensor, h_state):
    """h_t = a_t h_{t-1} + gated_t over a chunk's positions (b, s, w), in
    order, f32: (every h (b, s, w), the last).  Each position's views are
    taken once (``unbind``): autograd's backward of ``a[:, t]`` would add
    a whole chunk of zeros per position, quadratic in s."""
    hs = []
    for a_t, g_t in zip(a.unbind(1), gated.unbind(1)):
        h_state = a_t * h_state + g_t
        hs.append(h_state)
    return torch.stack(hs, dim=1), h_state


def _rglru_out(cfg: ArchConfig, p: Dict, out: torch.Tensor) -> torch.Tensor:
    return _sum_if_cut(dense(out, p["linear_out"]), p["a_param"].shape[0],
                       cfg.lru_width or cfg.d_model)


def rglru_forward(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    b, s, d = x.shape
    w = p["a_param"].shape[0]
    conv = x.new_zeros((b, cfg.ssm_conv_kernel - 1, w))
    h = torch.zeros((b, w), dtype=torch.float32, device=x.device)
    if s <= SSM_CHUNK or s % SSM_CHUNK:
        return _rglru_seq(cfg, p, x, conv, h)[0]
    ys = []
    for x_i in x.split(SSM_CHUNK, dim=1):
        y_i, conv, h = _rglru_seq(cfg, p, x_i, conv, h)
        ys.append(y_i)
    return torch.cat(ys, dim=1)


def rglru_step(cfg: ArchConfig, p: Dict, x_t: torch.Tensor,
               conv_state: torch.Tensor, h_state: torch.Tensor):
    """The cached step; as :func:`mamba_step`, the recurrent state takes
    the first of the s tokens and its output is broadcast over them."""
    xb = dense(x_t, p["linear_x"])
    yb = gelu(dense(x_t, p["linear_y"]))
    x_c, conv_state = _causal_depthwise_conv(xb, p["conv_w"], p["conv_b"],
                                             conv_state)
    i, a, mult = _rglru_gates(p, x_c)
    h_state = (a[:, 0] * h_state
               + (i[:, 0] * x_c.float()[:, 0]) * mult[:, 0])
    out = h_state[:, None, :].to(x_t.dtype) * yb
    return _rglru_out(cfg, p, out), conv_state, h_state


def rglru_state_shapes(cfg: ArchConfig, batch: int):
    w = cfg.lru_width or cfg.d_model
    return ((batch, cfg.ssm_conv_kernel - 1, w),   # conv state
            (batch, w))                            # recurrent state (f32)
