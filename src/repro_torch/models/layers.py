"""Functional building-block layers (PyTorch counterparts of the JAX
package's ``models/layers.py``).

Parameters are plain nested dicts of tensors in the JAX package's layouts,
so a tree converted by ``repro_torch.bridge`` and one drawn by
:func:`init_params` drive the same functions.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig


# ---------------------------------------------------------------------------
# apply functions
# ---------------------------------------------------------------------------

def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...k,kn->...n")``."""
    return x @ w


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    # variance in f32, the scaling in the working dtype (as the reference)
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * gamma


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    # statistics in f32, the affine part in the working dtype (as the
    # reference)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * gamma + beta


def apply_norm(kind: str, x: torch.Tensor, p: Dict) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm(x, p["gamma"], p["beta"])
    return rmsnorm(x, p["gamma"])


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to (..., seq).

    Rotates split halves (not interleaved pairs), in f32."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)              # (hd/2,)
    angles = positions[..., :, None].float() * freqs           # (..., s, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                   # (..., s, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


ACTIVATIONS: Dict[str, Callable] = {"silu": silu, "gelu": gelu}


# ---------------------------------------------------------------------------
# parameter declaration and initialisation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"                 # normal | zeros | ones | mamba_a
    scale: float = 0.02
    #: None: the tree's dtype (``init_params``' ``dtype``); the leaves the
    #: reference declares f32 (Mamba's ``A_log`` and ``D``, RG-LRU's
    #: ``a_param``) stay f32 in a bf16 tree
    dtype: Optional[torch.dtype] = None
    #: logical axis names, one per dim, the reference's (``heads``,
    #: ``kv_heads``, ``mlp``, ``experts``, ``layers``, ...), which
    #: ``repro_torch.runtime.sharding`` maps onto a mesh
    axes: Tuple[Optional[str], ...] = ()

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def norm_defs(kind: str, dim: int) -> Dict:
    d = {"gamma": ParamDef((dim,), init="ones", axes=("embed",))}
    if kind == "layernorm":
        d["beta"] = ParamDef((dim,), init="zeros", axes=("embed",))
    return d


def mlp_defs(cfg: ArchConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    defs = {"up": ParamDef((d, f), axes=("embed", "mlp")),
            "down": ParamDef((f, d), axes=("mlp", "embed"))}
    if cfg.gated_mlp:
        defs["gate"] = ParamDef((d, f), axes=("embed", "mlp"))
    return defs


def moe_defs(cfg: ArchConfig) -> Dict:
    """The router, the routed experts ``(E, ...)`` and the shared ones."""
    d, f, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    fs = cfg.n_shared_experts * f
    ex = ("experts", "embed", "expert_mlp")
    defs = {"router": ParamDef((d, E), axes=("embed", "experts")),
            "w_gate": ParamDef((E, d, f), axes=ex),
            "w_up": ParamDef((E, d, f), axes=ex),
            "w_down": ParamDef((E, f, d),
                               axes=("experts", "expert_mlp", "embed"))}
    if fs:
        defs["shared_gate"] = ParamDef((d, fs), axes=("embed", "mlp"))
        defs["shared_up"] = ParamDef((d, fs), axes=("embed", "mlp"))
        defs["shared_down"] = ParamDef((fs, d), axes=("mlp", "embed"))
    return defs


def attention_defs(cfg: ArchConfig) -> Dict:
    """GQA projections, or MLA's low-rank q and compressed KV latent."""
    d, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.mla is not None:
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "q_down": ParamDef((d, m.q_lora_rank),
                               axes=("embed", "mla_rank")),
            "q_norm": ParamDef((m.q_lora_rank,), init="ones",
                               axes=("mla_rank",)),
            "q_up": ParamDef((m.q_lora_rank, H, qk),
                             axes=("mla_rank", "heads", "head_dim")),
            "kv_down": ParamDef((d, m.kv_lora_rank + m.qk_rope_head_dim),
                                axes=("embed", "mla_rank")),
            "kv_norm": ParamDef((m.kv_lora_rank,), init="ones",
                                axes=("mla_rank",)),
            "kv_up": ParamDef((m.kv_lora_rank, H,
                               m.qk_nope_head_dim + m.v_head_dim),
                              axes=("mla_rank", "heads", "head_dim")),
            "wo": ParamDef((H, m.v_head_dim, d),
                           axes=("heads", "head_dim", "embed")),
        }
    defs = {"wq": ParamDef((d, H, hd), axes=("embed", "heads", "head_dim")),
            "wk": ParamDef((d, Hk, hd),
                           axes=("embed", "kv_heads", "head_dim")),
            "wv": ParamDef((d, Hk, hd),
                           axes=("embed", "kv_heads", "head_dim")),
            "wo": ParamDef((H, hd, d), axes=("heads", "head_dim", "embed"))}
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H, hd), init="zeros",
                              axes=("heads", "head_dim"))
        defs["bk"] = ParamDef((Hk, hd), init="zeros",
                              axes=("kv_heads", "head_dim"))
        defs["bv"] = ParamDef((Hk, hd), init="zeros",
                              axes=("kv_heads", "head_dim"))
    return defs


def cross_attention_defs(cfg: ArchConfig) -> Dict:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    proj = ("embed", "heads", "head_dim")
    return {"wq": ParamDef((d, H, hd), axes=proj),
            "wk": ParamDef((d, H, hd), axes=proj),
            "wv": ParamDef((d, H, hd), axes=proj),
            "wo": ParamDef((H, hd, d), axes=("heads", "head_dim", "embed"))}


def mamba_defs(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    di, n = cfg.ssm_expand * d, cfg.ssm_d_state
    dtr = cfg.ssm_dt_rank or max(1, d // 16)
    inner = ("inner",)
    return {
        "in_proj": ParamDef((d, 2 * di), axes=("embed", "inner")),
        "conv_w": ParamDef((di, cfg.ssm_conv_kernel), axes=("inner", None)),
        "conv_b": ParamDef((di,), init="zeros", axes=inner),
        "x_proj": ParamDef((di, dtr + 2 * n), axes=("inner", None)),
        "dt_proj": ParamDef((dtr, di), axes=(None, "inner")),
        "dt_bias": ParamDef((di,), init="zeros", axes=inner),
        "A_log": ParamDef((di, n), init="mamba_a", dtype=torch.float32,
                          axes=("inner", "state")),
        "D": ParamDef((di,), init="ones", dtype=torch.float32, axes=inner),
        "out_proj": ParamDef((di, d), axes=("inner", "embed")),
    }


def rglru_defs(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    inner = ("inner",)
    return {
        "linear_x": ParamDef((d, w), axes=("embed", "inner")),
        "linear_y": ParamDef((d, w), axes=("embed", "inner")),
        "conv_w": ParamDef((w, cfg.ssm_conv_kernel), axes=("inner", None)),
        "conv_b": ParamDef((w,), init="zeros", axes=inner),
        "gate_i_w": ParamDef((w,), init="ones", axes=inner),
        "gate_i_b": ParamDef((w,), init="zeros", axes=inner),
        "gate_r_w": ParamDef((w,), init="ones", axes=inner),
        "gate_r_b": ParamDef((w,), init="zeros", axes=inner),
        "a_param": ParamDef((w,), init="ones", dtype=torch.float32,
                            axes=inner),
        "linear_out": ParamDef((w, d), axes=("inner", "embed")),
    }


def _layer_defs(cfg: ArchConfig, kind: str) -> Dict:
    """One decoder layer of the given temporal-mixer kind (``attn``,
    ``ssm`` or ``rglru``); an encoder-decoder's attention layer adds
    cross-attention.  A layer without a channel mixer (an SSM layer, or
    ``d_ff == 0`` outside MoE) has no ``ln2``/``mlp``."""
    d = {"ln1": norm_defs(cfg.norm_kind, cfg.d_model)}
    if kind == "attn":
        d["attn"] = attention_defs(cfg)
        if cfg.n_encoder_layers:
            d["ln_x"] = norm_defs(cfg.norm_kind, cfg.d_model)
            d["xattn"] = cross_attention_defs(cfg)
    elif kind == "ssm":
        d["ssm"] = mamba_defs(cfg)
    elif kind == "rglru":
        d["rglru"] = rglru_defs(cfg)
    if kind != "ssm" and (cfg.d_ff or cfg.family == "moe"):
        d["ln2"] = norm_defs(cfg.norm_kind, cfg.d_model)
        d["mlp"] = moe_defs(cfg) if cfg.family == "moe" else mlp_defs(cfg)
    return d


def _stack_defs(defs: Dict, n: int) -> Dict:
    """Prepend a stacked layer axis of n to every leaf."""
    return {k: (_stack_defs(v, n) if isinstance(v, dict)
                else dataclasses.replace(v, shape=(n,) + v.shape,
                                         axes=("layers",) + v.axes))
            for k, v in defs.items()}


#: families whose decoder layers are stacked on a leading ``(L, ...)``
#: axis; the others (hybrid patterns, encoder-decoders) are unrolled as
#: ``layers["l{i}"]``, as in the reference
STACKED_FAMILIES = ("dense", "vlm", "moe", "ssm")


def param_defs(cfg: ArchConfig) -> Dict:
    """The model's parameter tree in the JAX package's layouts and key
    names: homogeneous stacks (dense, VLM, MoE, SSM) stacked on a leading
    ``(L, ...)`` axis, hybrid and encoder-decoder stacks unrolled as
    ``layers["l{i}"]``; an encoder-decoder adds the stacked ``encoder``."""
    defs: Dict = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model),
                          axes=("vocab", "embed")),
        "ln_f": norm_defs(cfg.norm_kind, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                   axes=("embed", "vocab"))
    kinds = cfg.block_kinds()
    if cfg.family in STACKED_FAMILIES:
        defs["layers"] = _stack_defs(_layer_defs(cfg, kinds[0]),
                                     cfg.n_layers)
    else:
        defs["layers"] = {f"l{i}": _layer_defs(cfg, k)
                          for i, k in enumerate(kinds)}
    if cfg.family == "vlm":
        defs["vision_proj"] = ParamDef((cfg.d_model, cfg.d_model),
                                       axes=("embed", "embed_out"))
    if cfg.family == "encdec":
        enc_layer = {"ln1": norm_defs(cfg.norm_kind, cfg.d_model),
                     "attn": attention_defs(cfg),
                     "ln2": norm_defs(cfg.norm_kind, cfg.d_model),
                     "mlp": mlp_defs(cfg)}
        defs["encoder"] = {
            "layers": _stack_defs(enc_layer, cfg.n_encoder_layers),
            "ln_f": norm_defs(cfg.norm_kind, cfg.d_model)}
    return defs


def _materialize(defs: Dict, gen: torch.Generator, device: torch.device,
                 dtype: torch.dtype, keep: Optional[Callable] = None,
                 path: Tuple[str, ...] = ()) -> Dict:
    out = {}
    for k in sorted(defs):           # a fixed draw order for a given seed
        d = defs[k]
        if isinstance(d, dict):
            out[k] = _materialize(d, gen, device, dtype, keep, path + (k,))
            continue
        dt = d.dtype or dtype
        if d.init == "zeros":
            w = torch.zeros(d.shape, dtype=dt, device=device)
        elif d.init == "ones":
            w = torch.ones(d.shape, dtype=dt, device=device)
        elif d.init == "mamba_a":
            # Mamba's A_log: log(1..d_state) broadcast over the channels
            n = d.shape[-1]
            a = np.tile(np.arange(1, n + 1, dtype=np.float32),
                        d.shape[:-1] + (1,))
            w = torch.from_numpy(np.log(a)).to(device=device, dtype=dt)
        else:
            w = torch.randn(d.shape, generator=gen, dtype=dt, device=device)
            w.mul_(d.scale)
        out[k] = w if keep is None else keep(path + (k,), d.axes, w)
    return out


def logical_axes(cfg: ArchConfig) -> Dict:
    """The tree of each leaf's logical axis names (``ParamDef.axes``), in
    the parameter tree's nesting."""
    def axes(defs):
        return {k: (axes(v) if isinstance(v, dict) else v.axes)
                for k, v in defs.items()}
    return axes(param_defs(cfg))


def init_params(cfg: ArchConfig, seed: int = 0, *, device="cuda",
                dtype: torch.dtype = torch.bfloat16,
                keep: Optional[Callable] = None) -> Dict:
    """Random weights from a seeded generator on ``device``: normal with
    std 0.02, norm gains ones, biases zeros, Mamba's ``A_log`` its
    log(1..d_state) (the reference's init rule; the draws differ from
    ``jax.random``'s, so tests that compare the two implementations
    convert one tree with ``repro_torch.bridge``).

    ``keep(path, axes, leaf)`` is applied to each leaf as soon as it is
    drawn and its result is kept in the leaf's place: a rank of a mesh
    keeps its shard (``repro_torch.runtime.sharding.init_shard``) and the
    whole leaf is freed before the next is drawn, while every leaf is
    still drawn whole in this order, so the shards are cut from the very
    weights of the one-device tree."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _materialize(param_defs(cfg), gen, dev, dtype, keep)
