"""Functional building-block layers (PyTorch counterparts of the JAX
package's ``models/layers.py``).

Parameters are plain nested dicts of tensors in the JAX package's layouts,
so a tree converted by ``repro_torch.bridge`` and one drawn by
:func:`init_params` drive the same functions.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

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


def apply_norm(kind: str, x: torch.Tensor, p: Dict) -> torch.Tensor:
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm kind {kind!r} is not ported")
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
# parameter declaration and initialisation (dense, MoE and VLM decoders)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"                 # normal | zeros | ones
    scale: float = 0.02


#: the families whose decoder the port builds: one stacked attention
#: stack each (a VLM's vision prefix goes through ``vision_proj``)
FAMILIES = ("dense", "moe", "vlm")


def _channel_defs(cfg: ArchConfig, L: int) -> Dict:
    """A layer's MLP, stacked on L: the dense (gated) MLP, or the MoE
    layer's router, routed experts ``(L, E, ...)`` and shared experts."""
    d = cfg.d_model
    if cfg.family == "moe":
        E, f = cfg.n_experts, cfg.d_ff_expert
        fs = cfg.n_shared_experts * f
        mlp = {"router": ParamDef((L, d, E)),
               "w_gate": ParamDef((L, E, d, f)),
               "w_up": ParamDef((L, E, d, f)),
               "w_down": ParamDef((L, E, f, d))}
        if fs:
            mlp["shared_gate"] = ParamDef((L, d, fs))
            mlp["shared_up"] = ParamDef((L, d, fs))
            mlp["shared_down"] = ParamDef((L, fs, d))
        return mlp
    f = cfg.d_ff
    mlp = {"up": ParamDef((L, d, f)), "down": ParamDef((L, f, d))}
    if cfg.gated_mlp:
        mlp["gate"] = ParamDef((L, d, f))
    return mlp


def param_defs(cfg: ArchConfig) -> Dict:
    """The decoder's parameter tree, layers stacked on a leading
    ``(L, ...)`` axis, in the JAX package's layouts and key names.  A
    layer without a channel mixer (``d_ff == 0`` outside MoE) has no
    ``ln2``/``mlp``, as in the reference."""
    if cfg.family not in FAMILIES or cfg.mla is not None:
        raise NotImplementedError(
            f"the port builds dense, MoE and VLM GQA decoders, not "
            f"{cfg.name!r} (family {cfg.family!r}): ROADMAP.md queue 1 "
            f"item 4")
    L, d, H, Hk, hd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                       cfg.n_kv_heads, cfg.head_dim)
    attn = {"wq": ParamDef((L, d, H, hd)), "wk": ParamDef((L, d, Hk, hd)),
            "wv": ParamDef((L, d, Hk, hd)), "wo": ParamDef((L, H, hd, d))}
    if cfg.qkv_bias:
        attn["bq"] = ParamDef((L, H, hd), init="zeros")
        attn["bk"] = ParamDef((L, Hk, hd), init="zeros")
        attn["bv"] = ParamDef((L, Hk, hd), init="zeros")
    layers = {"ln1": {"gamma": ParamDef((L, d), init="ones")}, "attn": attn}
    if cfg.d_ff or cfg.family == "moe":
        layers["ln2"] = {"gamma": ParamDef((L, d), init="ones")}
        layers["mlp"] = _channel_defs(cfg, L)
    defs = {
        "embed": ParamDef((cfg.vocab_size, d)),
        "ln_f": {"gamma": ParamDef((d,), init="ones")},
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, cfg.vocab_size))
    if cfg.family == "vlm":
        defs["vision_proj"] = ParamDef((d, d))
    return defs


def _materialize(defs: Dict, gen: torch.Generator, device: torch.device,
                 dtype: torch.dtype) -> Dict:
    out = {}
    for k in sorted(defs):           # a fixed draw order for a given seed
        d = defs[k]
        if isinstance(d, dict):
            out[k] = _materialize(d, gen, device, dtype)
        elif d.init == "zeros":
            out[k] = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            out[k] = torch.ones(d.shape, dtype=dtype, device=device)
        else:
            w = torch.randn(d.shape, generator=gen, dtype=dtype,
                            device=device)
            out[k] = w.mul_(d.scale)
    return out


def init_params(cfg: ArchConfig, seed: int = 0, *, device="cuda",
                dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Random weights from a seeded generator on ``device``: normal with
    std 0.02, norm gains ones, biases zeros (the reference's init rule;
    the draws differ from ``jax.random``'s, so tests that compare the two
    implementations convert one tree with ``repro_torch.bridge``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _materialize(param_defs(cfg), gen, dev, dtype)
