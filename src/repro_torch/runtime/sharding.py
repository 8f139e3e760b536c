"""Logical-axis sharding rules, and the cut of a parameter tree to one
rank's shard (the PyTorch counterpart of the JAX package's
``runtime/sharding.py``).

Every parameter carries logical axis names
(``repro_torch.models.layers.ParamDef.axes``).  The reference maps them
onto a JAX mesh as ``NamedSharding``s and lets GSPMD place the data; a
rank of the port holds only its own shard, cut here by the same rules:

* ``heads``, ``kv_heads``, ``mlp`` and ``experts`` over the tensor-
  parallel axis (``"model"``): contiguous blocks, rank ``m`` holding
  block ``m``; the stacked expert axis is first zero-padded to a multiple
  of ``MOE_EXPERT_PAD_TO`` (``models.blocks.pad_experts``, the
  reference's ``_pad_experts``), so
  qwen2-moe-a2.7b's 60 experts become 64, 32 per rank at tp = 2;
* the stacked ``layers`` axis over the pipeline axis (``"pipe"``):
  stage ``s`` holds layers ``s·L/pp .. (s+1)·L/pp - 1``.

Two differences from the reference, in where data lives and not in any
result: ``embed`` and ``lm_head`` stay whole on every rank (the
reference shards ``vocab``), so every rank computes the same logits
with no all-gather, which gloo cannot do on CUDA tensors; and the MoE
``router`` stays whole, since every rank routes every token over all
experts.

The rules' other entries (``vocab``, ``inner``, ``batch``, FSDP's
``embed``) and the fallback rules (``kv_len``/``seq`` over tp), with
``batch_shardings``, are not on the engine's path and wait (ROADMAP
queue 1, item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.blocks import pad_experts, padded_experts
from repro_torch.models.layers import init_params, logical_axes


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    #: mesh data-parallel axes (in spec order), e.g. ("pod", "data")
    dp_axes: Tuple[str, ...] = ("data",)
    #: mesh tensor-parallel axis
    tp_axis: str = "model"
    #: mesh pipeline-stage axis (stacked layer dim of params + KV pool)
    pp_axis: str = "pipe"
    #: shard params' "embed" axis over dp (ZeRO-3 / FSDP)
    fsdp: bool = False
    #: shard sequence over tp for activations when batch < dp (long context)
    seq_shard: bool = False

    def primary_rules(self) -> Dict[str, Sequence]:
        tp = (self.tp_axis,)
        rules: Dict[str, Sequence] = {
            "vocab": tp, "heads": tp, "kv_heads": tp, "mlp": tp,
            "experts": tp, "inner": tp,
            "batch": (self.dp_axes,),    # tuple-of-axes = combined sharding
            "layers": (self.pp_axis,),   # stacked layer dim → pipeline stage
        }
        if self.fsdp:
            rules["embed"] = (self.dp_axes,)
        if self.seq_shard:
            rules["seq"] = tp
        return rules


#: the logical axes a rank's engine shard is cut on (the rest of the
#: primary rules wait; see the module docstring)
ENGINE_AXES = ("heads", "kv_heads", "mlp", "experts", "layers")
#: leaves every tp rank keeps whole (their stacked layers still split
#: over the pipeline stages)
WHOLE_LEAVES = ("router",)


def tp_degree(mesh, policy: ShardingPolicy) -> int:
    """Tensor-parallel ways of this mesh under the policy (1 without a
    mesh or a tp axis): the measured counterpart of
    ``repro_torch.core.ShardingPlan.tp``."""
    return int(mesh.shape.get(policy.tp_axis, 1)) if mesh is not None else 1


def pp_degree(mesh, policy: ShardingPolicy) -> int:
    """Pipeline-parallel ways of this mesh under the policy (1 without a
    mesh or a pipe axis): the counterpart of ``ShardingPlan.pp``."""
    return int(mesh.shape.get(policy.pp_axis, 1)) if mesh is not None else 1


def engine_rules(policy: ShardingPolicy) -> Dict[str, str]:
    """Logical axis -> mesh axis, for the axes an engine shard cuts."""
    rules = policy.primary_rules()
    return {name: rules[name][0] for name in ENGINE_AXES}


def _cut_dims(path: Tuple[str, ...], axes: Tuple[Optional[str], ...],
              sizes: Dict[str, int], policy: ShardingPolicy
              ) -> Dict[str, int]:
    """Mesh axis -> the dim of one leaf it cuts (each mesh axis cuts the
    first dim whose logical axis it owns, as the reference's spec)."""
    rules = engine_rules(policy)
    if path[-1] in WHOLE_LEAVES:
        rules = {"layers": rules["layers"]}
    out: Dict[str, int] = {}
    for i, name in enumerate(axes):
        axis = rules.get(name)
        if axis is not None and axis not in out and sizes.get(axis, 1) > 1:
            out[axis] = i
    return out


def shard_leaf(path: Tuple[str, ...], axes: Tuple[Optional[str], ...],
               t: torch.Tensor, mesh, policy: ShardingPolicy = ShardingPolicy()
               ) -> torch.Tensor:
    """One rank's shard of the whole leaf ``t`` at ``path`` with logical
    ``axes``: a contiguous copy, owned by the rank (never a view of
    ``t``); a leaf with no cut comes back as it is."""
    cuts = _cut_dims(path, axes, mesh.shape, policy)
    if not cuts:
        return t
    for axis, dim in cuts.items():
        n, ways = t.shape[dim], mesh.shape[axis]
        if axes[dim] == "experts":
            n = padded_experts(n)
        if n % ways:
            raise ValueError(
                f"{'/'.join(path)}: its {axes[dim]!r} axis of {n} does not "
                f"divide over {ways} {axis!r} ranks")
        w = n // ways
        lo = mesh.coords[axis] * w
        if axes[dim] == "experts":
            # the block's experts past E are zeros (the padded leaf itself
            # is never built)
            have = max(0, min(w, t.shape[dim] - lo))
            t = pad_experts(t.narrow(dim, min(lo, t.shape[dim]), have),
                            dim, w)
        else:
            t = t.narrow(dim, lo, w)
    return t.clone(memory_format=torch.contiguous_format)


def _walk(tree: Dict, axes: Dict, fn: Callable, path=()) -> Dict:
    return {k: (_walk(v, axes[k], fn, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), axes[k], v))
            for k, v in tree.items()}


def shard_params(params: Dict, cfg: ArchConfig, mesh,
                 policy: ShardingPolicy = ShardingPolicy()) -> Dict:
    """Cut a whole parameter tree to ``mesh``'s rank."""
    return _walk(params, logical_axes(cfg),
                 lambda p, ax, t: shard_leaf(p, ax, t, mesh, policy))


def init_shard(cfg: ArchConfig, seed: int, mesh,
               policy: ShardingPolicy = ShardingPolicy(), *, device="cuda",
               dtype: torch.dtype = torch.bfloat16) -> Dict:
    """This rank's shard of ``init_params(cfg, seed)``: every leaf drawn
    whole in ``init_params``' order, cut, and freed before the next, so
    the shard holds the one-device weights and no rank ever holds the
    whole tree."""
    return init_params(cfg, seed, device=device, dtype=dtype,
                       keep=lambda p, ax, t: shard_leaf(p, ax, t, mesh,
                                                        policy))


def local_config(cfg: ArchConfig, tp: int) -> ArchConfig:
    """The config a tensor-parallel rank's layer bodies run: its
    ``n_heads/tp`` query heads over ``n_kv_heads/tp`` KV heads (the
    layers' shapes; the rest of the config is the model's)."""
    if tp == 1:
        return cfg
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp,
                               head_dim=cfg.head_dim)


__all__ = ["ENGINE_AXES", "ShardingPolicy", "WHOLE_LEAVES", "engine_rules",
           "init_shard", "local_config", "pp_degree", "shard_leaf",
           "shard_params", "tp_degree"]
