"""Logical-axis sharding rules, and the cut of a parameter tree and a
decode state to one rank's shard (the PyTorch counterpart of the JAX
package's ``runtime/sharding.py``).

Every parameter and decode-state tensor carries logical axis names
(``repro_torch.models.layers.ParamDef.axes``, :func:`decode_state_axes`).
:func:`spec_for` resolves them onto a mesh as the reference's does: the
primary rules first (``vocab``, ``heads``, ``kv_heads``, ``mlp``,
``experts`` and ``inner`` over the tensor-parallel axis ``"model"``,
``batch`` over the data axes, the stacked ``layers`` over ``"pipe"``,
FSDP's ``embed`` over the data axes), then the fallback rules (``kv_len``,
and ``seq`` under ``seq_shard``, over ``"model"``) for mesh axes still
unused; an assignment that does not divide is dropped, so the dim stays
whole.  :func:`param_specs` and :func:`decode_state_specs` give the
reference's spec of every leaf.  The reference hands those specs to
GSPMD, which places the data; a rank of the port holds only its own
shard, cut here by the same specs, rank ``m`` of a cut axis holding its
``m``-th contiguous block.

The port's overrides, all in where data lives and none in any result:

* ``embed`` and ``lm_head`` stay whole on every rank (the reference
  shards ``vocab``), so every rank computes the same logits with no
  all-gather, which gloo cannot do on CUDA tensors;
* the MoE ``router`` stays whole, since every rank routes every token
  over all experts; the stacked ``experts`` axis is zero-padded to a
  multiple of ``MOE_EXPERT_PAD_TO`` (``models.blocks.pad_experts``, the
  reference's ``_pad_experts``) before it is cut, so qwen2-moe-a2.7b's 60
  experts become 64, 32 per rank at tp = 2;
* Mamba's ``in_proj`` holds the input half and the gate half side by
  side on its ``inner`` axis; each half is cut on its own, so a rank's
  columns are its channels of both (a contiguous cut would give rank 0
  the input half and rank 1 the gate);
* a cache whose tensor-parallel cut falls on ``kv_len`` stays whole on
  every tp rank: the reference's fallback puts ``"model"`` on the MLA
  latent cache's ``kv_len`` and on recurrentgemma-2b's local cache
  (``kv_heads`` = 1 does not divide), and GSPMD then moves that data to
  the head-sharded queries.  Every rank writes the same values into its
  whole copy, since ``kv_down``'s ``mla_rank`` axis and Hk = 1's
  ``wk``/``wv`` are whole, so their inputs are replicated;
* a pipeline stage holds the layers it runs: stage ``s`` of ``pp`` runs
  model layers ``s·L//pp .. (s+1)·L//pp - 1`` (:func:`stage_range`), and
  holds that block of a stacked ``layers`` axis (the reference's block
  whenever ``pp`` divides ``L``), only its own ``layers["l{i}"]`` of an
  unrolled stack (the reference has no ``layers`` axis there, so GSPMD
  keeps them whole on every stage), and of each per-kind decode-state
  stack the entries of its layers of that kind.

A decode state is cut by :func:`init_state_shard`, which builds each
key's rank-sized zeros from the whole shape and the spec.  ``batch`` is
cut over the data axes, which the port's meshes hold at one rank.
``batch_shardings`` waits for the trainer's dp (ROADMAP queue 1, item 5).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.blocks import pad_experts, padded_experts
from repro_torch.models.layers import init_params, logical_axes, param_defs
from repro_torch.models.model import decode_state_shapes

#: one dim of a spec: a mesh axis, a tuple of them, or None (whole)
Spec = Tuple[Optional[object], ...]


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

    def fallback_rules(self) -> Dict[str, Sequence]:
        # used only if the primary owner of the tp axis was not divisible;
        # KV length always falls back (cache memory dominates decode);
        # activation seq only under an explicit sequence-sharding policy
        rules: Dict[str, Sequence] = {"kv_len": (self.tp_axis,)}
        if self.seq_shard:
            rules["seq"] = (self.tp_axis,)
        return rules


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


def _axis_size(mesh, axis) -> int:
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def spec_for(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...], mesh,
             policy: ShardingPolicy) -> Spec:
    """Resolve one tensor's logical axes to a spec: per dim a mesh axis,
    a tuple of mesh axes (a combined cut) or None.

    Two passes: primary rules first (TP/DP/FSDP owners), then fallbacks
    (sequence sharding) for mesh axes still unused.  Any assignment
    failing divisibility is dropped (the dim stays whole), never an
    error.  Reads only ``mesh.shape``."""
    assert len(axes) == len(shape), (axes, shape)
    used = set()
    out: list = [None] * len(axes)
    for rules in (policy.primary_rules(), policy.fallback_rules()):
        for i, name in enumerate(axes):
            if out[i] is not None or name is None or name not in rules:
                continue
            for cand in rules[name]:
                flat = cand if isinstance(cand, tuple) else (cand,)
                if any(a in used for a in flat):
                    continue
                if any(a not in mesh.shape for a in flat):
                    continue
                if shape[i] % _axis_size(mesh, cand) != 0:
                    continue
                out[i] = flat[0] if len(flat) == 1 else cand
                used.update(flat)
                break
    return tuple(out)


def _defs_walk(defs: Dict, fn: Callable, path=()) -> Dict:
    return {k: (_defs_walk(v, fn, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v))
            for k, v in defs.items()}


def param_specs(cfg: ArchConfig, mesh, policy: ShardingPolicy) -> Dict:
    """The reference's spec of every parameter leaf (its
    ``param_shardings``), in the parameter tree's nesting."""
    return _defs_walk(param_defs(cfg), lambda _, d: spec_for(
        d.axes, d.shape, mesh, policy))


# ---------------------------------------------------------------------------
# decode-state logical axes (mirrors models.init_decode_state structure)
# ---------------------------------------------------------------------------

def decode_state_axes(cfg: ArchConfig) -> Dict:
    axes: Dict = {"pos": ()}
    kinds = cfg.block_kinds()
    if any(k == "attn" for k in kinds):
        if cfg.mla is not None:
            axes["cache_k"] = ("layers", "batch", "kv_len", None)
            axes["cache_v"] = ("layers", "batch", "kv_len", None)
        else:
            axes["cache_k"] = ("layers", "batch", "kv_len", "kv_heads", None)
            axes["cache_v"] = ("layers", "batch", "kv_len", "kv_heads", None)
        if cfg.local_window:
            axes["cache_pos"] = ("layers", "batch", "kv_len")
    if any(k == "ssm" for k in kinds):
        axes["conv_state"] = ("layers", "batch", None, "inner")
        axes["ssm_state"] = ("layers", "batch", "inner", None)
    if any(k == "rglru" for k in kinds):
        axes["rg_conv"] = ("layers", "batch", None, "inner")
        axes["rg_h"] = ("layers", "batch", "inner")
    if cfg.family == "encdec":
        axes["cross_k"] = ("layers", "batch", None, "kv_heads", None)
        axes["cross_v"] = ("layers", "batch", None, "kv_heads", None)
    return axes


def decode_state_specs(cfg: ArchConfig, batch: int, max_len: int, mesh,
                       policy: ShardingPolicy) -> Dict:
    """The reference's spec of every decode-state key (its
    ``decode_state_shardings``); ``pos`` is a scalar."""
    axes = decode_state_axes(cfg)
    out = {"pos": ()}
    for k, (shape, _) in decode_state_shapes(cfg, batch, max_len).items():
        out[k] = spec_for(axes[k], shape, mesh, policy)
    return out


# ---------------------------------------------------------------------------
# a rank's cut: the reference's specs with the port's overrides
# ---------------------------------------------------------------------------

def stage_range(n: int, stage: int, stages: int) -> Tuple[int, int]:
    """Layers ``lo .. hi - 1`` of ``n`` that pipeline stage ``stage`` of
    ``stages`` runs (the even cut whenever ``stages`` divides ``n``)."""
    return stage * n // stages, (stage + 1) * n // stages


def rank_spec(path: Tuple[str, ...], axes: Tuple[Optional[str], ...],
              shape: Tuple[int, ...], mesh,
              policy: ShardingPolicy = ShardingPolicy()) -> Spec:
    """The spec a rank holds a leaf by: :func:`spec_for` with the port's
    overrides (the module docstring).  The ``layers`` dim always follows
    the pipeline (a stage holds its own layers, :func:`stage_range`)."""
    names, check = list(axes), list(shape)
    for i, name in enumerate(axes):
        if name == "vocab" or name == "kv_len" or (
                name == "experts" and path[-1] in WHOLE_LEAVES):
            names[i] = None                       # whole on every tp rank
        elif name == "experts":
            check[i] = padded_experts(shape[i])
        elif name == "layers":
            check[i] = 0                          # any number of stages
        elif name == "inner" and path[-2:] == ("ssm", "in_proj"):
            check[i] = shape[i] // 2              # each half on its own
    return spec_for(tuple(names), tuple(check), mesh, policy)


def _cut_dims(path: Tuple[str, ...], axes: Tuple[Optional[str], ...],
              sizes: Dict[str, int], policy: ShardingPolicy,
              shape: Optional[Tuple[int, ...]] = None) -> Dict[str, int]:
    """Mesh axis -> the dim of one leaf it cuts, from :func:`rank_spec`
    (axes of one rank dropped).  Without ``shape`` every cut is taken to
    divide (the engine refuses a plan whose heads or layers do not)."""
    if shape is None:
        shape = (math.prod(sizes.values()),) * len(axes)
    spec = rank_spec(path, axes, shape, _Shape(sizes), policy)
    return {a: i for i, a in enumerate(spec)
            if isinstance(a, str) and sizes.get(a, 1) > 1}


@dataclasses.dataclass(frozen=True)
class _Shape:
    """A mesh's shape alone (all :func:`spec_for` reads)."""
    shape: Dict[str, int]


def rank_specs(cfg: ArchConfig, batch: int, max_len: int, mesh,
               policy: ShardingPolicy = ShardingPolicy()) -> Dict:
    """``{"params": tree, "state": {key: spec}}``: the :func:`rank_spec`
    of every parameter leaf and decode-state key (all dims whole without
    a mesh)."""
    mesh = mesh if mesh is not None else _Shape({})
    params = _defs_walk(param_defs(cfg), lambda path, d: rank_spec(
        path, d.axes, d.shape, mesh, policy))
    axes = decode_state_axes(cfg)
    state = {"pos": ()}
    for k, (shape, _) in decode_state_shapes(cfg, batch, max_len).items():
        state[k] = rank_spec((k,), axes[k], shape, mesh, policy)
    return {"params": params, "state": state}


def _block(n: int, ways: int, index: int) -> Tuple[int, int]:
    return index * (n // ways), n // ways


def shard_leaf(path: Tuple[str, ...], axes: Tuple[Optional[str], ...],
               t: torch.Tensor, mesh, policy: ShardingPolicy = ShardingPolicy(),
               n_layers: Optional[int] = None) -> Optional[torch.Tensor]:
    """One rank's shard of the whole leaf ``t`` at ``path`` with logical
    ``axes``: a contiguous copy, owned by the rank (never a view of
    ``t``); a leaf with no cut comes back as it is, and a leaf of an
    unrolled layer ``layers["l{i}"]`` of a stack of ``n_layers`` that
    another pipeline stage runs as None."""
    pp = mesh.shape.get(policy.pp_axis, 1)
    i = _unrolled_layer(path)
    if pp > 1 and i is not None:
        lo, hi = stage_range(n_layers, mesh.coords[policy.pp_axis], pp)
        if not lo <= i < hi:
            return None
    cuts = _cut_dims(path, axes, mesh.shape, policy, tuple(t.shape))
    if not cuts:
        return t
    for axis, dim in cuts.items():
        ways, index = mesh.shape[axis], mesh.coords[axis]
        if axes[dim] == "layers":
            lo, hi = stage_range(t.shape[dim], index, ways)
            t = t.narrow(dim, lo, hi - lo)
        elif axes[dim] == "experts":
            # the block's experts past E are zeros (the padded leaf itself
            # is never built)
            lo, w = _block(padded_experts(t.shape[dim]), ways, index)
            have = max(0, min(w, t.shape[dim] - lo))
            t = pad_experts(t.narrow(dim, min(lo, t.shape[dim]), have),
                            dim, w)
        elif path[-2:] == ("ssm", "in_proj"):
            half = t.shape[dim] // 2
            lo, w = _block(half, ways, index)
            t = torch.cat([t.narrow(dim, lo, w), t.narrow(dim, half + lo, w)],
                          dim=dim)
        else:
            t = t.narrow(dim, *_block(t.shape[dim], ways, index))
    return t.clone(memory_format=torch.contiguous_format)


def _unrolled_layer(path: Tuple[str, ...]) -> Optional[int]:
    """The index ``i`` of a leaf under ``layers["l{i}"]``, else None."""
    if len(path) > 1 and path[0] == "layers" and path[1][:1] == "l" \
            and path[1][1:].isdigit():
        return int(path[1][1:])
    return None


def _walk(tree: Dict, axes: Dict, fn: Callable, path=()) -> Dict:
    return {k: (_walk(v, axes[k], fn, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), axes[k], v))
            for k, v in tree.items()}


def _prune(tree: Dict) -> Dict:
    """Drop the None leaves (another stage's layers) and emptied dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _prune(v)
            if v:
                out[k] = v
        elif v is not None:
            out[k] = v
    return out


def shard_params(params: Dict, cfg: ArchConfig, mesh,
                 policy: ShardingPolicy = ShardingPolicy()) -> Dict:
    """Cut a whole parameter tree to ``mesh``'s rank."""
    return _prune(_walk(params, logical_axes(cfg),
                        lambda p, ax, t: shard_leaf(p, ax, t, mesh, policy,
                                                    cfg.n_layers)))


def init_shard(cfg: ArchConfig, seed: int, mesh,
               policy: ShardingPolicy = ShardingPolicy(), *, device="cuda",
               dtype: torch.dtype = torch.bfloat16) -> Dict:
    """This rank's shard of ``init_params(cfg, seed)``: every leaf drawn
    whole in ``init_params``' order, cut, and freed before the next, so
    the shard holds the one-device weights and no rank ever holds the
    whole tree."""
    return _prune(init_params(
        cfg, seed, device=device, dtype=dtype,
        keep=lambda p, ax, t: shard_leaf(p, ax, t, mesh, policy,
                                         cfg.n_layers)))


def state_shapes(cfg: ArchConfig, batch: int, max_len: int, mesh,
                 policy: ShardingPolicy = ShardingPolicy(),
                 kv_dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Key -> (this rank's shape, dtype) of the decode state: each whole
    shape cut by :func:`rank_spec`, the ``layers`` dim to the stage's
    layers of the key's kind."""
    axes = decode_state_axes(cfg)
    kinds = cfg.block_kinds()
    pp, stage = (mesh.shape.get(policy.pp_axis, 1),
                 mesh.coords.get(policy.pp_axis, 0))
    lo, hi = stage_range(cfg.n_layers, stage, pp)
    kind_of = {k: kind for kind, keys in (
        ("attn", ("cache_k", "cache_v", "cache_pos")),
        ("ssm", ("conv_state", "ssm_state")),
        ("rglru", ("rg_conv", "rg_h"))) for k in keys}
    out = {}
    for key, (shape, dt) in decode_state_shapes(cfg, batch, max_len,
                                                kv_dtype).items():
        spec = rank_spec((key,), axes[key], shape, mesh, policy)
        local = list(shape)
        for i, a in enumerate(spec):
            if axes[key][i] == "layers":
                local[i] = (kinds[lo:hi].count(kind_of[key])
                            if key in kind_of else hi - lo)
            elif a is not None:
                local[i] = shape[i] // _axis_size(mesh, a)
        out[key] = (tuple(local), dt)
    return out


def init_state_shard(cfg: ArchConfig, batch: int, max_len: int, mesh,
                     policy: ShardingPolicy = ShardingPolicy(), *,
                     kv_dtype: torch.dtype = torch.bfloat16,
                     device="cuda") -> Dict:
    """This rank's decode state (``models.init_decode_state``'s, cut by
    :func:`state_shapes`): zeros, ``cache_pos`` -1, ``pos`` 0."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    state: Dict = {"pos": 0}
    for key, (shape, dt) in state_shapes(cfg, batch, max_len, mesh, policy,
                                         kv_dtype).items():
        state[key] = torch.full(shape, -1 if key == "cache_pos" else 0,
                                dtype=dt, device=dev)
    return state


def local_config(cfg: ArchConfig, tp: int) -> ArchConfig:
    """The config a tensor-parallel rank's attention bodies run: its
    query and KV head counts as the leaves' cut leaves them (a count tp
    does not divide stays whole; the rest of the config is the
    model's)."""
    if tp == 1:
        return cfg
    cut = lambda n: n // tp if n % tp == 0 else n
    return dataclasses.replace(cfg, n_heads=cut(cfg.n_heads),
                               n_kv_heads=cut(cfg.n_kv_heads),
                               head_dim=cfg.head_dim)


__all__ = ["ShardingPolicy", "WHOLE_LEAVES", "decode_state_axes",
           "decode_state_specs", "init_shard", "init_state_shard",
           "local_config", "param_specs", "pp_degree", "rank_spec", "rank_specs",
           "shard_leaf", "shard_params", "spec_for", "stage_range",
           "state_shapes", "tp_degree"]
