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

* ``embed`` and ``lm_head`` stay whole over the tensor-parallel axis
  (the reference shards ``vocab``), so every rank computes the same
  logits with no all-gather, which gloo cannot do on CUDA tensors; under
  FSDP their ``embed`` dim is still cut over the data axes, as every
  other leaf's is, and gathered whole where it is used
  (``models.act_sharding.fsdp_gather``);
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
  stack the entries of its layers of that kind;
* a training batch's rows are cut over the data axes only: the tp ranks
  of a replica see the same rows with ``seq`` whole, where the
  reference's ``seq_shard`` would cut ``seq`` over ``"model"``, and a
  row count the data axes do not divide is refused, where the
  reference would hold the rows whole on every replica
  (:func:`shard_batch`).

A decode state is cut by :func:`init_state_shard`, which builds each
key's rank-sized zeros from the whole shape and the spec.

A training batch: :func:`batch_specs` gives the reference's spec of
every field (its ``batch_shardings``), and :func:`shard_batch` cuts a
rank's rows of it (the last override above: a rank's attention needs
every position of its rows).  :func:`opt_state_specs`
mirrors the params' specs for AdamW's moments, and
:func:`param_cuts` / :func:`fsdp_dims` tell the trainer, the optimizer
and the checkpoints which mesh axis cuts which dim of each leaf.
:func:`unshard_leaf` is :func:`shard_leaf`'s inverse over a mesh.
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
            continue
        # the block's experts past E are zeros (the padded leaf itself is
        # never built)
        pieces, width = _pieces(path, axes, dim, t.shape[dim], ways, index)
        parts = [t.narrow(dim, g, w) for _, g, w in pieces]
        t = pad_experts(parts[0] if len(parts) == 1 else torch.cat(
            parts or [t.narrow(dim, 0, 0)], dim=dim), dim, width)
    return t.clone(memory_format=torch.contiguous_format)


def _pieces(path: Tuple[str, ...], axes: Tuple[Optional[str], ...],
            dim: int, n: int, ways: int, index: int):
    """Where rank ``index`` of ``ways`` finds its cut of a leaf's dim
    ``dim`` of whole size ``n``: ``([(start in the shard, start in the
    whole leaf, width), ...], the shard's width)``.  Padded experts: the
    block of ``padded_experts(n)`` (its experts past E are zeros, absent
    from the whole leaf); Mamba's ``in_proj``: the rank's block of each
    half; otherwise the contiguous block."""
    if axes[dim] == "experts":
        lo, w = _block(padded_experts(n), ways, index)
        have = max(0, min(w, n - lo))
        return ([(0, lo, have)] if have else []), w
    if axes[dim] == "inner" and path[-2:] == ("ssm", "in_proj"):
        lo, w = _block(n // 2, ways, index)
        return [(0, lo, w), (w, n // 2 + lo, w)], 2 * w
    lo, w = _block(n, ways, index)
    return [(0, lo, w)], w


def unshard_leaf(path: Tuple[str, ...], axes: Tuple[Optional[str], ...],
                 t: torch.Tensor, whole: Tuple[int, ...], mesh,
                 policy: ShardingPolicy = ShardingPolicy()) -> torch.Tensor:
    """The whole leaf (shape ``whole``) of this rank's shard ``t``, on
    every rank: per cut axis, each rank writes its pieces into a zero
    buffer of the whole width and one ``all_reduce`` over the axis's
    group sums them (exact).  A leaf with no cut comes back as it is.
    Refuses a pipeline cut (a stage holds only its own layers)."""
    import torch.distributed as dist
    cuts = _cut_dims(path, axes, mesh.shape, policy, tuple(whole))
    for axis, dim in cuts.items():
        if axes[dim] == "layers":
            raise NotImplementedError(
                "unshard_leaf: a leaf cut over pipeline stages")
        pieces, _ = _pieces(path, axes, dim, whole[dim], mesh.shape[axis],
                            mesh.coords[axis])
        shape = list(t.shape)
        shape[dim] = whole[dim]
        full = t.new_zeros(shape)
        for local, start, w in pieces:
            full.narrow(dim, start, w).copy_(t.narrow(dim, local, w))
        dist.all_reduce(full, group=mesh.groups[axis])
        t = full
    return t


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


# ---------------------------------------------------------------------------
# training on a mesh: batches, optimizer state, the cuts of each leaf
# ---------------------------------------------------------------------------

#: logical axes of a training batch's fields (the reference's
#: ``batch_shardings``); another field is ("batch", None, ...)
BATCH_FIELD_AXES = {
    "inputs": ("batch", "seq"), "targets": ("batch", "seq"),
    "mask": ("batch", "seq"), "tokens": ("batch", "seq"),
    "frames": ("batch", None, None),
    "vision_embeds": ("batch", None, None),
}


def batch_specs(cfg: ArchConfig, mesh, policy: ShardingPolicy,
                batch_struct: Dict) -> Dict:
    """The reference's spec of every field of a data batch (its
    ``batch_shardings``); ``batch_struct`` maps a field to anything with
    a ``shape``."""
    out = {}
    for k, v in batch_struct.items():
        shape = tuple(v.shape)
        ax = BATCH_FIELD_AXES.get(k, ("batch",) + (None,) * (len(shape) - 1))
        out[k] = spec_for(ax[:len(shape)], shape, mesh, policy)
    return out


def policy_for(cfg: ArchConfig, mesh, *, shape_kind: str = "train",
               batch: int = 0) -> ShardingPolicy:
    """Default policy per arch size and scenario (the baseline plan; the
    reference's, copied).

    * FSDP for ≥30B-param archs (params won't fit replicated per-DP-group).
    * Sequence sharding when the batch can't cover the DP axes (long ctx).
    """
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    big = cfg.param_count() > 30e9
    dp_size = 1
    for a in dp_axes:
        dp_size *= mesh.shape[a]
    seq_shard = batch > 0 and batch < dp_size
    return ShardingPolicy(dp_axes=dp_axes, fsdp=big, seq_shard=seq_shard)


def opt_state_specs(param_specs: Dict):
    """AdamW's state specs (the reference's ``dataclass_opt_shardings``):
    ``mu`` and ``nu`` mirror the params', ``count`` is a whole scalar."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(count=(), mu=param_specs, nu=param_specs)


def dp_ways(mesh, policy: ShardingPolicy) -> int:
    """Data-parallel ways of a mesh under the policy (1 without one)."""
    if mesh is None:
        return 1
    return math.prod(mesh.shape.get(a, 1) for a in policy.dp_axes)


def dp_index(mesh, policy: ShardingPolicy) -> int:
    """This rank's index over the data axes, the first the slowest."""
    i = 0
    for a in policy.dp_axes:
        if a in mesh.shape:
            i = i * mesh.shape[a] + mesh.coords[a]
    return i


def shard_batch(batch: Dict, mesh, policy: ShardingPolicy) -> Dict:
    """This rank's rows of a global batch: its contiguous block of the
    rows over the data axes (every tp rank of a replica the same rows,
    ``seq`` whole).  Refuses a row count the data axes do not divide:
    the reference would then hold the rows whole on every replica."""
    ways = dp_ways(mesh, policy)
    if ways == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.shape[0] % ways:
            raise ValueError(f"shard_batch: {k} has {v.shape[0]} rows, "
                             f"not a multiple of the {ways} data-parallel "
                             f"ranks")
        w = v.shape[0] // ways
        out[k] = v.narrow(0, dp_index(mesh, policy) * w, w)
    return out


def param_cuts(cfg: ArchConfig, mesh,
               policy: ShardingPolicy = ShardingPolicy()) -> Dict:
    """Per parameter leaf, the tuple of mesh axes that cut it on this
    rank (:func:`rank_spec`'s cuts; axes of one rank left out), in the
    parameter tree's nesting."""
    return _defs_walk(param_defs(cfg), lambda path, d: tuple(_cut_dims(
        path, d.axes, mesh.shape, policy, d.shape)))


def fsdp_dims(cfg: ArchConfig, mesh,
              policy: ShardingPolicy = ShardingPolicy()) -> Optional[Dict]:
    """Per parameter leaf, the whole leaf's dim cut over the data axis
    (FSDP's ``embed``), or None where the leaf is whole over it; None
    without FSDP or a data axis of more than one rank."""
    if not policy.fsdp or dp_ways(mesh, policy) == 1:
        return None
    return _defs_walk(param_defs(cfg), lambda path, d: _cut_dims(
        path, d.axes, mesh.shape, policy, d.shape).get("data"))


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


__all__ = ["BATCH_FIELD_AXES", "ShardingPolicy", "WHOLE_LEAVES",
           "batch_specs", "decode_state_axes", "decode_state_specs",
           "dp_index", "dp_ways", "fsdp_dims", "init_shard",
           "init_state_shard", "local_config", "opt_state_specs",
           "param_cuts", "param_specs", "policy_for", "pp_degree",
           "rank_spec", "rank_specs", "shard_batch", "shard_leaf",
           "shard_params", "spec_for", "stage_range", "state_shapes",
           "tp_degree", "unshard_leaf"]
