"""Dry-run cell construction: (architecture × input shape × mesh) → one
rank's step function and its meta-device inputs (the PyTorch
counterpart of the JAX package's ``launch/specs.py``).

The reference builds a jit-able step with ``ShapeDtypeStruct`` inputs
and shardings for XLA to partition; the port's cell is rank 0's step of
the mesh (``launch.mesh.make_production_mesh``), its inputs meta tensors
of rank 0's shard (``runtime.sharding.rank_spec`` of every parameter,
optimizer moment and decode-state leaf, the batch cut over the data
axes), so the step runs on the meta device: its work is counted
(``core.counts``) and nothing is allocated anywhere.  ``use_flash``
defaults to False, as in the reference, so no kernel is needed there.

:func:`input_specs` gives the reference's stand-ins of every model input
(whole, global shapes and the reference's dtypes) on the meta device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.configs.base import ArchConfig, Variant
from repro_torch.core import DistributedForecaster, ShardingPlan, WorkloadModel
from repro_torch.core import hardware
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import act_sharding
from repro_torch.models import model as M
from repro_torch.models.blocks import padded_experts
from repro_torch.models.layers import param_defs
from repro_torch.optim import AdamW
from repro_torch.runtime import sharding as S

#: archs whose attention is full/quadratic — long_500k is skipped for them
#: (assignment: run long-context decode only for SSM/hybrid/linear-attn).
FULL_ATTENTION_ARCHS = {
    "glm4-9b", "llama3-405b", "qwen2-7b", "granite-3-2b", "internvl2-26b",
    "qwen2-moe-a2.7b", "deepseek-moe-16b", "whisper-base",
}

#: the card the dry-run's roofline and LIFE forecast are priced on
HARDWARE = "nvidia-h100"


def cell_is_skipped(arch_name: str, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and arch_name in FULL_ATTENTION_ARCHS:
        return ("sub-quadratic attention required; "
                f"{arch_name} is full-attention (DESIGN.md §5)")
    return None


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str                      # train | prefill | decode
    fn: Callable                   # rank 0's step
    args: Tuple                    # its meta-device inputs
    tokens: int                    # tokens processed per step (MODEL_FLOPS)
    training: bool
    plan: ShardingPlan             # LIFE-distributed plan for prediction
    workload: WorkloadModel
    #: bytes of rank 0's inputs by kind (params, opt_state, state, batch)
    arg_bytes: Dict[str, int]
    #: bytes of the inputs the step updates in place
    alias_bytes: int


def _plan_for(cfg: ArchConfig, mesh, policy: S.ShardingPolicy,
              batch: int) -> ShardingPlan:
    dp = 1
    for a in policy.dp_axes:
        dp *= mesh.shape[a]
    tp = mesh.shape.get(policy.tp_axis, 1)
    return ShardingPlan(dp=dp, tp=tp,
                        ep=tp if cfg.family == "moe" else 1,
                        fsdp=policy.fsdp)


def _batch_struct(cfg: ArchConfig, batch: int, seq: int) -> Dict:
    data = SyntheticTokens(cfg, DataConfig(global_batch=batch, seq_len=seq),
                           device="cpu")
    return data.abstract_batch()


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


# ---------------------------------------------------------------------------
# input_specs — the public stand-in builder (required API)
# ---------------------------------------------------------------------------

def input_specs(arch_name: str, shape_name: str) -> Dict:
    """Meta-device stand-ins for every model input of this cell (the
    reference's shapes and dtypes, whole)."""
    cfg = configs.get(arch_name)
    seq, batch, kind = configs.SHAPES[shape_name]
    if kind == "train":
        return _batch_struct(cfg, batch, seq)
    if kind == "prefill":
        out: Dict = {}
        n_text = seq
        if cfg.family == "vlm":
            n_text = seq - cfg.vision_prefix_len
            out["vision_embeds"] = _meta(
                (batch, cfg.vision_prefix_len, cfg.d_model), torch.bfloat16)
        if cfg.family == "encdec":
            out["frames"] = _meta((batch, cfg.encoder_len, cfg.d_model),
                                  torch.bfloat16)
        out["tokens"] = _meta((batch, n_text), torch.int32)
        return out
    # decode: one new token against a seq-length cache
    return {"tokens": _meta((batch, 1), torch.int32)}


# ---------------------------------------------------------------------------
# rank 0's shard on the meta device
# ---------------------------------------------------------------------------

def _local(shape, spec, mesh, axes=None) -> Tuple[int, ...]:
    """A leaf's shape on the rank: each cut dim divided by its mesh
    axes' size (padded experts first padded)."""
    out = []
    for i, (n, a) in enumerate(zip(shape, spec)):
        if a is None:
            out.append(n)
            continue
        flat = a if isinstance(a, tuple) else (a,)
        ways = 1
        for x in flat:
            ways *= mesh.shape.get(x, 1)
        if axes is not None and axes[i] == "experts":
            n = padded_experts(n)
        out.append(n // ways)
    return tuple(out)


def rank_params(cfg: ArchConfig, mesh, policy: S.ShardingPolicy,
                dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Rank 0's shard of :func:`models.abstract_params` on ``mesh``."""
    def walk(defs, path=()):
        out = {}
        for k, d in defs.items():
            if isinstance(d, dict):
                out[k] = walk(d, path + (k,))
                continue
            spec = S.rank_spec(path + (k,), d.axes, d.shape, mesh, policy)
            out[k] = _meta(_local(d.shape, spec, mesh, d.axes),
                           d.dtype or dtype)
        return out
    return walk(param_defs(cfg))


def rank_decode_state(cfg: ArchConfig, batch: int, seq: int, mesh,
                      policy: S.ShardingPolicy,
                      kv_dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Rank 0's shard of :func:`models.abstract_decode_state`."""
    state: Dict = {"pos": 0}
    for key, (shape, dt) in S.state_shapes(cfg, batch, seq, mesh, policy,
                                           kv_dtype).items():
        state[key] = _meta(shape, dt)
    return state


def _rows(batch: int, mesh, policy: S.ShardingPolicy) -> int:
    """Rank 0's rows of a serving batch: cut over the data axes when
    they divide it (``spec_for``'s rule), else whole."""
    ways = S.dp_ways(mesh, policy)
    return batch // ways if batch % ways == 0 else batch


# ---------------------------------------------------------------------------
# cell builders
# ---------------------------------------------------------------------------

def build_cell(arch_name: str, shape_name: str, mesh, *,
               kv_dtype: torch.dtype = torch.bfloat16,
               use_flash: bool = False, microbatches: int = 1,
               remat: bool = True, remat_policy: str = "full",
               policy: Optional[S.ShardingPolicy] = None,
               cfg: Optional[ArchConfig] = None) -> Cell:
    """Rank 0's step of one cell on ``mesh`` (``cfg`` overrides the
    registry's config, e.g. a reduced one)."""
    cfg = cfg or configs.get(arch_name)
    seq, batch, kind = configs.SHAPES[shape_name]
    policy = policy or S.policy_for(cfg, mesh, batch=batch)
    plan = _plan_for(cfg, mesh, policy, batch)
    # the cell's analytical twin is sharded like the mesh
    wm = WorkloadModel(cfg, Variant(), plan=plan)
    act_sharding.set_mesh(mesh, policy.dp_axes, policy.tp_axis)
    if kind == "train":
        return _train_cell(cfg, arch_name, shape_name, seq, batch, mesh,
                           policy, plan, wm, use_flash, microbatches, remat,
                           remat_policy)
    return _serve_cell(cfg, arch_name, shape_name, kind, seq, batch, mesh,
                       policy, plan, wm, kv_dtype)


def _train_cell(cfg, arch, shape, seq, batch, mesh, policy, plan, wm,
                use_flash, microbatches, remat, remat_policy="full") -> Cell:
    from repro_torch.runtime.train import make_train_step
    opt = AdamW()
    step = make_train_step(cfg, opt, mesh, policy,
                           microbatches=microbatches, use_flash=use_flash,
                           remat=remat, remat_policy=remat_policy)
    params = rank_params(cfg, mesh, policy)
    opt_state = opt.init(params)
    batch_abs = _batch_struct(cfg, batch, seq)
    arg_bytes = {"params": _nbytes(params), "opt_state": _nbytes(opt_state),
                 "batch": _nbytes(S.shard_batch(batch_abs, mesh, policy))}
    return Cell(arch=arch, shape=shape, kind="train", fn=step,
                args=(params, opt_state, batch_abs), tokens=batch * seq,
                training=True, plan=plan, workload=wm, arg_bytes=arg_bytes,
                alias_bytes=arg_bytes["params"] + arg_bytes["opt_state"])


def _serve_cell(cfg, arch, shape, kind, seq, batch, mesh, policy, plan, wm,
                kv_dtype) -> Cell:
    rows = _rows(batch, mesh, policy)
    state = rank_decode_state(cfg, batch, seq, mesh, policy, kv_dtype)
    if kind == "decode":
        state["pos"] = seq - 1          # one new token after seq - 1
        tokens = _meta((rows, 1), torch.int32)
        extra: Dict = {}
    else:
        n_text = seq - (cfg.vision_prefix_len if cfg.family == "vlm" else 0)
        tokens = _meta((rows, n_text), torch.int32)
        extra = {}
        if cfg.family == "vlm":
            extra["vision_embeds"] = _meta(
                (rows, cfg.vision_prefix_len, cfg.d_model), torch.bfloat16)
        if cfg.family == "encdec":
            extra["frames"] = _meta((rows, cfg.encoder_len, cfg.d_model),
                                    torch.bfloat16)
    params = rank_params(cfg, mesh, policy)

    def serve_step(params, state, tokens, extra):
        return M.step(cfg, params, tokens, state, **extra)

    arg_bytes = {"params": _nbytes(params), "state": _nbytes(state),
                 "batch": _nbytes((tokens, extra))}
    return Cell(arch=arch, shape=shape, kind=kind, fn=serve_step,
                args=(params, state, tokens, extra),
                tokens=batch * (seq if kind == "prefill" else 1),
                training=False, plan=plan, workload=wm, arg_bytes=arg_bytes,
                alias_bytes=arg_bytes["state"])


# ---------------------------------------------------------------------------
# LIFE analytical prediction for a cell (forecast-before-run)
# ---------------------------------------------------------------------------

def life_prediction(cell: Cell, hw=HARDWARE) -> Dict:
    """LIFE-predicted roofline terms for one cell, priced on ``hw`` (the
    port's card; the reference prices its TPU): ``cell.workload``
    already folds the plan in (per-chip ops/bytes + collective wire);
    ``DistributedForecaster`` adds the replica-axis (dp/fsdp) gradient
    and param-gather traffic that inference forecasts never see."""
    seq, batch, kind = configs.SHAPES[cell.shape]
    df = DistributedForecaster(cell.workload, cell.plan, hardware.get(hw))
    if kind == "train":
        terms = df.predict_train_step(batch, seq)
    elif kind == "prefill":
        terms = df.predict_prefill(batch, seq)
    else:
        terms = df.predict_decode(batch, seq - 1)
    return {"t_compute": terms.t_compute, "t_memory": terms.t_memory,
            "t_collective": terms.t_collective, "dominant": terms.dominant,
            "hardware": hardware.get(hw).name}


__all__ = ["Cell", "FULL_ATTENTION_ARCHS", "HARDWARE", "build_cell",
           "cell_is_skipped", "input_specs", "life_prediction",
           "rank_decode_state", "rank_params"]
