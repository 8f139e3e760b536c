"""Training step + fault-tolerant trainer loop, on one device or on a
mesh of ranks (the PyTorch counterpart of the JAX package's
``runtime/train.py``).

* ``make_train_step`` builds the step: microbatched gradient accumulation
  (a Python loop summing f32 grads, as the reference's scan does),
  per-layer remat, and the optimizer's in-place update.
* ``Trainer`` adds checkpoint cadence with atomic publish, restart from
  the latest checkpoint, per-step retry, and stateless data resumption
  (batch = f(step)).

The reference's step is jit-compiled and GSPMD shards it over a mesh;
this one runs eagerly, on one device without a mesh, and with a
``launch.mesh.Mesh`` of ``data × model`` ranks as one rank's part of the
same arithmetic: the rank holds its shard of params and optimizer state
(``runtime.sharding``: ``vocab``, heads, ``mlp``, ``inner`` and experts
over ``"model"``; FSDP's ``embed`` over ``"data"``), takes its rows of
each global microbatch, normalises its loss by the global microbatch's
mask count, and sums over the data-parallel group the gradient of every
leaf that group does not cut (FSDP's leaves are summed by their gathers'
backward).  Tensor-parallel ranks run Megatron's *f*/*g* pairs
(``models.act_sharding``), so a whole leaf gets the same whole gradient
on every rank, and the loss over a cut vocabulary is the vocab-parallel
cross-entropy (:func:`cross_entropy`).  A mesh with a ``pipe`` axis is
refused: the reference trains on no pipeline axis either (its
``launch/specs.py`` train cell runs on the ``("data", "model")`` mesh).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.core.collectives import all_reduce
from repro_torch.models import act_sharding, forward, init_params
from repro_torch.optim.adamw import AdamW, tree_leaves, tree_like
from repro_torch.runtime import sharding as S


class _VocabParallelLogLik(torch.autograd.Function):
    """Each token's log-likelihood of its target from logits whose last
    dim is this tp rank's block of the vocabulary (Megatron-LM's
    vocab-parallel cross-entropy, in f32): the row max, the sum of
    exponentials and the target's logit (from the rank that holds it)
    are each one ``all_reduce`` over the tp group.  The backward is the
    rank's own: its block of (one-hot − softmax)."""

    @staticmethod
    def forward(ctx, logits, targets, group):
        held = logits.shape[-1]
        x = logits.to(torch.float32)
        m = x.amax(dim=-1)
        all_reduce(m, group, op=dist.ReduceOp.MAX)
        x = x - m[..., None]
        e = torch.exp(x)
        total = all_reduce(e.sum(dim=-1), group)
        local = targets.long() - act_sharding.tp_rank() * held
        outside = (local < 0) | (local >= held)
        local = local.masked_fill(outside, 0)
        xt = all_reduce(x.gather(-1, local[..., None])[..., 0]
                        .masked_fill(outside, 0.0), group)
        ctx.save_for_backward(e.div_(total[..., None]), local, outside)
        ctx.dtype = logits.dtype
        return xt - torch.log(total)

    @staticmethod
    def backward(ctx, dll):
        p, local, outside = ctx.saved_tensors
        onehot = torch.zeros_like(p).scatter_(
            -1, local[..., None], (~outside)[..., None].to(p.dtype))
        return (dll[..., None] * (onehot - p)).to(ctx.dtype), None, None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor,
                  count: Optional[torch.Tensor] = None,
                  vocab: Optional[int] = None) -> torch.Tensor:
    """Masked mean token cross-entropy, log-softmax in f32.  ``count``:
    the tokens to divide by (a data-parallel rank's rows are part of a
    larger batch); the mask's own sum by default.  ``vocab``: the whole
    vocabulary's size when ``logits`` may be a tp rank's block of it
    (None: they are whole); the loss is then the vocab-parallel one,
    equal on every rank of the group."""
    if vocab is not None and logits.shape[-1] < vocab:
        ll = _VocabParallelLogLik.apply(logits, targets,
                                        act_sharding.tp_group())
    else:
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if count is None:
        count = mask.sum()
    return -(ll * mask).sum() / torch.clamp(count, min=1.0)


#: weight of the MoE load-balance aux loss in the training loss
AUX_WEIGHT = 0.01


def make_loss_fn(cfg: ArchConfig, *, use_flash: bool = False,
                 remat: bool = True, aux_weight: float = AUX_WEIGHT,
                 remat_policy: str = "full") -> Callable:
    def loss_fn(params: Dict, batch: Dict,
                count: Optional[torch.Tensor] = None):
        ve = batch.get("vision_embeds")
        logits, aux = forward(cfg, params, batch["inputs"],
                              vision_embeds=ve, frames=batch.get("frames"),
                              use_flash=use_flash, remat=remat,
                              remat_policy=remat_policy)
        if cfg.family == "vlm" and ve is not None:
            logits = logits[:, ve.shape[1]:]       # the text positions
        loss = cross_entropy(logits, batch["targets"], batch["mask"], count,
                             cfg.vocab_size)
        return loss + aux_weight * aux, {"ce": loss, "aux": aux}
    return loss_fn


def _sum_over(tensors: list, group) -> None:
    """Sum ``tensors`` over ``group`` in place, as one flat buffer per
    dtype (one ``all_reduce`` each instead of one per leaf)."""
    by_dtype: Dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce(flat, group)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def make_train_step(cfg: ArchConfig, opt: AdamW, mesh=None,
                    policy: Optional[S.ShardingPolicy] = None, *,
                    microbatches: int = 1, use_flash: bool = False,
                    remat: bool = True,
                    remat_policy: str = "full") -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.

    The loss and the gradient of the whole step exist before the
    optimizer touches anything: a fault raised up to then leaves params
    and optimizer state as they were.  The update itself is in place
    (``AdamW.update``).  ``metrics`` holds the reference's ``loss``
    (cross-entropy plus 0.01 × the MoE aux loss), ``grad_norm`` and
    ``lr``, and the aux loss itself under ``aux`` (the microbatches'
    mean; 0 for dense stacks).

    With a ``mesh`` (``launch.mesh.Mesh``; ``policy`` defaults to
    ``ShardingPolicy()``) ``params`` and ``opt_state`` are this rank's
    shard (``runtime.sharding.init_shard``, ``AdamW.init`` of it) and
    ``batch`` is the global batch, as the reference's step takes it.
    Microbatch ``i`` is the reference's contiguous block ``i`` of the
    global rows, and each data-parallel rank takes its block of that
    (:func:`runtime.sharding.shard_batch`); the metrics are the global
    ones, equal on every rank."""
    policy = policy or S.ShardingPolicy()
    if mesh is not None and mesh.shape.get(policy.pp_axis, 1) > 1:
        raise NotImplementedError(
            "training on a mesh with a pipe axis (pipeline-parallel "
            "training) is refused: the reference trains on no pipe "
            "axis either")
    loss_fn = make_loss_fn(cfg, use_flash=use_flash, remat=remat,
                           remat_policy=remat_policy)
    dp = S.dp_ways(mesh, policy)
    if dp > 1 and cfg.family == "moe":
        from repro_torch.models import blocks
        if blocks.MOE_DISPATCH == "global":
            raise NotImplementedError(
                "MoE 'global' dispatch over data-parallel ranks: its "
                "capacity counts the global batch's tokens")
    fsdp = S.fsdp_dims(cfg, mesh, policy) if mesh is not None else None
    shards, dp_leaves = None, []
    if mesh is not None:
        leaf_cuts = list(tree_leaves(S.param_cuts(cfg, mesh, policy)))
        shards = [tuple(mesh.groups[a] for a in c) for c in leaf_cuts]
        # leaves the data axis does not cut: their gradient is summed
        # over the data-parallel group after the backward
        dp_leaves = [i for i, c in enumerate(leaf_cuts)
                     if dp > 1 and "data" not in c]

    def train_step(params: Dict, opt_state, batch: Dict):
        act_sharding.set_mesh(mesh, policy.dp_axes, policy.tp_axis, fsdp)
        leaves = list(tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        rows = next(iter(batch.values())).shape[0]
        if rows % microbatches:
            raise ValueError(f"{rows} rows in {microbatches} microbatches")
        m_rows = rows // microbatches
        accumulate = microbatches > 1
        gsum = ([torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves] if accumulate else None)
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        asum = torch.zeros_like(lsum)
        for i in range(microbatches):
            mb = ({k: v.narrow(0, i * m_rows, m_rows)
                   for k, v in batch.items()} if accumulate else batch)
            # the global microbatch's token count: every rank's divisor
            count = mb["mask"].sum() if mesh is not None else None
            loss, parts = loss_fn(params, S.shard_batch(mb, mesh, policy)
                                  if mesh is not None else mb, count)
            grads = torch.autograd.grad(loss, leaves)
            if accumulate:
                for acc, g in zip(gsum, grads):
                    acc.add_(g)
                del grads
            ce, aux = parts["ce"].detach(), parts["aux"].detach()
            if dp > 1:
                # the global loss: the ranks' shares of the cross-entropy
                # summed, the (global) aux once
                ce = act_sharding.dp_all_reduce(ce.clone())
                loss = ce + AUX_WEIGHT * aux
            lsum = lsum + loss.detach()
            asum = asum + aux
        if accumulate:
            grads = [g.div_(microbatches) for g in gsum]
            loss, aux = lsum / microbatches, asum / microbatches
        else:
            grads = list(grads)
            loss, aux = lsum, asum
        if dp_leaves:
            _sum_over([grads[i] for i in dp_leaves], mesh.groups["data"])
        # a named range, so a profile can tell the optimizer's kernels
        # from the other elementwise work
        with torch.profiler.record_function("optimizer"):
            params, opt_state, gnorm = opt.update(tree_like(params, grads),
                                                  opt_state, params,
                                                  shards=shards)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": opt.schedule(opt_state.count), "aux": aux}
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# fault-tolerant trainer loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    max_step_retries: int = 2      # straggler/preemption mitigation
    microbatches: int = 1


class Trainer:
    """Checkpoint/restart trainer with per-step retry.

    A step that raises (device OOM, a preemption injected by tests) is
    retried up to ``max_step_retries`` times.  A fault before the
    optimizer's update leaves the live params intact; when a checkpoint
    exists, the retry restarts from it (as the reference does), which is
    also the only recovery from a fault inside the in-place update.
    ``metrics_log`` entries carry the MoE aux loss (``aux``) and the
    step's host wall time (``step_s``, the loss read back included)
    beside the reference's fields.

    With a ``mesh`` (and ``policy``, ``ShardingPolicy()`` by default)
    this is one rank of the run: it draws its shard
    (``runtime.sharding.init_shard``), trains through the mesh's step on
    ``mesh.device`` (``device`` is not read), saves whole leaves in the
    reference's layout (``CheckpointManager.save`` with the mesh) and
    restores through ``restore_sharded``, so a run may resume on another
    mesh shape.  Every rank runs the failure injector and retries alike.
    """

    def __init__(self, cfg: ArchConfig, opt: AdamW, data, tc: TrainerConfig,
                 *, use_flash: bool = False,
                 failure_injector: Optional[Callable[[int], None]] = None,
                 device="cuda", mesh=None,
                 policy: Optional[S.ShardingPolicy] = None):
        self.cfg, self.opt, self.data, self.tc = cfg, opt, data, tc
        self.mesh, self.policy = mesh, policy or S.ShardingPolicy()
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        self.failure_injector = failure_injector
        self.step_fn = make_train_step(cfg, opt, mesh, self.policy,
                                       microbatches=tc.microbatches,
                                       use_flash=use_flash)
        self.ckpt = CheckpointManager(tc.ckpt_dir)
        self.metrics_log = []

    def init_state(self, seed: int = 0):
        if self.mesh is None:
            params = init_params(self.cfg, seed, device=self.device)
        else:
            params = S.init_shard(self.cfg, seed, self.mesh, self.policy,
                                  device=self.device)
        return params, self.opt.init(params)

    def _restore(self, example):
        if self.mesh is None:
            return self.ckpt.restore(example)
        return self.ckpt.restore_sharded(example, self.mesh, self.policy,
                                         cfg=self.cfg)

    def _save(self, step: int, tree) -> None:
        if self.mesh is None:
            self.ckpt.save(step, tree)
        else:
            self.ckpt.save(step, tree, mesh=self.mesh, policy=self.policy,
                           cfg=self.cfg)

    def restore_or_init(self, seed: int = 0):
        params, opt_state = self.init_state(seed)
        start = 0
        if self.ckpt.latest_step() is not None:
            (params, opt_state), start = self._restore((params, opt_state))
            start += 1
        return params, opt_state, start

    def run(self, seed: int = 0):
        params, opt_state, start = self.restore_or_init(seed)
        step = start
        while step < self.tc.total_steps:
            batch = self.data.batch(step)      # stateless: resumable
            attempt = 0
            while True:
                t0 = time.perf_counter()
                try:
                    if self.failure_injector is not None:
                        self.failure_injector(step)
                    params, opt_state, metrics = self.step_fn(
                        params, opt_state, batch)
                    loss = float(metrics["loss"])     # waits for the step
                    break
                except Exception:
                    attempt += 1
                    if attempt > self.tc.max_step_retries:
                        raise
                    # recover from the last durable state
                    if self.ckpt.latest_step() is not None:
                        (params, opt_state), ck = self._restore(
                            (params, opt_state))
                        step = ck + 1
                        batch = self.data.batch(step)
            step_s = time.perf_counter() - t0
            if step % self.tc.log_every == 0 or step == self.tc.total_steps - 1:
                self.metrics_log.append(
                    {"step": step, "loss": loss,
                     "grad_norm": float(metrics["grad_norm"]),
                     "aux": float(metrics["aux"]), "step_s": step_s})
            if (step + 1) % self.tc.ckpt_every == 0:
                self._save(step, (params, opt_state))
            step += 1
        return params, opt_state, self.metrics_log
