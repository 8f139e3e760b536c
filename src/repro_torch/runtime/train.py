"""Training step + fault-tolerant trainer loop on one device (the PyTorch
counterpart of the JAX package's ``runtime/train.py``).

* ``make_train_step`` builds the step: microbatched gradient accumulation
  (a Python loop summing f32 grads, as the reference's scan does),
  per-layer remat, and the optimizer's in-place update.
* ``Trainer`` adds checkpoint cadence with atomic publish, restart from
  the latest checkpoint, per-step retry, and stateless data resumption
  (batch = f(step)).

The reference's step is jit-compiled and sharded over a mesh; this one
runs eagerly on one device and takes no mesh (multi-device training is
ROADMAP queue 1, item 15).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.models import forward, init_params
from repro_torch.optim.adamw import AdamW, tree_leaves, tree_like


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Masked mean token cross-entropy, log-softmax in f32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_loss_fn(cfg: ArchConfig, *, use_flash: bool = False,
                 remat: bool = True, aux_weight: float = 0.01,
                 remat_policy: str = "full") -> Callable:
    def loss_fn(params: Dict, batch: Dict):
        logits, aux = forward(cfg, params, batch["inputs"],
                              use_flash=use_flash, remat=remat,
                              remat_policy=remat_policy)
        loss = cross_entropy(logits, batch["targets"], batch["mask"])
        return loss + aux_weight * aux, {"ce": loss, "aux": aux}
    return loss_fn


def make_train_step(cfg: ArchConfig, opt: AdamW, *, microbatches: int = 1,
                    use_flash: bool = False, remat: bool = True) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.

    The loss and the gradient of the whole step exist before the
    optimizer touches anything: a fault raised up to then leaves params
    and optimizer state as they were.  The update itself is in place
    (``AdamW.update``)."""
    loss_fn = make_loss_fn(cfg, use_flash=use_flash, remat=remat)

    def train_step(params: Dict, opt_state, batch: Dict):
        leaves = list(tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        if microbatches > 1:
            mbatch = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                   + tuple(v.shape[1:]))
                      for k, v in batch.items()}
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in leaves]
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(microbatches):
                loss, _ = loss_fn(params, {k: v[i] for k, v in mbatch.items()})
                grads = torch.autograd.grad(loss, leaves)
                for acc, g in zip(gsum, grads):
                    acc.add_(g)
                lsum = lsum + loss.detach()
                del grads
            grads = [g.div_(microbatches) for g in gsum]
            loss = lsum / microbatches
        else:
            loss, _ = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves)
            loss = loss.detach()
        # a named range, so a profile can tell the optimizer's kernels
        # from the other elementwise work
        with torch.profiler.record_function("optimizer"):
            params, opt_state, gnorm = opt.update(tree_like(params, grads),
                                                  opt_state, params)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": opt.schedule(opt_state.count)}
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
    ``metrics_log`` entries carry the step's host wall time (``step_s``,
    the loss read back included) beside the reference's fields.
    """

    def __init__(self, cfg: ArchConfig, opt: AdamW, data, tc: TrainerConfig,
                 *, use_flash: bool = False,
                 failure_injector: Optional[Callable[[int], None]] = None,
                 device="cuda"):
        self.cfg, self.opt, self.data, self.tc = cfg, opt, data, tc
        self.device = resolve_device(device)
        self.failure_injector = failure_injector
        self.step_fn = make_train_step(cfg, opt,
                                       microbatches=tc.microbatches,
                                       use_flash=use_flash)
        self.ckpt = CheckpointManager(tc.ckpt_dir)
        self.metrics_log = []

    def init_state(self, seed: int = 0):
        params = init_params(self.cfg, seed, device=self.device)
        return params, self.opt.init(params)

    def restore_or_init(self, seed: int = 0):
        params, opt_state = self.init_state(seed)
        start = 0
        if self.ckpt.latest_step() is not None:
            (params, opt_state), start = self.ckpt.restore(
                (params, opt_state))
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
                        (params, opt_state), ck = self.ckpt.restore(
                            (params, opt_state))
                        step = ck + 1
                        batch = self.data.batch(step)
            step_s = time.perf_counter() - t0
            if step % self.tc.log_every == 0 or step == self.tc.total_steps - 1:
                self.metrics_log.append(
                    {"step": step, "loss": loss,
                     "grad_norm": float(metrics["grad_norm"]),
                     "step_s": step_s})
            if (step + 1) % self.tc.ckpt_every == 0:
                self.ckpt.save(step, (params, opt_state))
            step += 1
        return params, opt_state, self.metrics_log
