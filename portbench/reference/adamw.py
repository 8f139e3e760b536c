"""AdamW as the configuration states it: clipping by the global norm,
bias-corrected moments in float32, decoupled weight decay, a linear
warm-up to the peak rate and a cosine decay to ``min_lr_frac`` of it.
Parameters are stored in the configuration's type (bf16) after each
update; the update itself is computed in float32."""
from __future__ import annotations

import math
from typing import Dict

import torch


def learning_rate(t: Dict, step: int) -> float:
    """The rate of update ``step`` (1 for the first)."""
    warm = min(step / max(t["warmup_steps"], 1), 1.0)
    span = max(t["total_steps"] - t["warmup_steps"], 1)
    prog = min(max((step - t["warmup_steps"]) / span, 0.0), 1.0)
    frac = t["min_lr_frac"] + (1 - t["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return t["lr"] * warm * frac


class AdamW:
    """Moments for every leaf of a flat tree (path -> tensor)."""

    def __init__(self, t: Dict, params: Dict):
        self.t = t
        self.step = 0
        self.m = {p: torch.zeros(v.shape, dtype=torch.float32,
                                 device=v.device) for p, v in params.items()}
        self.v = {p: torch.zeros_like(m) for p, m in self.m.items()}

    @torch.no_grad()
    def update(self, params: Dict, grads: Dict) -> Dict:
        """Update ``params`` (stored type kept) from f32 ``grads``;
        returns each leaf's norm of the gradient before clipping."""
        t = self.t
        self.step += 1
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in grads.values()))
        scale = min(1.0, t["clip_norm"] / (norm + 1e-9)) if t.get(
            "clip_norm") else 1.0
        lr = learning_rate(t, self.step)
        b1c = 1 - t["b1"] ** self.step
        b2c = 1 - t["b2"] ** self.step
        taken = {}
        for p, w in params.items():
            g = grads[p] * scale
            taken[p] = float(grads[p].double().norm())
            self.m[p].mul_(t["b1"]).add_(g, alpha=1 - t["b1"])
            self.v[p].mul_(t["b2"]).addcmul_(g, g, value=1 - t["b2"])
            w32 = w.float()
            new = w32 - lr * ((self.m[p] / b1c)
                              / ((self.v[p] / b2c).sqrt() + t["eps"])
                              + t["weight_decay"] * w32)
            w.copy_(new.to(w.dtype))
        return taken
