"""AdamW with global-norm clipping, cosine schedule and an optional
gradient-compression hook (the PyTorch counterpart of the JAX package's
``optim/adamw.py``).

``init`` / ``update`` work on nested dicts of tensors.  The schedule and
the bias corrections are computed in f32 as the reference computes them.
Where the reference builds new trees, the port updates in place, leaf by
leaf, once the global norm of the whole gradient is known: params, ``mu``
and ``nu`` are overwritten and only one leaf's f32 gradient exists at a
time.  So a fault raised inside ``update`` can leave the state half
updated; the trainer recovers from such a fault only through a
checkpoint.

On a mesh each rank updates its own shard of every leaf.  ``update``
then takes ``shards``: per leaf (in :func:`tree_leaves` order) the
process groups that cut it.  The global norm adds each leaf's square
sum once: the sums of the leaves cut over the same groups are added,
then summed over those groups, and a whole leaf (cut over none) counts
once, as every rank holds the same copy.  A compressor that takes
``groups`` (``compress_int8``) is handed the leaf's, so its scale is
the whole leaf's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, NamedTuple, Optional

import torch


class AdamWState(NamedTuple):
    count: torch.Tensor       # scalar int32
    mu: dict                  # first moment  (f32, like params)
    nu: dict                  # second moment (f32)


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    """Leaves of nested dicts in the reference's order (keys sorted)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


def tree_like(tree: Dict, leaves) -> Dict:
    """Nested dicts shaped like ``tree`` holding ``leaves`` (given in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        out = {k: (build(t[k]) if isinstance(t[k], dict) else next(it))
               for k in sorted(t)}
        return {k: out[k] for k in t}
    return build(tree)


def tree_map(fn, tree: Dict) -> Dict:
    return {k: (tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    #: optional gradient compressor applied per leaf before the moment
    #: update, e.g. ``compress_int8``
    compress: Optional[Callable] = None

    # ------------------------------------------------------------------
    def init(self, params: Dict) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        leaf = next(tree_leaves(params))
        return AdamWState(count=torch.zeros((), dtype=torch.int32,
                                            device=leaf.device),
                          mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """Learning rate at ``step`` (an int32 tensor), in f32."""
        step = step.to(torch.float32)
        warm = torch.clamp(step / max(self.warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - self.warmup_steps)
                           / max(self.total_steps - self.warmup_steps, 1),
                           0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        frac = self.min_lr_frac + (1 - self.min_lr_frac) * cos
        return self.lr * warm * frac

    def _grad32(self, g: torch.Tensor, groups: tuple = ()) -> torch.Tensor:
        g = g.to(torch.float32)
        if self.compress is None:
            return g
        return self.compress(g, groups=groups) if groups else self.compress(g)

    def _global_norm(self, gleaves, shards) -> torch.Tensor:
        """The (compressed) f32 gradient's global norm over every rank's
        shards (see the module docstring); on one device the square sums
        added in leaf order."""
        by_groups: Dict[tuple, torch.Tensor] = {}
        for g, groups in zip(gleaves, shards):
            sq = torch.sum(torch.square(self._grad32(g, groups)))
            by_groups[groups] = (by_groups[groups] + sq if groups in by_groups
                                 else sq)
        total = None
        for groups, sq in by_groups.items():   # one order on every rank
            for group in groups:
                import torch.distributed as dist
                dist.all_reduce(sq, group=group)
            total = sq if total is None else total + sq
        return torch.sqrt(total)

    @torch.no_grad()
    def update(self, grads: Dict, state: AdamWState, params: Dict, *,
               shards: Optional[list] = None):
        """One step, in place: returns (params, state, global grad norm).

        ``grads`` mirrors ``params`` (any float dtype).  The global norm
        is taken over the (compressed) f32 gradient before clipping.
        ``shards`` (on a mesh): per leaf, the tuple of process groups
        that cut it."""
        gleaves = list(tree_leaves(grads))
        groups_of = shards if shards is not None else [()] * len(gleaves)
        gn = self._global_norm(gleaves, groups_of)
        scale = (torch.clamp(self.clip_norm / (gn + 1e-9), max=1.0)
                 if self.clip_norm is not None else None)
        count = state.count + 1
        lr = self.schedule(count)
        b1c = 1 - self.b1 ** count.to(torch.float32)
        b2c = 1 - self.b2 ** count.to(torch.float32)
        for p, m, v, g, groups in zip(tree_leaves(params),
                                      tree_leaves(state.mu),
                                      tree_leaves(state.nu), gleaves,
                                      groups_of):
            g = self._grad32(g, groups)
            if scale is not None:
                g = g * scale
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * torch.square(g))
            del g
            p32 = p.to(torch.float32)
            step = lr * (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            step = step + lr * self.weight_decay * p32
            p.copy_(p32 - step)
        state.count.copy_(count)
        return params, state, gn


def global_norm(tree: Dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def compress_int8(grads, groups: tuple = ()):
    """Simulated int8 gradient compression (per-tensor scale): quantize,
    then dequantize.  Takes one tensor or a nested dict of them.  A shard
    of a leaf cut over ``groups`` (process groups) takes the whole leaf's
    scale: its largest magnitude is the max over those groups."""
    if isinstance(grads, dict):
        return tree_map(lambda g: compress_int8(g, groups), grads)
    gf = grads.to(torch.float32)
    amax = gf.abs().max()
    if groups:
        import torch.distributed as dist
        for group in groups:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale
