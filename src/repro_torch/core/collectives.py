"""The port's collectives: every one it issues goes through
:func:`all_reduce` or :func:`broadcast`, which report it to an active
work count (:mod:`repro_torch.core.counts`) and then issue it on
``torch.distributed``.  With no count active, each costs the caller one
``None`` check before the ``torch.distributed`` call.

A :class:`CountedGroup` stands for a group of ranks that were never
spawned (the dry-run's ``launch.mesh.make_production_mesh``): under a
count, a collective over it is counted and moves nothing (on meta
tensors the result is a tensor of the output's shape).  It is used only
under a count; outside one it is not a process group.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core import counts as _counts


@dataclasses.dataclass(frozen=True)
class CountedGroup:
    """A group of ``size`` ranks whose collectives are counted and move
    nothing (see the module docstring)."""
    size: int


def group_size(group) -> int:
    """Ranks in ``group`` (a process group or a :class:`CountedGroup`;
    None is the default group)."""
    if isinstance(group, CountedGroup):
        return group.size
    return dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group=None, op=None) -> torch.Tensor:
    """``dist.all_reduce`` of ``x`` in place over ``group`` (a sum unless
    ``op`` is given), reported to an active work count; over a
    :class:`CountedGroup`, counted only.  Returns ``x``."""
    if _counts.ACTIVE is not None:
        _counts.report_collective("all-reduce", x, group_size(group))
        if isinstance(group, CountedGroup):
            return x
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    return x


def broadcast(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``dist.broadcast`` of ``x`` in place from global rank ``src`` over
    ``group``, reported to an active work count as the point-to-point
    transfer it is (``collective-permute``: the result's bytes on the
    wire); over a :class:`CountedGroup`, counted only."""
    if _counts.ACTIVE is not None:
        _counts.report_collective("collective-permute", x,
                                  group_size(group))
        if isinstance(group, CountedGroup):
            return x
    dist.broadcast(x, src=src, group=group)
    return x


__all__ = ["CountedGroup", "all_reduce", "broadcast", "group_size"]
