"""The port's collectives: every one it issues goes through
:func:`all_reduce`, :func:`broadcast`, :func:`all_gather` or
:func:`reduce_scatter`, which report it to an active work count
(:mod:`repro_torch.core.counts`) under the op the reference's compiled
step emits for it, and then issue it on ``torch.distributed``.  With no
count active, each costs the caller one ``None`` check before the
``torch.distributed`` call.

How a gather or a reduce-scatter moves its data depends on the backend:
NCCL, and gloo on CPU tensors, run ``all_gather_single`` /
``reduce_scatter_single`` (``all_gather_into_tensor`` /
``reduce_scatter_tensor`` where the installed torch lacks them).  gloo
gathers and scatters no CUDA tensor, so where ranks share a card (gloo
on CUDA tensors) a gather is each rank's piece in a zero buffer of the
whole width summed by ``all_reduce`` (a sum with zeros: exact), and a
reduce-scatter is an ``all_reduce`` and the rank's slice.  Either way
the count reports the reference's op, and the result is the same.

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


def _through_all_reduce(x: torch.Tensor, group) -> bool:
    """gloo on a CUDA tensor: it gathers and scatters none."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _op(name: str):
    """``torch.distributed``'s ``name`` + ``_single``, or its older name."""
    old = {"all_gather": "all_gather_into_tensor",
           "reduce_scatter": "reduce_scatter_tensor"}[name]
    return getattr(dist, f"{name}_single", None) or getattr(dist, old)


def all_gather(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in the group's rank
    order, reported to an active work count as an ``all-gather`` of the
    result; over a :class:`CountedGroup`, counted only (an uninitialised
    tensor of the result's shape).  The transport is the module
    docstring's."""
    g = group_size(group)
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] *= g
    if isinstance(group, CountedGroup):
        out = x.new_empty(shape)
    elif _through_all_reduce(x, group):
        out = x.new_zeros(shape)
        w = x.shape[dim]
        out.narrow(dim, dist.get_rank(group) * w, w).copy_(x)
        dist.all_reduce(out, group=group)
    else:
        # rank r's piece lands in parts[r]; the op is handed the pieces'
        # concatenation along dim 0, the form every backend takes
        parts = x.new_empty((g, *x.shape))
        _op("all_gather")(parts.flatten(0, 1), x.contiguous(), group=group)
        out = parts.movedim(0, dim).flatten(dim, dim + 1)
    if _counts.ACTIVE is not None:
        _counts.report_collective("all-gather", out, g)
    return out


def reduce_scatter(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The sum of every rank's ``x`` over the group, cut into equal
    blocks along ``dim``: this rank's block (by its rank in the group),
    reported to an active work count as a ``reduce-scatter`` of that
    block; over a :class:`CountedGroup`, counted only (an uninitialised
    tensor of the block's shape).  The transport is the module
    docstring's."""
    g = group_size(group)
    dim = dim % x.dim()
    if x.shape[dim] % g:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {g} ranks")
    w = x.shape[dim] // g
    if isinstance(group, CountedGroup):
        out = x.new_empty((*x.shape[:dim], w, *x.shape[dim + 1:]))
    elif _through_all_reduce(x, group):
        full = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(full, group=group)
        out = full.narrow(dim, dist.get_rank(group) * w, w)
    else:
        parts = x.unflatten(dim, (g, w)).movedim(dim, 0).contiguous()
        out = x.new_empty(parts.shape[1:])
        _op("reduce_scatter")(out, parts.flatten(0, 1), group=group)
    if _counts.ACTIVE is not None:
        _counts.report_collective("reduce-scatter", out, g)
    return out


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


__all__ = ["CountedGroup", "all_gather", "all_reduce", "broadcast",
           "group_size", "reduce_scatter"]
