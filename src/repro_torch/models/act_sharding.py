"""The tensor-parallel hint of a rank's model code (the PyTorch
counterpart of the JAX package's ``models/act_sharding.py``).

``set_mesh(mesh, dp_axes, tp_axis)`` installs a process-global hint:
this rank's tensor-parallel group, its rank in that group and the
group's size (set by the engine's step factories, as the reference's
are).  Without a hint, or with a tp axis of one, every helper here is
the identity, so one-device code never sees a collective.

``constrain`` is the identity.  Under JAX it places a sharding
constraint that XLA's propagation would otherwise lose; in eager
PyTorch a rank only ever holds its own shard, so there is nothing to
constrain.  It is kept so that code reads as the reference's.

The two collectives the tensor-parallel model needs live here:
:func:`tp_all_reduce` (the sum after a row-parallel product) and
:func:`tp_all_gather` (an all-gather written as an ``all_reduce`` of a
zero-filled buffer, since gloo gathers no CUDA tensors).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

_HINT = {"mesh": None, "dp": (), "tp": None}


def set_mesh(mesh, dp_axes: Sequence[str] = ("data",),
             tp_axis: str = "model") -> None:
    """Install ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`, or None
    to clear) as this process's hint."""
    _HINT["mesh"] = mesh
    _HINT["dp"] = tuple(a for a in dp_axes if mesh and a in mesh.shape)
    _HINT["tp"] = tp_axis if (mesh and tp_axis in mesh.shape) else None


def clear_mesh() -> None:
    set_mesh(None)


def constrain(x: torch.Tensor, axes: Tuple[Optional[str], ...]
              ) -> torch.Tensor:
    """The identity (see the module docstring)."""
    assert len(axes) == x.dim(), (axes, tuple(x.shape))
    return x


def tp_size() -> int:
    """Tensor-parallel ways of the installed mesh (1 without a hint)."""
    mesh, tp = _HINT["mesh"], _HINT["tp"]
    return mesh.shape[tp] if tp else 1


def tp_rank() -> int:
    """This rank's index along the tensor-parallel axis (0 without one)."""
    mesh, tp = _HINT["mesh"], _HINT["tp"]
    return mesh.coords[tp] if tp else 0


def tp_group():
    """The process group of this rank's tensor-parallel axis, or None."""
    mesh, tp = _HINT["mesh"], _HINT["tp"]
    return mesh.groups[tp] if tp and mesh.shape[tp] > 1 else None


def tp_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the tensor-parallel group, in place; the identity at
    tp = 1."""
    group = tp_group()
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(x, group=group)
    return x


def tp_all_gather(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Concatenate every tp rank's ``x`` along ``dim`` in rank order: each
    rank writes its piece into a zero buffer of the whole width and one
    ``all_reduce`` sums them (a sum with zeros, so exact).  The identity
    at tp = 1."""
    n = tp_size()
    if n == 1:
        return x
    dim = dim % x.dim()
    w = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * w
    full = x.new_zeros(shape)
    full.narrow(dim, tp_rank() * w, w).copy_(x)
    return tp_all_reduce(full)


__all__ = ["clear_mesh", "constrain", "set_mesh", "tp_all_gather",
           "tp_all_reduce", "tp_group", "tp_rank", "tp_size"]
