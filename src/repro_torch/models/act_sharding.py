"""The tensor- and pipeline-parallel hint of a rank's model code (the
PyTorch counterpart of the JAX package's ``models/act_sharding.py``).

``set_mesh(mesh, dp_axes, tp_axis)`` installs a process-global hint:
this rank's mesh, hence its tensor-parallel group, its rank in that
group and the group's size, and its pipeline stage (set by the engine's
step factories and by ``runtime.serve.make_serve_fns``, as the
reference's are).  Without a hint, or with a tp axis of one, every
helper here is the identity, so one-device code never sees a
collective.

``constrain`` is the identity.  Under JAX it places a sharding
constraint that XLA's propagation would otherwise lose; in eager
PyTorch a rank only ever holds its own shard, so there is nothing to
constrain.  It is kept so that code reads as the reference's.

The two collectives the tensor-parallel model needs live here:
:func:`tp_all_reduce` (the sum after a row-parallel product) and
:func:`tp_all_gather` (an all-gather written as an ``all_reduce`` of a
zero-filled buffer, since gloo gathers no CUDA tensors); and the
pipeline's two: :func:`staged_scan` (a stage's layers between the
activation's hops) and :func:`from_last_stage` (the last stage's result
to every stage).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

_HINT = {"mesh": None, "dp": (), "tp": None, "pp": None}


def set_mesh(mesh, dp_axes: Sequence[str] = ("data",),
             tp_axis: str = "model") -> None:
    """Install ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`, or None
    to clear) as this process's hint; its pipeline axis is ``"pipe"``,
    the port's meshes' (``Mesh.recv_activation`` and the rest)."""
    _HINT["mesh"] = mesh
    _HINT["dp"] = tuple(a for a in dp_axes if mesh and a in mesh.shape)
    _HINT["tp"] = tp_axis if (mesh and tp_axis in mesh.shape) else None
    _HINT["pp"] = "pipe" if (mesh and "pipe" in mesh.shape) else None


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


def current_mesh():
    """The installed mesh, or None."""
    return _HINT["mesh"]


def stage_layers(n: int) -> Tuple[int, int]:
    """Layers ``lo .. hi - 1`` of a stack of ``n`` that this rank's
    pipeline stage runs (``runtime.sharding.stage_range``; the whole
    stack without a pipe axis)."""
    mesh, pp = _HINT["mesh"], _HINT["pp"]
    if not pp:
        return 0, n
    s, stages = mesh.coords[pp], mesh.shape[pp]
    return s * n // stages, (s + 1) * n // stages


def staged_scan(mesh, x: torch.Tensor, body: Callable, n_layers: int
                ) -> torch.Tensor:
    """The layer loop, split into pipeline stages (the reference's
    ``_staged_scan``, its ``engine/decode_loop.py:179``).

    ``body(li, x)`` runs local layer ``li``.  With ``pp == 1`` (or no
    mesh) this is the plain loop.  With ``pp > 1`` the rank of stage
    ``s`` holds its layers (weights and caches), takes ``x`` from stage
    ``s - 1`` (written into ``x`` in place), runs its layers and hands
    ``x`` on to stage ``s + 1``; only the carried activation moves
    between stages.  The returned ``x`` is the stack's output on the
    last stage."""
    if mesh is not None:
        x = mesh.recv_activation(x)
    for li in range(n_layers):
        x = body(li, x)
    if mesh is not None:
        mesh.send_activation(x)
    return x


def from_last_stage(mesh, make: Callable, shape, dtype, device
                    ) -> torch.Tensor:
    """``make()`` on the last pipeline stage, broadcast to every stage of
    the rank's column (just ``make()`` at pp = 1)."""
    if mesh is None or mesh.shape["pipe"] == 1:
        return make()
    out = (make().contiguous() if mesh.last_stage
           else torch.empty(shape, dtype=dtype, device=device))
    return mesh.from_last_stage(out)


__all__ = ["clear_mesh", "constrain", "current_mesh", "from_last_stage",
           "set_mesh", "stage_layers", "staged_scan", "tp_all_gather",
           "tp_all_reduce", "tp_group", "tp_rank", "tp_size"]
