"""The data-, tensor- and pipeline-parallel hint of a rank's model code
(the PyTorch counterpart of the JAX package's ``models/act_sharding.py``).

``set_mesh(mesh, dp_axes, tp_axis, fsdp)`` installs a process-global
hint: this rank's mesh, hence its tensor-parallel group, its rank in
that group and the group's size, its data-parallel group, its pipeline
stage, and under FSDP the dim of every parameter leaf cut over the data
axis (set by the engine's step factories, by
``runtime.serve.make_serve_fns`` and by ``runtime.train``'s step, as
the reference's are).  Without a hint, or with axes of one, every helper
here is the identity, so one-device code never sees a collective.

``constrain`` is the identity.  Under JAX it places a sharding
constraint that XLA's propagation would otherwise lose; in eager
PyTorch a rank only ever holds its own shard, so there is nothing to
constrain.  It is kept so that code reads as the reference's.

The collectives the sharded model needs live here, each written with
``core.collectives``' helpers (which report each to an active work
count under the op the reference's compiled step emits, and say how
each moves its data on each backend), and each a
``torch.autograd.Function`` where a gradient flows through it
(Megatron-LM's *f* and *g*):

* :func:`tp_all_reduce` (*g*): the sum after a row-parallel product;
  the identity in the backward.  Under ``no_grad`` (serving) it sums in
  place;
* :func:`tp_copy` (*f*): the identity at the input of a column-parallel
  product, whose backward sums the ranks' partial input gradients;
* :func:`tp_all_gather`: an all-gather; its backward is the rank's
  slice of the gradient;
* over a vocabulary cut over tp (``embed``'s rows, ``lm_head``'s
  columns, the logits): :func:`vocab_embed`, Megatron-LM's
  vocab-parallel lookup (*g* after a masked lookup),
  :func:`tp_argmax`, the greedy token from every rank's max and index
  (two all-gathers, as the reference's compiled step makes them), and
  :func:`tp_whole_logits`, the gathered logits for what needs the whole
  distribution; each is the plain operation where the rank holds the
  whole vocabulary;
* :func:`dp_all_reduce`: the sum over the data-parallel group, the
  identity in the backward (the MoE router's per-expert means over the
  global batch; the gradient sums);
* :func:`fsdp_gather`: a leaf cut over the data axis gathered whole (an
  all-gather); its backward is the reduce-scatter of the gradient;

and the pipeline's two: :func:`staged_scan` (a stage's layers between
the activation's hops) and :func:`from_last_stage` (the last stage's
result to every stage).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.collectives import (all_gather, all_reduce,
                                          reduce_scatter)

_HINT = {"mesh": None, "dp": (), "tp": None, "pp": None, "fsdp": None}


def set_mesh(mesh, dp_axes: Sequence[str] = ("data",),
             tp_axis: str = "model", fsdp: Optional[Dict] = None) -> None:
    """Install ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`, or None
    to clear) as this process's hint; its pipeline axis is ``"pipe"``,
    the port's meshes' (``Mesh.recv_activation`` and the rest).  ``fsdp``
    is the parameter tree's dims cut over the data axis (an int or None
    per leaf, in whole-leaf dims; ``runtime.sharding.fsdp_dims``), or
    None without FSDP."""
    _HINT["mesh"] = mesh
    _HINT["dp"] = tuple(a for a in dp_axes if mesh and a in mesh.shape)
    _HINT["tp"] = tp_axis if (mesh and tp_axis in mesh.shape) else None
    _HINT["pp"] = "pipe" if (mesh and "pipe" in mesh.shape) else None
    _HINT["fsdp"] = fsdp if mesh is not None else None


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


def dp_size() -> int:
    """Data-parallel ways of the installed mesh (1 without a hint)."""
    mesh = _HINT["mesh"]
    n = 1
    for a in _HINT["dp"]:
        n *= mesh.shape[a]
    return n


def dp_rank() -> int:
    """This rank's index along the data axis (0 without one)."""
    mesh = _HINT["mesh"]
    return mesh.coords["data"] if "data" in _HINT["dp"] else 0


def dp_group():
    """The process group of this rank's data-parallel axis, or None.
    The port's meshes have one data axis (``"data"``)."""
    return _HINT["mesh"].groups["data"] if dp_size() > 1 else None


def fsdp_dims() -> Optional[Dict]:
    """The installed tree of dims cut over the data axis, or None."""
    return _HINT["fsdp"] if dp_size() > 1 else None


def _wants_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of ``x`` summed over ``group``."""
    return all_reduce(x.clone(memory_format=torch.contiguous_format), group)


class _Sum(torch.autograd.Function):
    """Sum over a group in the forward, the identity in the backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Copy(torch.autograd.Function):
    """The identity in the forward, a sum over a group in the backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _summed(dy, ctx.group), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward keeps the rank's slice
    (``index``) of the gradient (``reduce=False``) or reduce-scatters it
    over the group (``reduce=True``)."""

    @staticmethod
    def forward(ctx, x, dim, group, index, reduce):
        ctx.dim, ctx.group, ctx.index, ctx.reduce = dim, group, index, reduce
        ctx.width = x.shape[dim]
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        if ctx.reduce:
            dy = reduce_scatter(dy, ctx.dim, ctx.group)
        else:
            dy = dy.narrow(ctx.dim, ctx.index * ctx.width, ctx.width)
        return dy, None, None, None, None


def tp_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the tensor-parallel group (*g*: the identity in the
    backward; in place when no gradient flows); the identity at tp = 1."""
    group = tp_group()
    if group is None:
        return x
    if _wants_grad(x):
        return _Sum.apply(x, group)
    return all_reduce(x, group)


def tp_copy(x: torch.Tensor) -> torch.Tensor:
    """*f*: ``x`` as it is, at the input of a product whose weights the
    rank holds a cut of; the backward sums the ranks' partial gradients
    of ``x`` over the tensor-parallel group.  The identity at tp = 1 and
    when no gradient flows."""
    if not _wants_grad(x):
        return x
    group = tp_group()
    return x if group is None else _Copy.apply(x, group)


def tp_all_gather(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Concatenate every tp rank's ``x`` along ``dim`` in rank order
    (one all-gather); the backward is the rank's slice of the gradient.
    The identity at tp = 1."""
    group = tp_group()
    if group is None:
        return x
    dim = dim % x.dim()
    if _wants_grad(x):
        return _Gather.apply(x, dim, group, tp_rank(), False)
    return all_gather(x, dim, group)


def vocab_embed(table: torch.Tensor, ids: torch.Tensor, vocab: int
                ) -> torch.Tensor:
    """``table[ids]`` for a ``table`` of ``vocab`` rows, of which this
    rank may hold its contiguous block (its tp rank's): an id outside
    the block reads a zero row, and one :func:`tp_all_reduce` sums the
    ranks' rows (exact: one rank's row and zeros).  *g*'s backward is
    the identity, so each rank's gradient lands on its own rows."""
    held = table.shape[0]
    if held == vocab:
        return table[ids]
    local = ids - tp_rank() * held
    outside = (local < 0) | (local >= held)
    x = table[local.masked_fill(outside, 0)]
    return tp_all_reduce(x.masked_fill(outside[..., None], 0))


def tp_argmax(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """``torch.argmax(whole logits, -1)`` of logits whose last dim is
    this rank's block of ``vocab``: each rank's max and first argmax
    over its block (made global), every rank's max gathered (f32) and
    every rank's index gathered (int32), as the reference's compiled
    step gathers them (two ``all-gather``s), then the largest value; a
    tie goes to the lower rank, hence the lower index, as
    ``torch.argmax`` and ``jnp.argmax`` give it.  Exact for any logit
    dtype up to f32."""
    held = logits.shape[-1]
    if held == vocab:
        return torch.argmax(logits, dim=-1)
    idx = torch.argmax(logits, dim=-1, keepdim=True)
    values = tp_all_gather(logits.gather(-1, idx).float())
    ids = tp_all_gather((idx + tp_rank() * held).int())
    best = torch.argmax(values, dim=-1, keepdim=True)
    return ids.gather(-1, best)[..., 0].long()


def tp_whole_logits(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """The whole ``vocab`` logits from this rank's block of them (a
    :func:`tp_all_gather`; the logits as they are when whole): for what
    needs the whole distribution (temperature sampling, sampled
    verify)."""
    return logits if logits.shape[-1] == vocab else tp_all_gather(logits)


def dp_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the data-parallel group (the identity in the
    backward; in place when no gradient flows); the identity at dp = 1."""
    group = dp_group()
    if group is None:
        return x
    if _wants_grad(x):
        return _Sum.apply(x, group)
    return all_reduce(x, group)


def fsdp_gather(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """The whole leaf of a shard ``x`` cut over the data axis on ``dim``
    (None: ``x`` is whole); the backward reduce-scatters the gradient, so
    the shard's gradient is summed over the data-parallel group."""
    group = dp_group()
    if group is None or dim is None:
        return x
    if _wants_grad(x):
        return _Gather.apply(x, dim, group, dp_rank(), True)
    return all_gather(x, dim, group)


def fsdp_gather_tree(tree: Dict, dims: Optional[Dict]) -> Dict:
    """:func:`fsdp_gather` of every leaf of ``tree`` by the same-shaped
    ``dims`` (the tree as it is when ``dims`` is None)."""
    if dims is None:
        return tree
    return {k: (fsdp_gather_tree(v, dims[k]) if isinstance(v, dict)
                else fsdp_gather(v, dims[k])) for k, v in tree.items()}


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
    if mesh is None or mesh.shape.get("pipe", 1) == 1:
        return make()
    out = (make().contiguous() if mesh.last_stage
           else torch.empty(shape, dtype=dtype, device=device))
    return mesh.from_last_stage(out)


__all__ = ["clear_mesh", "constrain", "current_mesh", "dp_all_reduce",
           "dp_group", "dp_rank", "dp_size", "from_last_stage",
           "fsdp_dims", "fsdp_gather", "fsdp_gather_tree", "set_mesh",
           "stage_layers", "staged_scan", "tp_all_gather", "tp_all_reduce",
           "tp_argmax", "tp_copy", "tp_group", "tp_rank", "tp_size",
           "tp_whole_logits", "vocab_embed"]
