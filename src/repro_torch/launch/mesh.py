"""Meshes of ranks for data-, tensor- and pipeline-parallel runs on
``torch.distributed`` (the counterpart of the JAX package's
``launch/mesh.py``).

A JAX mesh is one process over many devices; the port's is one process
per rank.  :func:`spawn` starts ``data·model·pipe`` ranks with
``torch.multiprocessing`` (spawn), joins them through a ``FileStore`` in a
fresh temporary directory (so parallel test workers never meet on a
port), and calls ``fn(mesh, *args)`` on every rank; inside a rank,
:func:`make_host_mesh` builds the :class:`Mesh`: the default process
group plus one subgroup per mesh axis (``"data"``, ``"model"``,
``"pipe"``).  Ranks are laid out data-major, then stage-major: rank
``data_idx·(pipe·model) + pipe_idx·model + model_idx`` (at ``data = 1``
the serving worlds' layout).

The backend follows one rule (:func:`choose_backend`), and each run logs
the one it takes on stderr:

* tensors on the CPU: ``gloo``;
* one rank per card (at least ``data·model·pipe`` cards visible):
  ``nccl``;
* ranks that share a card: ``gloo`` on CUDA tensors, which reduces and
  broadcasts them through the host.  Only when the caller asks for it
  (``share_device=True``); without it too few cards raise the
  reference's "needs N devices" error.  gloo runs ``all_reduce``,
  ``broadcast`` and ``barrier`` on CUDA tensors but gathers and
  scatters none, so there the gathers travel as all-reduces (see
  :mod:`repro_torch.core.collectives`).

Every collective of the port goes through
:mod:`repro_torch.core.collectives` (``all_reduce``, ``broadcast``,
``all_gather``, ``reduce_scatter``), which reports it to an active work
count (``repro_torch.core.counts``) and then issues it.

:func:`make_production_mesh` gives rank 0's view of the reference's
production meshes (16×16 ``("data", "model")`` and 2×16×16 ``("pod",
"data", "model")``) for the dry-run: it spawns no process, and its
groups are ``CountedGroup`` objects, whose collectives are counted and
move nothing (on meta tensors the result is a tensor of the output's
shape).

Not ported: ``ensure_host_device_count``, which asks XLA for host
devices before JAX starts; PyTorch has no such count (a CPU rank is a
process).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core.collectives import CountedGroup, broadcast

#: seconds a rank waits in a collective, and the run waits for its ranks,
#: before it fails
RANK_TIMEOUT_S = 1800.0


def choose_backend(device_type: str, n_ranks: int, n_cards: int,
                   share_device: bool = False) -> str:
    """The process-group backend of ``n_ranks`` ranks on ``device_type``
    with ``n_cards`` cards visible (see the module docstring)."""
    if device_type == "cpu":
        return "gloo"
    if n_cards >= n_ranks:
        return "nccl"
    if share_device:
        return "gloo"
    raise ValueError(
        f"a mesh of {n_ranks} ranks needs {n_ranks} devices but only "
        f"{n_cards} are visible: run on a {n_ranks}-card host, or pass "
        f"share_device=True to run the ranks on the visible cards over "
        f"gloo")


@dataclasses.dataclass
class Mesh:
    """One rank's view of a ``data × model × pipe`` mesh.

    ``shape`` and ``coords`` are keyed by axis name; ``groups["model"]``
    is this rank's tensor-parallel group (the ranks of its replica and
    stage), ``groups["pipe"]`` its pipeline column (the ranks of its
    replica and model index over all stages) and ``groups["data"]`` its
    data-parallel group (the ranks of its model index and stage over all
    replicas), each None on an axis of size one.  ``hops[s]`` is the
    two-rank group from stage ``s`` to ``s + 1`` of this column."""
    shape: Dict[str, int]
    coords: Dict[str, int]
    rank: int
    device: torch.device
    backend: Optional[str] = None
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    hops: Dict[int, Any] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def rank_of(self, model: int, pipe: int,
                data: Optional[int] = None) -> int:
        """The rank at ``(data, model, pipe)``; ``data`` defaults to this
        rank's replica."""
        if data is None:
            data = self.coords["data"]
        return ((data * self.shape.get("pipe", 1) + pipe)
                * self.shape["model"] + model)

    @property
    def stage(self) -> int:
        return self.coords.get("pipe", 0)

    @property
    def last_stage(self) -> bool:
        return self.stage == self.shape.get("pipe", 1) - 1

    # -- pipeline hops: only the carried activation crosses stages --------
    def recv_activation(self, x: torch.Tensor) -> torch.Tensor:
        """On a stage after the first, overwrite ``x`` with the activation
        the previous stage sends; elsewhere return ``x`` as it is."""
        if self.stage > 0:
            broadcast(x, self.rank_of(self.coords["model"], self.stage - 1),
                      self.hops[self.stage - 1])
        return x

    def send_activation(self, x: torch.Tensor) -> None:
        """On a stage before the last, send ``x`` to the next stage."""
        if not self.last_stage:
            broadcast(x, self.rank, self.hops[self.stage])

    def from_last_stage(self, x: torch.Tensor) -> torch.Tensor:
        """Every stage gets the last stage's ``x`` (its logits or sampled
        tokens) over its pipeline column; the identity at pp = 1."""
        if self.shape.get("pipe", 1) > 1:
            broadcast(x, self.rank_of(self.coords["model"],
                                      self.shape["pipe"] - 1),
                      self.groups["pipe"])
        return x

    def from_rank0(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank gets rank 0's ``x``; the identity on one rank."""
        if self.size > 1:
            import torch.distributed as dist
            dist.broadcast(x, src=0)
        return x

    def barrier(self) -> None:
        """Wait for every rank; nothing on one rank."""
        if self.size > 1:
            import torch.distributed as dist
            dist.barrier()


def make_host_mesh(data: int = 1, model: int = 1, pipe: int = 1,
                   device=None) -> Mesh:
    """This rank's mesh of ``data × model × pipe`` ranks.

    Inside a rank started by :func:`spawn` the default process group
    exists and the subgroups are made here (every rank makes every group,
    in one order, as ``new_group`` requires).  A mesh of one rank needs
    no process group.  ``device`` defaults to the card: without one this
    raises (``repro_torch.resolve_device``), as every entry point does;
    the CPU is used only when asked for."""
    from repro_torch import resolve_device
    shape = {"data": data, "model": model, "pipe": pipe}
    n = data * model * pipe
    dev = resolve_device(device if device is not None else "cuda")
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        if n > 1:
            raise RuntimeError(
                f"make_host_mesh(data={data}, model={model}, pipe={pipe}) "
                f"runs inside a rank started by "
                f"repro_torch.launch.mesh.spawn")
        return Mesh(shape, {"data": 0, "model": 0, "pipe": 0}, 0, dev,
                    groups={"data": None, "model": None, "pipe": None})
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != n:
        raise ValueError(f"make_host_mesh(data={data}, model={model}, "
                         f"pipe={pipe}) in a world of {world} ranks")
    replica = pipe * model
    mesh = Mesh(shape, {"data": rank // replica,
                        "model": rank % model,
                        "pipe": (rank % replica) // model}, rank, dev,
                backend=dist.get_backend(),
                groups={"data": None, "model": None, "pipe": None})
    d0, s0, m0 = (mesh.coords[a] for a in ("data", "pipe", "model"))
    at = lambda d, s, m: (d * pipe + s) * model + m
    # one tp group per replica and stage
    for d in range(data if model > 1 else 0):
        for s in range(pipe):
            g = dist.new_group([at(d, s, m) for m in range(model)])
            if (d, s) == (d0, s0):
                mesh.groups["model"] = g
    # one pipeline column per replica and model index
    for d in range(data if pipe > 1 else 0):
        for m in range(model):
            col = [at(d, s, m) for s in range(pipe)]
            g = dist.new_group(col)
            mine = (d, m) == (d0, m0)
            if mine:
                mesh.groups["pipe"] = g
            for s in range(pipe - 1):
                # a two-rank hop per stage boundary; with two stages the
                # column is that hop
                h = g if pipe == 2 else dist.new_group(col[s:s + 2])
                if mine:
                    mesh.hops[s] = h
    # one data-parallel group per (stage, model index): FSDP gathers and
    # the gradient sums run over it
    for s in range(pipe if data > 1 else 0):
        for m in range(model):
            g = dist.new_group([at(d, s, m) for d in range(data)])
            if (s, m) == (s0, m0):
                mesh.groups["data"] = g
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Rank 0's view of the reference's production mesh: 16×16 ``("data",
    "model")`` (256 chips) or 2×16×16 ``("pod", "data", "model")`` (512
    chips), on the meta device.  It spawns no process and holds no
    device: its groups are ``CountedGroup`` objects, ``groups["data"]``
    spanning every data-parallel axis (pod × data)."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    dp = shape["data"] * shape.get("pod", 1)
    groups: Dict[str, Any] = {a: CountedGroup(n) for a, n in shape.items()}
    groups["data"] = CountedGroup(dp)
    groups["pipe"] = None
    return Mesh(shape, {a: 0 for a in shape}, 0, torch.device("meta"),
                groups=groups)


def _rank_main(rank: int, fn: Callable, args: tuple, data: int, model: int,
               pipe: int, device_type: str, backend: str, n_cards: int,
               workdir: str) -> None:
    torch.set_num_threads(1)
    n = data * model * pipe
    if device_type == "cuda":
        device = torch.device("cuda", rank % n_cards)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    import torch.distributed as dist
    store = dist.FileStore(os.path.join(workdir, "store"), n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=datetime.timedelta(
                                seconds=RANK_TIMEOUT_S))
    try:
        mesh = make_host_mesh(data, model, pipe, device=device)
        result = fn(mesh, *args)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, args: tuple = (), *, data: int = 1, model: int = 1,
          pipe: int = 1, device="cuda",
          share_device: bool = False) -> List[Any]:
    """Run ``fn(mesh, *args)`` on each of ``data·model·pipe`` spawned ranks
    and return their results in rank order.

    ``fn`` must be importable by name from a spawned process.  If a rank
    raises, the others are stopped and the error is raised here with the
    rank's traceback; nothing is swallowed.  ``device="cuda"`` needs a
    card (or raises, as every entry point of the port does), and one card
    per rank unless ``share_device`` (see :func:`choose_backend`)."""
    from repro_torch import resolve_device
    import torch.multiprocessing as mp

    n = data * model * pipe
    dev = resolve_device(device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev.type, n, n_cards, share_device)
    where = ("the CPU" if dev.type == "cpu" else
             f"{min(n, n_cards)} card(s)" + (", shared" if n > n_cards
                                             else ""))
    print(f"[mesh] data={data} x model={model} x pipe={pipe}: {n} ranks on "
          f"{where}, backend {backend}", file=sys.stderr, flush=True)
    workdir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, args, data, model, pipe, dev.type, backend,
                              n_cards, workdir),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(
                    f"ranks did not finish in {RANK_TIMEOUT_S} s")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


__all__ = ["Mesh", "choose_backend", "make_host_mesh",
           "make_production_mesh", "spawn"]
