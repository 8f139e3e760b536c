"""Checkpointing with atomic manifests (the PyTorch counterpart of the JAX
package's ``checkpoint/manager.py``, in its on-disk layout).

* **Atomicity** — arrays are written to ``step_NNNNNNNN.tmp/`` then
  renamed; a crash mid-write never corrupts the latest checkpoint.
* **Manifest** — ``manifest.json`` holds the step and each leaf's key,
  shape and dtype name; restore validates shapes before loading.
* **Layout** — ``proc0_arrays.npz`` holds each leaf's raw bytes; leaves
  are flattened in the reference's order (dict keys sorted, tuples and
  ``AdamWState`` as ``count, mu, nu`` in order), and bf16 is stored under
  the dtype name ``bfloat16``, so either package restores the other's
  checkpoints.
* **GC** — the last ``keep_last_n`` steps are kept; older ones deleted.
* **Meshes** — ``save`` from a mesh of ranks assembles each leaf whole
  (``runtime.sharding.unshard_leaf``), rank 0 writes the layout above,
  and every rank waits for the publish; ``restore_sharded`` reads whole
  leaves and cuts this rank's shard (``runtime.sharding.shard_leaf``).
  A checkpoint is thereby independent of the mesh that wrote it: it
  restores on any mesh shape, in either package.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.adamw import tree_leaves, tree_like

#: dtype names as numpy spells them -> (torch dtype, numpy dtype of the
#: raw bytes; bf16 crosses as int16 bits)
_DTYPES = {
    "float32": (torch.float32, np.float32),
    "float16": (torch.float16, np.float16),
    "bfloat16": (torch.bfloat16, np.int16),
    "float64": (torch.float64, np.float64),
    "int64": (torch.int64, np.int64),
    "int32": (torch.int32, np.int32),
    "int16": (torch.int16, np.int16),
    "int8": (torch.int8, np.int8),
    "uint8": (torch.uint8, np.uint8),
    "bool": (torch.bool, np.bool_),
}
_NAMES = {t: name for name, (t, _) in _DTYPES.items()}


def _flatten(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return list(tree_leaves(tree))
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _flatten(sub)]
    return [tree]


def _paths(tree, path=()) -> List[Tuple[str, ...]]:
    """Each leaf's dict-key path, in :func:`_flatten`'s order (a tuple's
    position is not part of it: ``mu`` and ``nu`` share the params'
    paths)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [p for sub in tree for p in _paths(sub, path)]
    return [path]


def _axes_of(cfg, path: Tuple[str, ...]):
    """``(logical axes, whole shape)`` of the parameter at ``path``, or
    ``((), None)`` for a leaf that is no parameter (AdamW's ``count``)."""
    from repro_torch.models.layers import param_defs
    node = param_defs(cfg)
    for k in path:
        if not isinstance(node, dict) or k not in node:
            return (), None
        node = node[k]
    if isinstance(node, dict):
        return (), None
    return node.axes, node.shape


def _unflatten(tree, leaves: Iterator[torch.Tensor]):
    """A tree shaped like ``tree`` whose leaves are taken from ``leaves``
    (in :func:`_flatten`'s order)."""
    if isinstance(tree, dict):
        return tree_like(tree, leaves)
    if isinstance(tree, (tuple, list)):
        items = [_unflatten(sub, leaves) for sub in tree]
        # a NamedTuple (AdamWState) takes its fields as arguments
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return next(leaves)


def _to_bytes(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    name = _NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return np.frombuffer(t.numpy().tobytes(), dtype=np.uint8), name


class _Whole:
    """A leaf of ``restore``'s example: a whole shape, read to the host."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.device = torch.device("cpu")


class CheckpointManager:
    def __init__(self, directory: str, keep_last_n: int = 3):
        self.dir = directory
        self.keep = keep_last_n
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree, *, process_index: int = 0, mesh=None,
             policy=None, cfg=None) -> str:
        """Publish ``tree`` as step ``step``.  From a ``mesh`` (with the
        ``cfg`` whose parameters ``tree`` holds: params, or (params,
        AdamW state)) every rank must call this: each leaf is assembled
        whole on every rank, rank 0 writes, and all ranks wait for the
        publish before returning."""
        if mesh is not None and mesh.size > 1:
            return self._save_from_mesh(step, tree, mesh, policy, cfg)
        leaves = _flatten(tree)
        return self._write(step, leaves, process_index)

    def _save_from_mesh(self, step, tree, mesh, policy, cfg) -> str:
        from repro_torch.runtime.sharding import ShardingPolicy, unshard_leaf
        policy = policy or ShardingPolicy()
        whole = []
        for path, leaf in zip(_paths(tree), _flatten(tree)):
            axes, shape = _axes_of(cfg, path)
            if shape is not None:
                leaf = unshard_leaf(path, axes, leaf.detach(), shape, mesh,
                                    policy)
            # only rank 0 keeps the whole leaves (on the host)
            whole.append(leaf.detach().cpu() if mesh.rank == 0 else None)
        final = (self._write(step, whole, 0) if mesh.rank == 0 else
                 os.path.join(self.dir, f"step_{step:08d}"))
        mesh.barrier()
        return final

    def _write(self, step: int, leaves, process_index: int) -> str:
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        arrays = {}
        manifest = {"step": step, "treedef": f"{len(leaves)} leaves",
                    "leaves": []}
        for i, leaf in enumerate(leaves):
            raw, name = _to_bytes(leaf)
            key = f"leaf_{i:05d}"
            arrays[key] = raw
            manifest["leaves"].append(
                {"key": key, "shape": list(leaf.shape), "dtype": name})
        np.savez(os.path.join(tmp, f"proc{process_index}_arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
        self._gc()
        return final

    # ------------------------------------------------------------------
    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------
    def restore(self, example_tree: Any, step: Optional[int] = None,
                *, process_index: int = 0):
        """Restore into the structure of ``example_tree`` (shape-validated);
        each leaf lands on its example leaf's device, in the dtype the
        checkpoint stored.  Returns (tree, step)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = _flatten(example_tree)
        if len(leaves) != len(manifest["leaves"]):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, "
                f"expected {len(leaves)} — incompatible tree")
        restored = []
        with np.load(os.path.join(path, f"proc{process_index}_arrays.npz")) as data:
            for i, (leaf, meta) in enumerate(zip(leaves, manifest["leaves"])):
                want = tuple(leaf.shape)
                if tuple(meta["shape"]) != want:
                    raise ValueError(f"leaf {i}: checkpoint shape "
                                     f"{tuple(meta['shape'])} != model {want}")
                if meta["dtype"] not in _DTYPES:
                    raise ValueError(f"leaf {i}: dtype {meta['dtype']!r} is "
                                     f"not one the port restores")
                t_dtype, np_dtype = _DTYPES[meta["dtype"]]
                arr = np.frombuffer(data[meta["key"]].tobytes(),
                                    dtype=np_dtype).reshape(want)
                t = torch.from_numpy(arr.copy()).view(t_dtype)
                restored.append(t.to(leaf.device))
        return _unflatten(example_tree, iter(restored)), step

    def restore_sharded(self, example: Any, mesh, policy=None,
                        step: Optional[int] = None, *, cfg):
        """Restore whole leaves and keep this rank's shard of each, cut by
        ``mesh`` and ``policy`` as ``runtime.sharding`` cuts ``cfg``'s
        parameters (AdamW's moments like their params); the checkpoint
        may come from any mesh shape and either package.  ``example`` is
        this rank's tree (its shards: structure, shapes and devices);
        each restored shard must have its example leaf's shape.  Returns
        (tree, step)."""
        from repro_torch.runtime.sharding import ShardingPolicy, shard_leaf
        policy = policy or ShardingPolicy()
        whole_example = _unflatten(example, iter(
            _Whole(_axes_of(cfg, path)[1] or leaf.shape)
            for path, leaf in zip(_paths(example), _flatten(example))))
        host, step = self.restore(whole_example, step)
        placed = []
        for path, leaf, t in zip(_paths(example), _flatten(example),
                                 _flatten(host)):
            axes, shape = _axes_of(cfg, path)
            if shape is not None:
                t = shard_leaf(path, axes, t, mesh, policy)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"{'/'.join(path)}: this rank's cut "
                                 f"{tuple(t.shape)} != its leaf "
                                 f"{tuple(leaf.shape)}")
            placed.append(t.to(leaf.device))
        return _unflatten(example, iter(placed)), step

    # ------------------------------------------------------------------
    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
