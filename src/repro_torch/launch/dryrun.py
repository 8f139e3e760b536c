"""Multi-pod dry-run driver (the PyTorch counterpart of the JAX package's
``launch/dryrun.py``).

Counts every (architecture × input shape) cell on the reference's
production mesh — 16×16 single-pod and 2×16×16 multi-pod — as rank 0's
step run once on the meta device (``launch.specs``) inside a work count
(``core.counts``), and records, per cell, the reference's fields:

* ``per_chip``: FLOPs, bytes, collective wire bytes by op and counts,
  from the count;
* ``memory_analysis``: the argument bytes of the rank's params,
  optimizer state, decode state and batch, and for temporaries the peak
  bytes of the live meta tensors the step made;
* ``roofline``: the counted terms priced on the port's ``nvidia-h100``;
* the LIFE-distributed analytical forecast (made BEFORE the count, also
  on ``nvidia-h100``), ``model_flops`` and ``useful_flops_ratio``.

Nothing touches a device: every tensor is a meta tensor and the mesh's
collectives are counted, not run.  The fields only XLA gives are null,
each with its reason under ``null_reasons``.

Artifacts: ``artifacts/dryrun/<mesh>/<arch>__<shape>.json``

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.core import counts, distributed, hardware
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import act_sharding

#: why each field only XLA gives is null
NULL_REASONS = {
    "lower_s": "nothing is lowered: the step runs eagerly on meta tensors",
    "compile_s": "nothing is compiled: the step runs eagerly on meta "
                 "tensors",
    "per_chip.unknown_trip_loops": "no while loops: the eager step's work "
                                   "is counted op by op",
    "per_chip.xla_cost_analysis_flops_unfolded": "XLA's cost analysis: "
                                                 "no XLA module exists",
    "per_chip.xla_cost_analysis_bytes_unfolded": "XLA's cost analysis: "
                                                 "no XLA module exists",
    "memory_analysis.generated_code_size_in_bytes": "no generated code: "
                                                    "the step runs eager "
                                                    "aten ops",
}


def _tensors_bytes(tree, skip) -> int:
    if isinstance(tree, dict):
        return sum(_tensors_bytes(v, skip) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensors_bytes(v, skip) for v in tree)
    if isinstance(tree, torch.Tensor) and id(tree) not in skip:
        return tree.numel() * tree.element_size()
    return 0


def _ids(tree, out=None) -> set:
    out = set() if out is None else out
    if isinstance(tree, dict):
        for v in tree.values():
            _ids(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _ids(v, out)
    elif isinstance(tree, torch.Tensor):
        out.add(id(tree))
    return out


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             out_dir: str = "artifacts/dryrun", verbose: bool = True,
             **cell_kwargs) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    skip = specs_mod.cell_is_skipped(arch, shape)
    record = {"arch": arch, "shape": shape, "mesh": mesh_name,
              "n_devices": 512 if multi_pod else 256}
    if skip:
        record["status"] = "SKIP"
        record["reason"] = skip
        _write(record, out_dir, mesh_name, arch, shape)
        if verbose:
            print(f"[{mesh_name}] {arch} × {shape}: SKIP ({skip})")
        return record

    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    try:
        cell = specs_mod.build_cell(arch, shape, mesh, **cell_kwargs)
        # LIFE forecast FIRST (hardware-agnostic, before the count)
        record["life_forecast"] = specs_mod.life_prediction(cell)
        with counts.count_work() as mc:
            out = cell.fn(*cell.args)
        run_s = time.time() - t0
        out_bytes = _tensors_bytes(out, _ids(cell.args))
        del out
        hw = hardware.get(specs_mod.HARDWARE)
        terms = distributed.roofline(mc.flops, mc.bytes, mc.wire_bytes, hw)
        mf = distributed.model_flops(cell.workload.arch, cell.tokens,
                                     training=cell.training)
        n_dev = record["n_devices"]
        record.update({
            "status": "OK",
            "lower_s": None,
            "compile_s": None,
            "count_s": round(run_s, 2),
            "per_chip": {
                "flops": mc.flops,
                "bytes": mc.bytes,
                "collective_wire_bytes": mc.wire_bytes,
                "collective_wire_by_op": mc.collective_wire,
                "collective_counts": mc.collective_counts,
                "unknown_trip_loops": None,
                "xla_cost_analysis_flops_unfolded": None,
                "xla_cost_analysis_bytes_unfolded": None,
                "dot_flops": mc.dot_flops,
                "flops_by_op": mc.flops_by_op,
                "bytes_by_op": mc.bytes_by_op,
            },
            "memory_analysis": {
                "generated_code_size_in_bytes": None,
                "argument_size_in_bytes": sum(cell.arg_bytes.values()),
                "argument_bytes_by_kind": dict(cell.arg_bytes),
                "output_size_in_bytes": out_bytes,
                "alias_size_in_bytes": cell.alias_bytes,
                "temp_size_in_bytes": int(mc.peak_live_bytes),
            },
            "roofline": {
                "t_compute_s": terms.t_compute,
                "t_memory_s": terms.t_memory,
                "t_collective_s": terms.t_collective,
                "dominant": terms.dominant,
                "bound_time_s": terms.bound_time,
                "hardware": hw.name,
            },
            "model_flops": mf,
            "model_flops_per_chip": mf / n_dev,
            "useful_flops_ratio": (mf / n_dev) / mc.flops if mc.flops
            else 0.0,
            "tokens": cell.tokens,
            "null_reasons": dict(NULL_REASONS),
        })
        if verbose:
            r = record["roofline"]
            print(f"[{mesh_name}] {arch} × {shape}: OK "
                  f"count={run_s:.1f}s  "
                  f"tc={r['t_compute_s']:.3e} tm={r['t_memory_s']:.3e} "
                  f"tx={r['t_collective_s']:.3e} → {r['dominant']}  "
                  f"useful={record['useful_flops_ratio']:.2f}")
    except Exception as e:  # a failing cell is a bug — surface it loudly
        record["status"] = "FAIL"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[{mesh_name}] {arch} × {shape}: FAIL {record['error']}")
    finally:
        act_sharding.clear_mesh()
    _write(record, out_dir, mesh_name, arch, shape)
    return record


def _write(record, out_dir, mesh_name, arch, shape):
    d = os.path.join(out_dir, mesh_name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{arch}__{shape}.json"), "w") as f:
        json.dump(record, f, indent=1)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", choices=sorted(configs.ARCHS), default=None)
    p.add_argument("--shape", choices=sorted(configs.SHAPES), default=None)
    p.add_argument("--all", action="store_true",
                   help="run every assigned (arch × shape) cell")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--out", default="artifacts/dryrun")
    p.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"])
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--remat-policy", default="full",
                   choices=["full", "dots", "dots_no_batch"])
    p.add_argument("--moe-dispatch", default="local",
                   choices=["local", "a2a", "global"])
    args = p.parse_args()

    from repro_torch.models import blocks as _blocks
    _blocks.MOE_DISPATCH = args.moe_dispatch
    kvd = {"bf16": torch.bfloat16, "int8": torch.int8}[args.kv_dtype]
    kw = dict(kv_dtype=kvd, microbatches=args.microbatches,
              remat=not args.no_remat, remat_policy=args.remat_policy,
              out_dir=args.out)

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    cells = []
    if args.all:
        for a in configs.ASSIGNED:
            for s in configs.SHAPES:
                cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            p.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]

    n_fail = 0
    for mp in meshes:
        for a, s in cells:
            rec = run_cell(a, s, multi_pod=mp, **kw)
            n_fail += rec["status"] == "FAIL"
    if n_fail:
        raise SystemExit(f"{n_fail} dry-run cells FAILED")


if __name__ == "__main__":
    main()
