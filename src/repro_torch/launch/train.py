"""Training launcher of the port — one device, or a mesh of ranks.

    python -m repro_torch.launch.train --arch granite-3-2b --use-flash \
        --steps 4 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --reduced --device cpu --steps 3 --use-flash
    python -m repro_torch.launch.train --arch granite-3-2b --use-flash \
        --steps 3 --batch 4 --seq 2048 --data 2 --fsdp --share-device

Mirrors ``python -m repro.launch.train``: random weights from a seeded
generator, synthetic Zipf tokens, AdamW with a warmup of steps/20, the
fault-tolerant ``Trainer`` with its checkpoint cadence, and the
reference's JSON summary (for MoE archs, with the last logged
load-balance aux loss as ``final_aux``).  A VLM's batches carry random
vision embeddings, as the reference's do.  ``--use-flash`` runs attention through the
flash attention kernels (the reference's ``Trainer`` takes ``use_flash``
but its launcher never sets it); ``--device`` picks the device (the
default is the card; entry points never fall back to the CPU).  Before
training it prints the reference's ``[LIFE]`` line, the analytical
forward pass of one step, here for the card the port runs on
(``nvidia-h100``).

``--data`` and ``--model`` fill the reference's ``make_host_mesh(data,
model)`` and ``--fsdp`` its ``ShardingPolicy(dp_axes=("data",),
fsdp=...)``: the ``Trainer`` then runs on ``data × model`` ranks started
by ``launch.mesh.spawn`` (one card each, NCCL; ``--share-device`` puts
them all on the visible cards over gloo), and rank 0's log gives the
summary.  The default 1 × 1 trains on one device in this process.  There
is no ``--multi-pod``: the port's production meshes
(``launch.mesh.make_production_mesh``) are the dry-run's rank-0 views,
which count collectives and run no rank.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

from repro_torch import configs, resolve_device
from repro_torch.configs import Variant
from repro_torch.core import hardware
from repro_torch.core.forecast import Forecaster
from repro_torch.core.workload import WorkloadModel
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import ShardingPolicy, Trainer, TrainerConfig


def _train_rank(mesh, cfg, opt, dc: DataConfig, tc: TrainerConfig,
                use_flash: bool, fsdp: bool):
    """One rank of a mesh run: its ``Trainer`` on ``mesh``; returns the
    metrics log."""
    data = SyntheticTokens(cfg, dc, device=mesh.device)
    policy = ShardingPolicy(dp_axes=("data",), fsdp=fsdp)
    trainer = Trainer(cfg, opt, data, tc, use_flash=use_flash, mesh=mesh,
                      policy=policy)
    return trainer.run()[2]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--arch", choices=sorted(configs.ARCHS), required=True)
    p.add_argument("--reduced", action="store_true",
                   help="train the reduced same-family config")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--d-model", type=int, default=0,
                   help="override reduced d_model (e.g. 512 for ~100M)")
    p.add_argument("--n-layers", type=int, default=0)
    p.add_argument("--use-flash", action="store_true",
                   help="attention through the flash attention kernels")
    p.add_argument("--device", default="cuda")
    p.add_argument("--data", type=int, default=1,
                   help="data-parallel ranks")
    p.add_argument("--model", type=int, default=1,
                   help="tensor-parallel ranks")
    p.add_argument("--fsdp", action="store_true",
                   help="shard the params' embed dim over the data ranks")
    p.add_argument("--share-device", action="store_true",
                   help="run every rank on the visible card(s) over gloo")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        overrides = {}
        if args.d_model:
            overrides["d_model"] = args.d_model
        if args.n_layers:
            overrides["n_layers"] = args.n_layers
        cfg = configs.reduced(cfg, **overrides)

    # LIFE forecast before training (the paper's feature, first-class)
    wm = WorkloadModel(cfg, Variant())
    fc = Forecaster(hardware.get("nvidia-h100"))
    fwd = fc.phase(wm.prefill(args.batch, args.seq).totals("prefill"))
    print(f"[LIFE] fwd/step: t_c={fwd.t_compute:.3e}s t_m={fwd.t_memory:.3e}s "
          f"bound={fwd.bound} (1 chip, fwd-only, nvidia-h100)")

    opt = AdamW(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                total_steps=args.steps)
    data = SyntheticTokens(cfg, DataConfig(global_batch=args.batch,
                                           seq_len=args.seq), device=device)
    tc = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, log_every=10,
                       microbatches=args.microbatches)
    t0 = time.time()
    if args.data * args.model == 1:
        trainer = Trainer(cfg, opt, data, tc, use_flash=args.use_flash,
                          device=device)
        params, opt_state, log = trainer.run()
        n_params = sum(x.numel() for x in tree_leaves(params))
    else:
        from repro_torch.launch.mesh import spawn
        from repro_torch.models.layers import param_defs
        dc = DataConfig(global_batch=args.batch, seq_len=args.seq)
        log = spawn(_train_rank, (cfg, opt, dc, tc, args.use_flash,
                                  args.fsdp), data=args.data,
                    model=args.model, device=device,
                    share_device=args.share_device)[0]
        n_params = sum(math.prod(d.shape) for d in tree_leaves(param_defs(
            cfg)))
    wall = time.time() - t0
    summary = {
        "arch": cfg.name, "params": n_params, "steps": args.steps,
        "wall_s": round(wall, 1),
        "final_loss": log[-1]["loss"] if log else None,
        "first_loss": log[0]["loss"] if log else None,
    }
    if cfg.family == "moe":
        # the loss above holds 0.01 x the load-balance aux, as the
        # reference's does; the aux itself beside it
        summary["final_aux"] = log[-1]["aux"] if log else None
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
