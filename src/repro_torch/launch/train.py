"""Training launcher of the port — one device.

    python -m repro_torch.launch.train --arch granite-3-2b --use-flash \
        --steps 4 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --reduced --device cpu --steps 3 --use-flash

Mirrors ``python -m repro.launch.train``: random weights from a seeded
generator, synthetic Zipf tokens, AdamW with a warmup of steps/20, the
fault-tolerant ``Trainer`` with its checkpoint cadence, and the
reference's JSON summary.  ``--use-flash`` runs attention through the
flash attention kernels (the reference's ``Trainer`` takes ``use_flash``
but its launcher never sets it); ``--device`` picks the device (the
default is the card; entry points never fall back to the CPU).  It prints
no LIFE forecast line, since the analytical half is not ported (ROADMAP
queue 1, item 17), and has no ``--multi-pod``: multi-device training is
item 15.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from repro_torch import configs, resolve_device
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import Trainer, TrainerConfig


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

    opt = AdamW(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                total_steps=args.steps)
    data = SyntheticTokens(cfg, DataConfig(global_batch=args.batch,
                                           seq_len=args.seq), device=device)
    tc = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, log_every=10,
                       microbatches=args.microbatches)
    t0 = time.time()
    trainer = Trainer(cfg, opt, data, tc, use_flash=args.use_flash,
                      device=device)
    params, opt_state, log = trainer.run()
    wall = time.time() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    summary = {
        "arch": cfg.name, "params": n_params, "steps": args.steps,
        "wall_s": round(wall, 1),
        "final_loss": log[-1]["loss"] if log else None,
        "first_loss": log[0]["loss"] if log else None,
    }
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
