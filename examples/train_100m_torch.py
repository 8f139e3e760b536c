"""End-to-end training driver on the port (``repro_torch``, PyTorch and
CUDA), the counterpart of ``examples/train_100m.py``: a ~100M-parameter
dense LM for a few hundred steps.

Exercises the port's training substrate on one device: synthetic data
pipeline -> train step (remat + grad accumulation) -> AdamW + cosine
schedule -> checkpoint/restart -> loss curve; prints the LIFE forecast
of the same config on the NVIDIA H100 first (paper-style: forecast
before you burn compute).  It trains on the card unless ``--device cpu``
is given, and raises without a GPU otherwise.

    PYTHONPATH=src python examples/train_100m_torch.py [--steps 300] [--small]
    PYTHONPATH=src python examples/train_100m_torch.py --device cpu --small \\
        --steps 20 --batch 2 --seq 64
"""
import argparse
import json
import os
import tempfile
import time

from repro_torch import configs, resolve_device
from repro_torch.configs.base import Variant
from repro_torch.core import Forecaster, WorkloadModel, hardware
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--small", action="store_true",
                    help="~25M params (CI-sized) instead of ~100M")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base = configs.get("llama2-7b")
    if args.small:
        cfg = configs.reduced(base, d_model=256, n_layers=8, d_ff=1024,
                              n_heads=8, n_kv_heads=8, head_dim=32,
                              vocab_size=32000)
    else:
        cfg = configs.reduced(base, d_model=512, n_layers=12, d_ff=2048,
                              n_heads=8, n_kv_heads=8, head_dim=64,
                              vocab_size=32000)

    # LIFE forecast of a train-like fwd pass on the port's card
    wm = WorkloadModel(cfg, Variant())
    fc = Forecaster(hardware.get("nvidia-h100"))
    f = fc.phase(wm.prefill(args.batch, args.seq).totals("prefill"))
    print(f"[LIFE→nvidia-h100] fwd/step: tc={f.t_compute*1e3:.2f}ms "
          f"tm={f.t_memory*1e3:.2f}ms ({f.bound}-bound)", flush=True)

    data = SyntheticTokens(cfg, DataConfig(global_batch=args.batch,
                                           seq_len=args.seq, mean_doc_len=96),
                           device=device)
    opt = AdamW(lr=6e-4, warmup_steps=max(args.steps // 20, 1),
                total_steps=args.steps)
    tc = TrainerConfig(total_steps=args.steps, ckpt_every=100,
                       ckpt_dir=args.ckpt_dir, log_every=20)
    t0 = time.time()
    tr = Trainer(cfg, opt, data, tc, device=device)
    params, _, log = tr.run()
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(json.dumps({"params": n_params, "steps": args.steps,
                      "wall_s": round(time.time() - t0, 1),
                      "loss_curve": [(r["step"], round(r["loss"], 3))
                                     for r in log]}, indent=1))
    assert log[-1]["loss"] < log[0]["loss"], "training did not improve loss"
    print("OK: loss improved", log[0]["loss"], "->", log[-1]["loss"])


if __name__ == "__main__":
    main()
