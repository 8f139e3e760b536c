"""What the RG-LRU sequence form's ``unbind`` saves in a recurrentgemma-2b
training step, on the card.

``blocks._rglru_scan`` takes each position's views of a chunk once
(``unbind``); indexing ``a[:, t]`` at every position instead makes
autograd's backward add a whole chunk of zeros per position, which
moves O(s^2 w) bytes per chunk.  This script trains recurrentgemma-2b at
full width and depth (random bf16 weights from seed 0, 1 x 4096 tokens,
flash attention, remat, AdamW: ``chip_smoke.py``'s train phase cell)
and times whole steps (host clock around the step and the loss read
back) with the repo's scan and with the indexed loop put in its place,
in turns (repo, indexed, indexed, repo) after one warm-up step, and
prints both.  Both forms give the same bits (``tests/test_torch_families.py``
holds the repo's to the reference's gradients).

    python tools/measure_rglru_backward.py [--rounds 1]
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def indexed_scan(a, gated, h_state):
    """The loop before ``unbind``: ``a[:, t]`` and ``gated[:, t]`` at
    every position (the same products and sums in the same order)."""
    import torch
    hs = []
    for t in range(a.shape[1]):
        h_state = a[:, t] * h_state + gated[:, t]
        hs.append(h_state)
    return torch.stack(hs, dim=1), h_state


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of (repo, indexed, indexed, repo) steps")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("measure_rglru_backward: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.models import blocks

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[rglru] {torch.cuda.get_device_name(0)}; {smi}")
    device = torch.device("cuda", 0)
    cfg = configs.get(cs.TRAIN_WIDE_ARCH)
    scans = {"unbind": blocks._rglru_scan, "indexed": indexed_scan}
    times = {k: [] for k in scans}
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = cs._trainer(cfg, ckpt, 100, 101, device,
                              batch=cs.TRAIN_WIDE_BATCH,
                              seq=cs.TRAIN_WIDE_SEQ,
                              steps=cs.TRAIN_WIDE_STEPS,
                              lr=cs.TRAIN_WIDE_LR)
        params, state = trainer.init_state(0)
        step = 0
        for mode in ["unbind"] + ["unbind", "indexed", "indexed",
                                  "unbind"] * args.rounds:
            blocks._rglru_scan = scans[mode]
            batch = trainer.data.batch(step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = trainer.step_fn(params, state, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if step:                       # step 0 warms up
                times[mode].append(wall)
            print(f"[rglru] step {step} ({mode}): {wall * 1e3:.1f} ms, "
                  f"loss {loss:.5f}")
            step += 1
        blocks._rglru_scan = scans["unbind"]
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    print(f"[rglru] {cfg.name} 1 x {cs.TRAIN_WIDE_SEQ}: step with unbind "
          f"{mean['unbind'] * 1e3:.1f} ms, with indexing "
          f"{mean['indexed'] * 1e3:.1f} ms; saved "
          f"{(mean['indexed'] - mean['unbind']) * 1e3:.1f} ms a step "
          f"({', '.join(f'{k} ' + '/'.join(f'{x * 1e3:.1f}' for x in v) for k, v in times.items())} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
