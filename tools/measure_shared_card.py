#!/usr/bin/env python3
"""Serve ``chip_smoke.py``'s multidevice llama2-7b tp = 2 plain pass with
both ranks on one card (``share_device``: gloo on CUDA tensors), and
print as one JSON line the ``src`` directory the package was imported
from, the card's name and power limit, and rank 0's TTFT and TPOT (p50
over the requests, as ``chip_smoke.py`` reports them, and the means),
TPS and token count.

The pass: llama2-7b at full size from seed 0 in bf16, drawn shard by
shard; 8 random requests of 512 + 64 tokens (seed 1), request 1 sharing
request 0's first 256 tokens (a radix hit) and request 3 repeating
request 2 (a copy-on-write fork); 4 slots, chunk 256, decode blocks of
8, a 512-block pool of 16 positions, paged attention, bf16 KV.
``--reduced`` (a CPU check) serves the reduced config, 4 requests of
32 + 8 over 2 slots, chunk 16, 16 shared tokens.

``--src`` picks the package: the ``src`` directory of this checkout by
default, or that of another checkout of the port, so that two versions
are compared on the same card, run in turns (A, B, B, A):

    python3 tools/measure_shared_card.py --src /path/to/other/src
    python3 tools/measure_shared_card.py
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


#: (requests, prompt, new tokens, shared, slots, chunk) at full size and
#: reduced
PASS = {False: (8, 512, 64, 256, 4, 256), True: (4, 32, 8, 16, 2, 16)}


def serve_rank(mesh, reduced: bool):
    """One rank's pass (see the module docstring); rank 0's numbers."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.engine import Engine, EngineConfig, Request
    from repro_torch.runtime.sharding import init_shard

    cfg = configs.get("llama2-7b")
    if reduced:
        cfg = configs.reduced(cfg)
    params = init_shard(cfg, 0, mesh, device=mesh.device)
    n, prompt, gen, shared, slots, chunk = PASS[reduced]
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                (n, prompt))
    prompts[1, :shared] = prompts[0, :shared]
    prompts[3] = prompts[2]
    reqs = [Request(rid=i, prompt=prompts[i].tolist(), max_new=gen)
            for i in range(n)]
    ec = EngineConfig(max_slots=slots, max_len=prompt + gen + 16,
                      chunk_size=chunk, decode_block=8,
                      block_size=16, n_blocks=512, kv_dtype="bf16",
                      attn_impl="paged")
    eng = Engine(cfg, params, ec, mesh=mesh)
    eng.warmup()
    t0 = time.perf_counter()
    results = eng.run(reqs)
    wall = time.perf_counter() - t0
    if mesh.rank != 0:
        return None
    tpot = [r.tpot for r in results]
    return dict(ttft_p50_ms=float(np.median([r.ttft for r in results]))
                * 1e3, tpot_p50_ms=float(np.median(tpot)) * 1e3,
                tpot_mean_ms=float(np.mean(tpot)) * 1e3,
                tps=eng.aggregate_tps(), wall_s=wall,
                tokens=sum(len(r.tokens) for r in results))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config at a CPU check's size")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch
    from repro_torch.launch.mesh import spawn

    rec = spawn(serve_rank, (args.reduced,), model=2, device=args.device,
                share_device=True)[0]
    card = None
    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(
        src=str(Path(repro_torch.__file__).resolve().parents[1]),
        card=card, **rec)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
