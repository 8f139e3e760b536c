"""Readings that set a cell's limits, on the card, in one process:

    python3 -m portbench.control --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--fault-seeds 4,5,6] --seconds <s>

For each of ``--seeds`` the program's numbers, from a whole run of the
cell (set-up, a window of ``--seconds`` at the cell's own load, the
check).  For each of ``--control-seeds`` also the controls' readings at
the precision below the configuration's bf16.  The program's own int8
path switched on: the KV cache in int8 (serving), AdamW's int8 gradient
compression (training).  And, for a served model, the plain reference in
float8 e4m3 products (``portbench.reference.decoder``) read at the same
prompts and served tokens as the program's check: at each position,
the gap of the token it puts first.  ``--fault-seeds`` read a training
cell's planted fault (``portbench.faults``: half the batch left out).
Each reading is a JSON line on standard output.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Dict, List

from portbench import run as R


def _ints(text: str) -> List[int]:
    return [int(x) for x in text.split(",") if x]


def serve_control(conf: Dict, seed: int, device, chk: Dict) -> float:
    import torch
    from portbench import weights
    from portbench.reference import decoder
    tree = weights.draw(conf, seed, device)
    ctrl = decoder.logits_at(conf, tree, chk["seqs"], chk["want"],
                             quant="fp8")
    del tree
    gaps = []
    for ref, low in zip(chk["ref"], ctrl):
        first = low.argmax(dim=-1)
        gaps.append(float((ref.max(-1).values
                           - ref.gather(-1, first[:, None])[:, 0]).max()))
    torch.cuda.empty_cache()
    return max(gaps)


def int8_path(conf: Dict, traffic: Dict):
    """The cell's configuration and traffic with the program's own int8
    path switched on: AdamW's int8 gradient compression (training), the
    KV cache in int8 (serving)."""
    conf, traffic = (json.loads(json.dumps(x)) for x in (conf, traffic))
    if traffic["kind"] == "train":
        conf["training"]["grad_compression"] = "int8"
    else:
        traffic["engine"]["kv_dtype"] = "int8"
    return conf, traffic


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(R.ROOT / "src"))
    from portbench import faults
    from portbench.manifest import Manifest
    m = Manifest(R.ROOT)
    cell = m.cell(args.workload)
    conf, traffic, limits = m.config(cell), m.traffic(cell), m.limits(cell)

    def emit(**rec):
        print(json.dumps(rec), flush=True)

    jobs = ([(s, "program") for s in args.seeds]
            + [(s, "control") for s in args.control_seeds]
            + [(s, "fault") for s in args.fault_seeds])
    train = traffic["kind"] == "train"
    for seed, what in jobs:
        with (faults.half_batch() if what == "fault"
              else contextlib.nullcontext()):
            out = R.run_cell(conf, traffic, limits, seed=seed,
                             seconds=args.seconds, trace=False,
                             device="cuda")
        emit(workload=cell.name, seed=seed, side=what if what == "fault"
             else "program", numbers=out["compared"],
             attempted=out["attempted"], failed=out["failed"],
             metrics=out["metrics"])
        if what == "control" and not train:
            emit(workload=cell.name, seed=seed, side="reference in fp8",
                 numbers={"max_logit_gap": serve_control(
                     conf, seed, "cuda", out["check"])})
        del out
        if what == "control":
            out = R.run_cell(*int8_path(conf, traffic), limits, seed=seed,
                             seconds=args.seconds, trace=False,
                             device="cuda")
            emit(workload=cell.name, seed=seed, side="program int8",
                 numbers=out["compared"])
            del out
    return 0


if __name__ == "__main__":
    sys.exit(main())
