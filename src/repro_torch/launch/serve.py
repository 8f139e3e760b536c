"""Serving launcher of the port — continuous batching on one GPU.

    python -m repro_torch.launch.serve --arch llama2-7b --attn-impl paged
    python -m repro_torch.launch.serve --arch llama2-7b --spec-k 4 \
        --lora-tenants 4 --lora-ranks 8,16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --reduced --device cpu --requests 3 --max-slots 2 --prompt-len 16 \
        --new-tokens 6 --chunk 8 --spec-k 2 --prefill-batch 2 \
        --lora-tenants 2 --lora-ranks 4,8

Mirrors the engine path of ``python -m repro.launch.serve``: random weights
from a seeded generator, a synthetic request stream, warm-up outside the
measured window, then the measured per-request TTFT/TPOT and the
aggregate TPS.  ``--spec-k``, ``--prefill-batch`` and ``--lora-tenants``
/ ``--lora-ranks`` / ``--lora-slots`` turn on speculative decoding
(n-gram drafter), bucketed batched admission and multi-tenant LoRA (the
fields ``repro.api.measure`` passes to the reference engine); tenants are
assigned round-robin, and the last request uses the base model.  It
prints measured numbers only; the analytical twin's forecast needs the
analytical half, which the port does not have yet.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.configs import Variant
from repro_torch.core import hardware
from repro_torch.engine import Engine, EngineConfig, ForecastTwin, Request
from repro_torch.models import init_params


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--arch", choices=sorted(configs.ARCHS), required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--max-slots", type=int, default=4)
    p.add_argument("--decode-block", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--new-tokens", type=int, default=32)
    p.add_argument("--max-len", type=int, default=0)
    p.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"])
    p.add_argument("--chunk", type=int, default=0, help="chunked prefill size")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--attn-impl", default="paged", choices=["gather", "paged"])
    p.add_argument("--spec-k", type=int, default=0,
                   help="draft tokens verified per step (0 = off)")
    p.add_argument("--prefill-batch", type=int, default=1,
                   help="bucketed batched admission width (1 = off)")
    p.add_argument("--lora-tenants", type=int, default=0,
                   help="LoRA tenants served from the adapter pool (0 = off)")
    p.add_argument("--lora-ranks", default="8",
                   help="comma list; tenant t has rank ranks[t %% len]")
    p.add_argument("--lora-slots", type=int, default=None,
                   help="resident adapters (default: one per engine slot)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hw", default="nvidia-h100",
                   help="hardware the LIFE twin forecasts the schedule for")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    full_cfg = configs.get(args.arch)
    cfg = configs.reduced(full_cfg) if args.reduced else full_cfg
    params = init_params(cfg, args.seed, device=device)
    max_len = args.max_len or (args.prompt_len + args.new_tokens + 16)
    ec = EngineConfig(max_slots=args.max_slots, max_len=max_len,
                      chunk_size=args.chunk or args.prompt_len,
                      decode_block=args.decode_block,
                      kv_dtype=args.kv_dtype, temperature=args.temperature,
                      attn_impl=args.attn_impl, seed=args.seed,
                      spec_k=args.spec_k, prefill_batch=args.prefill_batch,
                      lora_tenants=args.lora_tenants,
                      lora_ranks=tuple(int(r) for r in
                                       args.lora_ranks.split(",") if r),
                      lora_slots=args.lora_slots)
    rng = np.random.default_rng(args.seed + 1)
    prompts = rng.integers(0, cfg.vocab_size, (args.requests, args.prompt_len))
    # tenants round-robin; the last request is served by the base model
    aids = [(i % args.lora_tenants if args.lora_tenants
             and i < args.requests - 1 else None)
            for i in range(args.requests)]
    reqs = [Request(rid=i, prompt=prompts[i].tolist(),
                    max_new=args.new_tokens, adapter_id=aids[i])
            for i in range(args.requests)]
    eng = Engine(cfg, params, ec, device=device)
    eng.warmup()          # kernel build and allocator growth stay outside
    results = eng.run(reqs)

    # LIFE twin: replay the schedule the engine just executed, on the target
    spec = hardware.get(args.hw)
    variant = Variant(kv_dtype=args.kv_dtype, fused=True)
    fcst = ForecastTwin(full_cfg, spec, variant, em=0.8).replay(eng.trace)
    print(f"[LIFE twin → {spec.name}] {full_cfg.name}: "
          f"forecast TPS={fcst.tps:.1f}  mean TTFT={fcst.mean_ttft*1e3:.1f}ms"
          f"  mean TPOT={fcst.mean_tpot*1e3:.2f}ms  (em=0.8, same trace)")
    for r in results:
        f = fcst.requests.get(r.rid)
        print(f"  req {r.rid}: {len(r.tokens)} toks  "
              f"ttft={r.ttft * 1e3:8.2f}ms  tpot={r.tpot * 1e3:7.3f}ms  "
              f"cached={r.cached_tokens}  | forecast ttft="
              f"{f.ttft * 1e3:6.2f}ms tpot={f.tpot * 1e3:5.2f}ms")
    summary = {
        "mode": "engine", "arch": cfg.name, "attn_impl": args.attn_impl,
        "kv_dtype": args.kv_dtype, "requests": args.requests,
        "max_slots": args.max_slots,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "ttft_p50_ms": float(np.median([r.ttft for r in results]) * 1e3),
        "tpot_p50_ms": float(np.median([r.tpot for r in results]) * 1e3),
        "tps": eng.aggregate_tps(),
        "prefix_hit_rate": eng.prefix_hit_rate,
        "trace_events": len(eng.trace),
        "forecast_hw": spec.name,
        "forecast_tps": fcst.tps,
        "forecast_ttft_mean_ms": fcst.mean_ttft * 1e3,
        "forecast_tpot_mean_ms": fcst.mean_tpot * 1e3,
    }
    if args.spec_k:
        summary["spec_acceptance"] = eng.spec_acceptance
        summary["spec_tokens_per_step"] = eng.spec_tokens_per_step
    if args.lora_tenants:
        summary["adapter_hit_rate"] = eng.adapter_hit_rate
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
