"""``python -m repro_torch`` — the Scenario→Report pipeline as a CLI.

    python -m repro_torch forecast --model llama2-7b --variant bf16-int4-kv4 \\
        --hw tpu-v5e --prompt 2048 --gen 256 [--json]
    python -m repro_torch measure  --model llama2-7b --attn-impl paged \
        --batch 4 --prompt 512 --gen 64 --chunk 256   # on the card
    python -m repro_torch measure  --model qwen2-7b --reduced --prompt 64 \
        --gen 32 --device cpu
    python -m repro_torch sweep    --model llama2-7b --hw cpu,v100,v5e --prompt 512
    python -m repro_torch sweep    --model llama2-7b --tops 10,50,100 --bw 100,800
    python -m repro_torch compare  forecast.json measured.json
    python -m repro_torch measure  --model qwen2-7b --reduced --arrival poisson \\
        --qps 4 --ttft-slo 0.5 --tpot-slo 0.05      # SLO goodput, measured
    python -m repro_torch capacity --model llama2-7b --hw tpu-v5e --batch 8 \\
        --arrival poisson --qps 1 --ttft-slo 0.5    # max QPS within SLO

Every subcommand prints a human table by default or the Report's stable
JSON with ``--json`` (pipe into a file to feed ``compare`` later).
A copy of the JAX package's CLI: ``measure`` runs the port's engine on
``--device`` (the card unless ``--device cpu`` is given), and the
compile-time ``audit`` is not ported (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch import api
from repro_torch.core import hardware
from repro_torch.core.workload import ENGINE_ATTN_IMPLS


# ---------------------------------------------------------------------------
# argument plumbing
# ---------------------------------------------------------------------------

def _csv(text: str) -> List[str]:
    return [t for t in (s.strip() for s in text.split(",")) if t]


def _csv_floats(text: str) -> List[float]:
    return [float(t) for t in _csv(text)]


def _csv_ints(text: str) -> List[int]:
    return [int(t) for t in _csv(text)]


def _add_scenario_args(p: argparse.ArgumentParser, measured: bool) -> None:
    p.add_argument("--model", required=True,
                   help="architecture name (see repro_torch.configs.ARCHS)")
    p.add_argument("--variant", default="bf16-bf16",
                   help="optimization variant (paper Table 3 name)")
    p.add_argument("--batch", type=int, default=1,
                   help="concurrent sequences (engine slots)")
    p.add_argument("--prompt", type=int, default=512, dest="prompt_len",
                   help="prompt tokens per request")
    p.add_argument("--gen", type=int, default=128, dest="gen_len",
                   help="generation budget per request")
    p.add_argument("--chunk", type=int, default=None,
                   help="chunked-prefill chunk size (default: one shot)")
    p.add_argument("--past-lens", type=_csv_ints, default=None,
                   metavar="L1,L2,...",
                   help="per-slot KV lengths of a mixed decode batch")
    p.add_argument("--lora-rank", type=int, default=None,
                   help="include a one-time LoRA merge of this rank")
    p.add_argument("--lora-tenants", type=int, default=0,
                   dest="lora_n_tenants",
                   help="serve this many LoRA tenants through the grouped "
                   "adapter pool (0 = off); forecast prices the per-slot "
                   "rank mix, measure runs the grouped-LoRA engine")
    p.add_argument("--lora-ranks", type=_csv_ints, default=None,
                   metavar="R1,R2,...", dest="lora_ranks",
                   help="adapter ranks tenants cycle through "
                   "(default: 8 for every tenant)")
    p.add_argument("--lora-popularity", type=float, default=0.0,
                   dest="lora_popularity",
                   help="Zipf exponent of the tenant popularity law "
                   "(0 = uniform traffic across tenants)")
    p.add_argument("--shared-prefix", type=int, default=None,
                   dest="shared_prefix_len",
                   help="leading prompt tokens shared by all requests "
                   "(common system prompt; served from shared KV blocks)")
    p.add_argument("--block-size", type=int, default=None,
                   help="KV block size of the paged cache (default: "
                   "engine default)")
    p.add_argument("--no-prefix-cache", action="store_false",
                   dest="prefix_cache",
                   help="disable radix prefix caching (cache-cold)")
    p.add_argument("--attn-impl",
                   choices=tuple(i for i in ENGINE_ATTN_IMPLS if i),
                   default=None, dest="attn_impl",
                   help="engine attention read path to measure/price: "
                   "gather (page rematerialization) or paged (paged "
                   "flash kernels); default: plain analytical "
                   "scenario / engine default")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: forecasts price per-chip "
                   "work + collective traffic (interconnect_GBps); measure "
                   "runs tp x pp ranks, one per card (gloo ranks with "
                   "--device cpu)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel degree: forecasts partition the "
                   "layer stack into stages (prefill microbatch bubbles + "
                   "inter-stage activation hops priced); measure runs "
                   "its stages as ranks, as for --tp")
    p.add_argument("--spec-k", type=int, default=0, dest="spec_k",
                   help="speculative decoding: drafts verified per step "
                   "(0 = off); measure runs the engine's draft→verify→"
                   "accept loop, forecast prices the (k+1)-query verify")
    p.add_argument("--spec-acceptance", type=float, default=0.7,
                   dest="spec_acceptance",
                   help="assumed per-draft acceptance rate α for the "
                   "forecast (measured runs record the realized rate)")
    p.add_argument("--spec-draft", default=None, dest="spec_draft_arch",
                   help="draft architecture name (default: free "
                   "self-speculative n-gram prompt lookup)")
    p.add_argument("--prompt-motif", type=int, default=None,
                   dest="prompt_motif_len",
                   help="measured prompts repeat a motif of this many "
                   "tokens (high-acceptance speculative workload)")
    p.add_argument("--reduced", action="store_true",
                   help="use the CPU-sized reduced config")
    # stochastic traffic (repro_torch.traffic): same flags on both runners so one
    # command line measures AND forecasts the same seeded arrival stream
    p.add_argument("--arrival", default=None,
                   choices=("deterministic", "poisson", "bursty", "replay"),
                   help="serve an open-loop arrival stream of this process "
                   "(replay loads --trace-file) and report SLO goodput")
    p.add_argument("--qps", type=float, default=0.0,
                   help="offered request rate for --arrival (requests/s)")
    p.add_argument("--ttft-slo", type=float, default=None, dest="ttft_slo",
                   help="TTFT SLO seconds (judged queue-inclusive)")
    p.add_argument("--tpot-slo", type=float, default=None, dest="tpot_slo",
                   help="per-request mean TPOT SLO seconds")
    p.add_argument("--trace-file", default=None, dest="trace_file",
                   help="TrafficTrace JSONL to replay instead of generating")
    p.add_argument("--prompt-len-dist", default=None, dest="prompt_len_dist",
                   metavar="SPEC", help="per-request prompt length dist "
                   "(constant:N | uniform:LO:HI | lognormal:MED:SIGMA; "
                   "default: --prompt)")
    p.add_argument("--gen-len-dist", default=None, dest="gen_len_dist",
                   metavar="SPEC", help="per-request generation length dist "
                   "(default: --gen)")
    p.add_argument("--prefill-batch", type=int, default=1,
                   dest="prefill_batch",
                   help="bucketed batched admission width (same-bucket "
                   "requests prefill in one dispatch; 1 = sequential)")
    p.add_argument("--requests", type=int, default=None,
                   dest="n_requests", help="offered requests (default: "
                   "--batch; traffic scenarios default to 16)")
    p.add_argument("--seed", type=int, default=0)
    if measured:
        p.add_argument("--decode-block", type=int, default=8)
        p.add_argument("--temperature", type=float, default=0.0)


def _add_knob_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--ec", type=float, default=1.0,
                   help="prefill compute efficiency (Eq. 1)")
    p.add_argument("--em", type=float, default=1.0,
                   help="memory efficiency (Eqs. 2, 4)")
    p.add_argument("--decode-ec", type=float, default=None,
                   help="add the decode compute term at this efficiency")


def _scenario(args: argparse.Namespace) -> api.Scenario:
    kw = dict(model=args.model, variant=args.variant, batch=args.batch,
              prompt_len=args.prompt_len, gen_len=args.gen_len,
              chunk=args.chunk, past_lens=args.past_lens,
              lora_rank=args.lora_rank,
              shared_prefix_len=args.shared_prefix_len,
              block_size=args.block_size, prefix_cache=args.prefix_cache,
              attn_impl=args.attn_impl, tp=args.tp, pp=args.pp,
              spec_k=args.spec_k,
              spec_acceptance=args.spec_acceptance,
              spec_draft_arch=args.spec_draft_arch,
              prompt_motif_len=args.prompt_motif_len, reduced=args.reduced,
              lora_n_tenants=args.lora_n_tenants,
              lora_ranks=tuple(args.lora_ranks or ()),
              lora_popularity=args.lora_popularity)
    for name in ("n_requests", "decode_block", "temperature", "seed",
                 "arrival", "qps", "ttft_slo", "tpot_slo", "trace_file",
                 "prompt_len_dist", "gen_len_dist", "prefill_batch"):
        if hasattr(args, name):
            kw[name] = getattr(args, name)
    return api.Scenario(**kw)


# ---------------------------------------------------------------------------
# table rendering
# ---------------------------------------------------------------------------

def _fmt_si(v: float, unit: str) -> str:
    for scale, prefix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(v) >= scale:
            return f"{v / scale:8.2f} {prefix}{unit}"
    return f"{v:8.2f}  {unit}"


def _print_report(r: api.Report) -> None:
    scn = r.scenario
    traffic = (f"batch={scn.get('batch')} prompt={scn.get('prompt_len')} "
               f"gen={scn.get('gen_len')}")
    if scn.get("chunk"):
        traffic += f" chunk={scn['chunk']}"
    if scn.get("past_lens"):
        traffic += f" past_lens={scn['past_lens']}"
    if scn.get("shared_prefix_len"):
        traffic += (f" shared_prefix={scn['shared_prefix_len']}"
                    f"×{scn.get('n_requests') or scn.get('batch')}req")
    if scn.get("attn_impl"):
        traffic += f" attn={scn['attn_impl']}"
    if scn.get("tp", 1) > 1:
        traffic += f" tp={scn['tp']}"
    if scn.get("pp", 1) > 1:
        traffic += f" pp={scn['pp']}"
    if scn.get("lora_n_tenants"):
        ranks = ",".join(map(str, scn.get("lora_ranks") or ()))
        traffic += f" lora={scn['lora_n_tenants']}ten(r{ranks})"
    if scn.get("spec_k"):
        traffic += f" spec_k={scn['spec_k']}"
        if scn.get("spec_draft_arch"):
            traffic += f" draft={scn['spec_draft_arch']}"
    if scn.get("arrival"):
        traffic += f" arrival={scn['arrival']}"
        if scn.get("qps"):
            traffic += f"@{scn['qps']:g}qps"
    print(f"[{r.source}] {r.model} · {r.variant} · {r.hardware}  ({traffic})")
    bound = f"  ({r.ttft_bound}-bound)" if r.ttft_bound else ""
    print(f"  TTFT  {r.ttft_s * 1e3:12.2f} ms{bound}")
    bound = f"  ({r.tpot_bound}-bound)" if r.tpot_bound else ""
    print(f"  TPOT  {r.tpot_s * 1e3:12.3f} ms{bound}")
    print(f"  TPS   {r.tps:12.1f} tok/s")
    for name, ph in r.phases.items():
        print(f"  {name:12s}{_fmt_si(ph.ops, 'OPs')}  "
              f"{_fmt_si(ph.mem_total, 'B')}  {ph.dispatches:7d} dispatches")
    extras = dict(r.extras or {})
    tr = extras.pop("traffic", None)
    if tr:
        def pct(d):
            return (f"p50 {d['p50'] * 1e3:8.2f}  p90 {d['p90'] * 1e3:8.2f}"
                    f"  p99 {d['p99'] * 1e3:8.2f} ms")
        print(f"  traffic: {tr.get('arrival')} @ {tr.get('qps', 0):g} qps "
              f"(offered {tr.get('offered_qps', 0):.3g}), "
              f"{tr.get('n_requests')} requests over "
              f"{tr.get('duration_s', 0):.3g} s")
        print(f"    ttft        {pct(tr['ttft'])}")
        print(f"    ttft_queued {pct(tr['ttft_queued'])}")
        print(f"    tpot        {pct(tr['tpot'])}")
        print(f"    queue depth mean {tr.get('queue_depth_mean', 0):.2f} "
              f"max {tr.get('queue_depth_max', 0)}")
        if tr.get("goodput") is not None:
            slo = ", ".join(
                f"{k}={tr[k]:g}s" for k in ("ttft_slo", "tpot_slo")
                if tr.get(k) is not None)
            print(f"    goodput {tr['goodput']:.3f} "
                  f"({tr.get('good_qps', 0):.3g} good qps) under {slo}")
    knobs = f"  knobs: ec={r.ec:g} em={r.em:g}"
    if extras:
        knobs += "   " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in extras.items())
    print(knobs)


def _print_delta(d: api.ReportDelta) -> None:
    print(f"{d.model} · {d.variant}:  forecast[{d.forecast_hw}] vs "
          f"measured[{d.measured_hw}]")
    print(f"  {'metric':8s}{'forecast':>14s}{'measured':>14s}{'ratio':>9s}"
          f"{'rel err':>9s}")
    for name, m, unit in (("TTFT", d.ttft, "ms"), ("TPOT", d.tpot, "ms"),
                          ("TPS", d.tps, "tok/s")):
        scale = 1e3 if unit == "ms" else 1.0
        print(f"  {name:8s}{m.forecast * scale:12.3f} {unit:<3s}"
              f"{m.measured * scale:10.3f} {unit:<3s}{m.ratio:9.2f}"
              f"{m.rel_err:+9.1%}")
    print(f"  worst |rel err|: {d.worst_abs_error:.1%}")


def _emit(obj, as_json: bool, printer) -> None:
    if as_json:
        print(json.dumps(obj.to_dict() if hasattr(obj, "to_dict") else obj,
                         indent=1))
    else:
        printer(obj)


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def _cmd_forecast(args) -> int:
    r = api.forecast(_scenario(args), args.hw, ec=args.ec, em=args.em,
                     decode_ec=args.decode_ec)
    _emit(r, args.json, _print_report)
    return 0


def _cmd_measure(args) -> int:
    r = api.measure(_scenario(args), hw=args.hw, device=args.device)
    _emit(r, args.json, _print_report)
    return 0


def _cmd_sweep(args) -> int:
    if not args.hw and not (args.tops and args.bw):
        print("sweep: pass --hw and/or both --tops and --bw",
              file=sys.stderr)
        return 2
    reports = api.sweep(_scenario(args), args.hw or None, tops=args.tops,
                        bw=args.bw, interconnect_GBps=args.interconnect,
                        tp_degrees=args.tp_grid, pp_degrees=args.pp_grid,
                        ec=args.ec, em=args.em, decode_ec=args.decode_ec)
    if args.json:
        print(json.dumps([r.to_dict() for r in reports], indent=1))
        return 0
    plan_grid = args.tp_grid is not None or args.pp_grid is not None
    plan_hdr = f"{'plan':>10s}" if plan_grid else ""
    print(f"{'hardware':26s}{plan_hdr}{'TTFT ms':>12s}{'TPOT ms':>12s}"
          f"{'TPS':>12s}  bound")
    for r in reports:
        plan = (f"{'tp' + str(r.scenario['tp']) + 'xpp' + str(r.scenario['pp']):>10s}"
                if plan_grid else "")
        print(f"{r.hardware:26s}{plan}{r.ttft_s * 1e3:12.2f}"
              f"{r.tpot_s * 1e3:12.3f}{r.tps:12.1f}  {r.ttft_bound}")
    return 0


def _cmd_capacity(args) -> int:
    scn = _scenario(args)
    if not scn.has_traffic:
        # default the process so `capacity --ttft-slo ...` just works
        scn = scn.traffic("poisson", qps=max(args.qps, 1.0),
                          ttft_slo=args.ttft_slo, tpot_slo=args.tpot_slo,
                          prompt_len_dist=args.prompt_len_dist,
                          gen_len_dist=args.gen_len_dist,
                          prefill_batch=args.prefill_batch)
    mq = api.max_qps(scn, args.hw, goodput_target=args.goodput_target,
                     qps_hi=args.qps_hi, ec=args.ec, em=args.em,
                     decode_ec=args.decode_ec)
    if args.json:
        print(json.dumps({"hardware": args.hw, "max_qps": mq,
                          "goodput_target": args.goodput_target,
                          "scenario": scn.to_dict()}, indent=1))
    else:
        print(f"max_qps[{args.hw}] = {mq:.4g} requests/s "
              f"(goodput >= {args.goodput_target:g})")
    return 0


def _cmd_compare(args) -> int:
    def load(path: str) -> api.Report:
        with open(path) as f:
            return api.Report.from_json(f.read())

    d = api.compare(load(args.forecast), load(args.measured))
    _emit(d, args.json, _print_delta)
    return 0


def _cmd_hardware(args) -> int:
    print(f"{'name':26s}{'compute':>13s}{'mem bw':>14s}{'interconnect':>17s}")
    for name in hardware.list():
        spec = hardware.get(name)
        ici = (f"{spec.interconnect_GBps:12.1f} GB/s"
               if spec.interconnect_GBps else f"{'—':>16s}")
        print(f"{name:26s}{spec.tops:8.1f} TOPS{spec.bw_gbps:9.1f} GB/s"
              f"{ici}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="LIFE Scenario→Report forecasting pipeline")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("forecast", help="analytical forecast (Eqs. 1-6)")
    _add_scenario_args(p, measured=False)
    _add_knob_args(p)
    p.add_argument("--hw", required=True,
                   help="hardware name or alias (see `hardware` subcommand)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_forecast)

    p = sub.add_parser("measure", help="run the real engine on the card")
    _add_scenario_args(p, measured=True)
    p.add_argument("--hw", default=None, help="label only; the run is on "
                   "--device")
    p.add_argument("--device", default="cuda",
                   help="torch device the engine runs on (default: the "
                   "card; pass cpu to run on the host explicitly)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_measure)

    p = sub.add_parser("sweep", help="forecast across hardware targets")
    _add_scenario_args(p, measured=False)
    _add_knob_args(p)
    p.add_argument("--hw", type=_csv, default=[],
                   help="comma-separated hardware names/aliases")
    p.add_argument("--tops", type=_csv_floats, default=None,
                   help="grid TOPS values (with --bw)")
    p.add_argument("--bw", type=_csv_floats, default=None,
                   help="grid bandwidth GB/s values (with --tops)")
    p.add_argument("--interconnect", type=float, default=None,
                   help="grid interconnect GB/s (required for sharded "
                   "tops×bw grid sweeps)")
    p.add_argument("--tp-grid", type=_csv_ints, default=None, dest="tp_grid",
                   metavar="T1,T2,...",
                   help="also sweep tensor-parallel degrees (crossed with "
                   "--pp-grid; every plan × every hardware target)")
    p.add_argument("--pp-grid", type=_csv_ints, default=None, dest="pp_grid",
                   metavar="P1,P2,...",
                   help="also sweep pipeline-parallel degrees")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_sweep)

    p = sub.add_parser("capacity",
                       help="largest QPS whose forecast goodput meets a "
                       "target (traffic bisection)")
    _add_scenario_args(p, measured=False)
    _add_knob_args(p)
    p.add_argument("--hw", required=True,
                   help="hardware name or alias (see `hardware` subcommand)")
    p.add_argument("--goodput-target", type=float, default=0.99,
                   dest="goodput_target",
                   help="required fraction of requests meeting the SLO pair")
    p.add_argument("--qps-hi", type=float, default=None, dest="qps_hi",
                   help="cap the bisection bracket at this rate")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_capacity)

    p = sub.add_parser("compare",
                       help="diff two report JSON files (forecast, measured)")
    p.add_argument("forecast", help="forecast report JSON path")
    p.add_argument("measured", help="measured report JSON path")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_compare)

    p = sub.add_parser("hardware", help="list known hardware specs")
    p.set_defaults(fn=_cmd_hardware)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except (KeyError, ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
