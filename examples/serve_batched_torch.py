"""Serve a stream of requests through the port's continuous-batching
engine (``repro_torch``, PyTorch and CUDA), the counterpart of
``examples/serve_batched.py``: chunked-prefill admission (§3.3.4), int8
block-paged KV cache (§3.3.3), radix prefix caching (shared system
prompts mapped onto shared KV blocks), greedy and sampled decoding, via
the Scenario→Report API.  Each measured run's own scheduler trace is
replayed through the analytical twin (``api.forecast(..., trace=...)``)
on the hardware that was measured, and the measured-vs-forecast delta is
one ``api.compare`` call.

On the card (the default) it serves qwen2-7b at full width through the
paged attention kernels; ``--device cpu --reduced`` serves the reduced
config on the host.  Without a GPU it raises unless ``--device cpu`` is
given.

The ``shared system prompt`` mode is the paper's "local agent" traffic:
every request opens with the same 32-token prefix, so warm admissions map
the shared blocks from the radix index and prefill only their suffix —
the measured hit rate and the twin's forecast hit rate come from the same
trace and must agree.

    PYTHONPATH=src python examples/serve_batched_torch.py
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu --reduced
"""
import argparse
import dataclasses

from repro_torch import api, resolve_device
from repro_torch.configs.base import Variant

#: the full model's deployment target: the card the port runs on
DEPLOY_HW = "nvidia-h100"


def scenarios(reduced: bool):
    """The reference's five scenarios: 6 requests over 3 slots with
    staggered budgets, so slots free mid-flight and are reused by the
    queue (continuous batching, not lockstep)."""
    base = api.Scenario(
        model="qwen2-7b", reduced=reduced, batch=3, prompt_len=64,
        gen_len=24, gen_lens=tuple(24 - 4 * (i % 3) for i in range(6)),
        attn_impl="paged")
    return [
        ("baseline bf16-KV", base),
        ("chunked admission(16)", dataclasses.replace(base, chunk=16)),
        ("int8 KV blocks", dataclasses.replace(
            base, variant=Variant(name="bf16-int8kv", kv_dtype="int8",
                                  fused=True))),
        ("sampled T=0.8", dataclasses.replace(base, temperature=0.8)),
        ("shared system prompt", dataclasses.replace(
            base, shared_prefix_len=32, block_size=16, chunk=16)),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced config (CPU-sized)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # the same-schedule twin prices the hardware that was measured
    twin_hw = DEPLOY_HW if dev.type == "cuda" else "cpu"
    for label, scn in scenarios(args.reduced):
        measured = api.measure(scn, device=dev)
        twin = api.forecast(scn, twin_hw, em=0.8, trace=measured.trace)
        full = api.forecast(dataclasses.replace(scn, reduced=False),
                            DEPLOY_HW, em=0.8, trace=measured.trace)
        delta = api.compare(twin, measured)
        line = (f"{label:22s} -> {measured.extras['tokens']} toks over "
                f"{measured.extras['requests']} reqs on {scn.batch} slots  "
                f"{dev.type} {measured.tps:6.1f} tok/s "
                f"({twin_hw}-twin ratio {delta.tps.ratio:5.1f}x)  "
                f"[full model→{DEPLOY_HW}: {full.tps:7.1f} tok/s, "
                f"ttft {full.ttft_s*1e3:5.1f}ms, "
                f"tpot {full.tpot_s*1e3:5.2f}ms]")
        if scn.shared_prefix_len:
            # measured-vs-forecast hit-rate agreement comes from the shared
            # trace: the engine counted its radix hits, the twin re-derived
            # them from the cached fields of the same events
            line += (f"  [prefix hits: measured "
                     f"{measured.extras['prefix_hit_rate']:.1%} = forecast "
                     f"{full.extras['trace_prefix_hit_rate']:.1%}, "
                     f"ttft saved "
                     f"{full.extras['trace_ttft_savings_s']*1e3:.1f}ms]")
        print(line, flush=True)


if __name__ == "__main__":
    main()
