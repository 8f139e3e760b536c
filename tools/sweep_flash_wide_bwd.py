"""Time K6's wide tensor-core backward (bf16 at 128 < d <= 256:
``flash_bwd_dkdv_mma_wide_kernel`` and ``flash_bwd_dq_mma_kernel`` at
``kWideDqWarps`` warps) at other tilings than the source's, on the card,
at recurrentgemma-2b's training shape (b=1, s=L=4096, H=10, Hk=1, d=256,
causal, window 2048) and a lockstep one.

A variant is ``SxRxW``: ``kWideBwdSplit`` warps sharing each 16 keys,
``kWideBwdRows`` query rows per dK/dV step and ``kWideDqWarps`` dQ
warps.  Each is the repo's ``csrc/flash_attention.cu`` with those
constants replaced, built by ``nvcc`` (all at once, the repo's flags)
into ``build/sweep_flash_wide/``; the script prints the registers and
spills ``ptxas`` reports for the wide backward kernels, holds each
variant's dq, dk, dv to autograd through the plain version (relative
norm 2e-2, the card's bf16 limit), and times every variant, the ``fma``
body and SDPA's backward with a boolean mask in turns in one process
(CUDA events, 10 calls after 2 warm-up ones; the variants' order
reversed in a second round), and writes a JSON summary to ``--out``.

    python tools/sweep_flash_wide_bwd.py [--variants 2x64x8,2x32x8,1x32x8,2x64x4]
        [--out build/sweep_flash_wide/bwd_summary.json]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

#: (b, s, L, H, Hk, d, causal, window, q_offset): chip_smoke.py's
#: training shape of recurrentgemma-2b's local layers and K6_LOCKSTEP's
SHAPES = {"train": (1, 4096, 4096, 10, 1, 256, True, 2048, 0),
          "lockstep": (4, 2048, 2048, 10, 1, 256, True, 2048, 0)}
LIMIT = 2e-2


def build_variant(split: int, rows: int, dq_warps: int):
    from sweep_flash_wide import build_source
    return build_source({"kWideBwdSplit": split, "kWideBwdRows": rows,
                         "kWideDqWarps": dq_warps},
                        f"bwd_{split}x{rows}x{dq_warps}",
                        "flash_bwd_dkdv_mma_wide|flash_bwd_dq_mma_kernelILi256")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="2x64x8,2x32x8,1x32x8,2x64x4",
                    help="split x rows x dQ warps, comma-separated")
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help=f"comma list of {tuple(SHAPES)}")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "sweep_flash_wide" /
                    "bwd_summary.json", help="where the JSON summary goes")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sweep_flash_wide_bwd: needs a CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    variants = [tuple(int(x) for x in v.split("x"))
                for v in args.variants.split(",")]
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(lambda v: build_variant(*v),
                                            variants)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[sweep] {torch.cuda.get_device_name(0)}; {smi}")
    libs = {}
    for v, (path, ptxas) in built.items():
        print(f"[sweep] {'x'.join(map(str, v))}: " + "; ".join(ptxas))
        lib = ctypes.CDLL(str(path))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.flash_bwd_mma_launch.argtypes = [P] * 10 + [I] * 9 + [
            ctypes.c_float, P]
        libs[v] = lib
    dev = torch.device("cuda", 0)
    summary = {"card": smi, "shapes": {}}

    def events(fn, iters=10, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / iters

    for name in args.shapes.split(","):
        case = SHAPES[name]
        b, s, L, H, Hk, d, causal, window, q_offset = case
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        gen = torch.Generator(device=dev)
        gen.manual_seed(11)
        mk = lambda *shape: torch.randn(shape, generator=gen,
                                        device=dev).to(torch.bfloat16)
        q, k, v, do = mk(b, s, H, d), mk(b, L, Hk, d), mk(b, L, Hk, d), \
            mk(b, s, H, d)
        o, lse = ops.flash_fwd(q, k, v, **kw)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(ops.attention_ref(*leaves, **kw), leaves,
                                   do)
        delta = torch.empty_like(lse)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        stream = torch.cuda.current_stream().cuda_stream

        def launch(lib):
            err = lib.flash_bwd_mma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                *(g.data_ptr() for g in grads), b, s, L, H, Hk, d,
                int(causal), window or 0, q_offset, d ** -0.5, stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")

        rel = {}
        for var, lib in libs.items():
            launch(lib)
            torch.cuda.synchronize()
            rel[var] = [float((g.float() - r.float()).norm()
                              / r.float().norm())
                        for g, r in zip(grads, want)]
        del want
        qp = q_offset + torch.arange(s, device=dev)[:, None]
        kp = torch.arange(L, device=dev)[None, :]
        mask = (kp <= qp) & ((kp > qp - window) if window else True)
        ql, kl, vl, dol = (t.transpose(1, 2).contiguous()
                           for t in (q, k, v, do))
        lib_leaves = [t.clone().requires_grad_() for t in (ql, kl, vl)]
        lib_out = F.scaled_dot_product_attention(
            *lib_leaves, attn_mask=mask[None, None], enable_gqa=Hk != H)
        sdpa_bwd = lambda: torch.autograd.grad(lib_out, lib_leaves, dol,
                                               retain_graph=True)
        times = {var: [] for var in libs}
        order = list(libs)
        for round_ in (order, order[::-1]):
            for var in round_:
                times[var].append(events(lambda: launch(libs[var])))
        fma = events(lambda: ops.flash_bwd(q, k, v, o, lse, do, body="fma",
                                           **kw), iters=3, warmup=1)
        lib_ms = events(sdpa_bwd)
        tag = lambda var: "x".join(map(str, var))
        summary["shapes"][name] = {
            "case": case, "fma_ms": fma, "sdpa_mask_bwd_ms": lib_ms,
            "variants": {tag(var): {"ms": times[var], "rel": rel[var],
                                    "ptxas": built[var][1]}
                         for var in libs}}
        for var in libs:
            print(f"[sweep] {name} {case}: {tag(var)} "
                  f"{'/'.join(f'{t:.4f}' for t in times[var])} ms, dq/dk/dv "
                  f"rel {'/'.join(f'{x:.3e}' for x in rel[var])}")
        print(f"[sweep] {name}: fma {fma:.4f} ms, SDPA backward with a "
              f"boolean mask {lib_ms:.4f} ms")
        del lib_out, lib_leaves
        torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(summary, indent=1))
    bad = [(n, v) for n, r in summary["shapes"].items()
           for v, x in r["variants"].items() if max(x["rel"]) > LIMIT]
    if bad:
        print(f"[sweep] above {LIMIT}: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
