"""Time K6's wide tensor-core forward (``flash_fwd_mma_wide_kernel``, bf16
at 128 < d <= 256) at other warp and key-tile counts than the source's,
on the card, at recurrentgemma-2b's lockstep shapes.

Each variant is the repo's ``csrc/flash_attention.cu`` with its
``kWideWarps`` / ``kWideKeys`` constants replaced, built by ``nvcc``
(all at once, the repo's flags) into ``build/sweep_flash_wide/``; the
script prints the register and spill use of each variant's tensor-core
forward kernels as ``ptxas`` reports them, holds each variant's output
to the plain version (``kernel_tolerance``), and times every variant,
the ``fma`` body and SDPA with a boolean mask in turns in one process
(CUDA events, 20 calls after 3 warm-up ones; the variants' order
reversed in a second round), and writes a JSON summary to ``--out``.

    python tools/sweep_flash_wide.py [--variants 8x64,8x32,4x64,4x32]
        [--out build/sweep_flash_wide/summary.json]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: (b, s, L, H, Hk, d, causal, window, q_offset): chip_smoke.py's
#: K6_LOCKSTEP and K6_LOCKSTEP_TP2 shapes of recurrentgemma-2b
SHAPES = {"lockstep": (4, 2048, 2048, 10, 1, 256, True, 2048, 0),
          "lockstep tp=2 rank": (4, 2048, 2048, 5, 1, 256, True, 2048, 0)}


def build_source(consts: dict, tag: str, kernel: str):
    """The source with each ``constexpr int`` named in ``consts`` set to
    its value, built into ``build/sweep_flash_wide/lib<tag>.so``; returns
    (library path, ptxas's name, register and spill lines for each kernel
    whose name matches the pattern ``kernel``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    src = ops.SOURCE.read_text()
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"{name} not found once in {ops.SOURCE}")
    out = ROOT / "build" / "sweep_flash_wide"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{tag}.cu"
    cu.write_text(src)
    lib = out / f"lib{tag}.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n"
                           f"{proc.stdout}{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    ptxas = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and re.search(kernel, line):
            name = re.search(rf"(?:{kernel})\w*?Li\d+E(Li\d+E)*", line)
            ptxas += [name.group(0) if name else line.strip()]
            ptxas += [x.strip() for x in lines[i + 1:i + 4]
                      if "Used" in x or "spill" in x]
    return lib, ptxas


def build_variant(warps: int, keys: int):
    """The source with the wide forward's tiles replaced, built; returns
    (library path, each tensor-core forward kernel's name and ptxas
    register and spill lines)."""
    return build_source({"kWideWarps": warps, "kWideKeys": keys},
                        f"flash_{warps}x{keys}", "flash_fwd_mma")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="8x64,8x32,4x64,4x32",
                    help="warps x keys per tile, comma-separated")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "sweep_flash_wide" /
                    "summary.json", help="where the JSON summary goes")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sweep_flash_wide: needs a CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.paged_attention.ref import kernel_tolerance
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
        print(f"[sweep] {v[0]} warps x {v[1]} keys: " + "; ".join(ptxas))
        lib = ctypes.CDLL(str(path))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd_mma_launch.argtypes = [P] * 5 + [I] * 9 + [
            ctypes.c_float, P]
        libs[v] = lib
    dev = torch.device("cuda", 0)
    summary = {"card": smi, "shapes": {}}
    for name, case in SHAPES.items():
        b, s, L, H, Hk, d, causal, window, q_offset = case
        gen = torch.Generator(device=dev)
        gen.manual_seed(11)
        mk = lambda *shape: torch.randn(shape, generator=gen,
                                        device=dev).to(torch.bfloat16)
        q, k, v = mk(b, s, H, d), mk(b, L, Hk, d), mk(b, L, Hk, d)
        o = torch.empty_like(q)
        lse = torch.empty((b, H, s), dtype=torch.float32, device=dev)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        want = ops.attention_ref(q, k, v, **kw)
        limit = kernel_tolerance(want, v)
        stream = torch.cuda.current_stream().cuda_stream

        def launch(lib):
            err = lib.flash_fwd_mma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b, s, L, H, Hk, d, int(causal), window or 0,
                q_offset, d ** -0.5, stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")

        def events(fn, iters=20, warmup=3):
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

        ratios = {}
        for var, lib in libs.items():
            launch(lib)
            torch.cuda.synchronize()
            ratios[var] = float(((o.float() - want.float()).abs()
                                 / limit).max())
        del want, limit
        qp = q_offset + torch.arange(s, device=dev)[:, None]
        kp = torch.arange(L, device=dev)[None, :]
        mask = (kp <= qp) & ((kp > qp - window) if window else True)
        ql, kl, vl = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=mask[None, None], enable_gqa=Hk != H)
        times = {var: [] for var in libs}
        order = list(libs)
        for round_ in (order, order[::-1]):
            for var in round_:
                times[var].append(events(lambda: launch(libs[var])))
        fma = events(lambda: ops.flash_fwd(q, k, v, body="fma", **kw),
                     iters=5, warmup=1)
        lib_ms = events(sdpa)
        rec = {"case": case, "fma_ms": fma, "sdpa_mask_ms": lib_ms,
               "variants": {f"{w}x{kk}": {"ms": times[(w, kk)],
                                          "err_ratio": ratios[(w, kk)],
                                          "ptxas": built[(w, kk)][1]}
                            for w, kk in libs}}
        summary["shapes"][name] = rec
        for var in libs:
            print(f"[sweep] {name} {case}: {var[0]} warps x {var[1]} keys "
                  f"{'/'.join(f'{t:.4f}' for t in times[var])} ms, "
                  f"err/limit {ratios[var]:.4f}")
        print(f"[sweep] {name}: fma {fma:.4f} ms, SDPA with a boolean "
              f"mask {lib_ms:.4f} ms")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(summary, indent=1))
    bad = [(n, v) for n, r in summary["shapes"].items()
           for v, x in r["variants"].items() if x["err_ratio"] > 1.0]
    if bad:
        print(f"[sweep] outside kernel_tolerance: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
