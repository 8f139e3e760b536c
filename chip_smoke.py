#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --phases build,kernels

Phases, in order (any failed check exits non-zero; no phase's failure is
caught and ignored):

1. build    — nvcc builds the four kernel libraries for sm_90a, together:
              src/repro_torch/kernels/paged_attention/csrc (K1 decode, K2
              prefill, K3 verify), kernels/grouped_lora/csrc (K4),
              kernels/flash_attention/csrc (K6 forward and backward) and
              kernels/quant_matmul/csrc (K5).
2. kernels  — every kernel against its plain PyTorch version on the card,
              at the llama2-7b (Hk=32, G=1), qwen2-7b (Hk=4, G=7) and
              qwen2-moe-a2.7b (Hk=16, G=1) head shapes, d=128, bs=16,
              bf16 and int8 KV: decode cursors at 0, mid-block and on
              block seams, on the split body, a repeat
              bit-identical; prefill chunks (0, 256), (200,
              77) and (520, 3) over tables that share prefix blocks, every
              row held (padding rows too), bf16 q on the mma body and f32
              q on rows; verify with
              Q in {1, 5, 256} at cursors on and off seams and a padded
              last chunk near the table's end; grouped LoRA with mixed
              ranks and holes (idx = -1) at T in {1, 5, 256}, bf16 and f32
              x, a repeat bit-identical, and grouped_lora_qkv (q, k and v
              in one launch) against three plain calls; flash
              attention forward and backward on the reference's eight
              kernel cases (MHA, GQA, MQA, ragged s, a decode step with
              q_offset, a window, non-causal, head_dim 256) in bf16 and
              f32 and at the training shape, bf16 on both bodies (mma
              on the tensor cores, fma on the CUDA cores) where the rule
              picks mma (both directions up to d = 256), and the
              backward at recurrentgemma-2b's training shape (1 x 4096,
              10 heads over one KV head, d = 256, window 2048) on both
              bodies beside SDPA with a boolean mask; the int4
              dequant-matmul at
              every llama2-7b linear shape at m = 4, 64 and 256, one int8
              case and a ragged one (m=5, n=200, g=64) in f32 and bf16.
              Then each kernel's time (CUDA events, and device time by
              torch.profiler), its plain version's, its bound and a
              library yardstick (its device time too) at the main path's
              shapes; K1 and its yardstick also cold (each call after a
              64 MB copy, as the engine finds K/V), K1 at qwen2-7b's
              heads too, and a sweep of K1's split length.
3. engine   — the main path: llama2-7b at full width and depth (random
              bf16 weights from a seed), paged attention, 8 requests of
              512 prompt + 64 new tokens through 4 slots, with a radix
              prefix hit and a copy-on-write fork; then the same requests
              with speculative decoding (spec_k=4, n-gram drafter) and
              four LoRA tenants of ranks 8/16 plus one base-model request,
              and again with bucketed admission (prefill_batch=4) and the
              same tenants.  Each pass zeroes the launch counts before it
              and reads them after it; between them the passes launch
              K1-K4.  Every K1 launch must run on the split body, every
              bf16 K2 and K3 launch on the mma body, and K4 once for a
              layer's q, k and v and once for its output projection.
              Then a short int8-KV pass.
4. train    — the trainer: granite-3-2b at full width and depth (40
              layers, random bf16 weights from seed 0), flash attention,
              per-layer remat, AdamW, 4 x 2048 synthetic tokens, 4 steps;
              then recurrentgemma-2b at full width and depth (26 layers,
              8 of them local attention at d = 256 on K6's wide bodies,
              window 2048), 1 x 4096 tokens, 3 steps; per step its loss,
              grad norm, time, tokens/s, train_mfu, peak memory (under
              80 GB) and K6 launches (twice per attention layer forward,
              once backward, every one on the mma body, or the run
              fails).  Then at 4 layers of granite-3-2b, full width,
              a run checkpointed after step 1 and resumed equals an
              uninterrupted one bit for bit.
5. parity   — llama2-7b at full width with 4 layers and f32 weights:
              gather and paged attention give identical greedy tokens for
              bf16 and int8 KV; with f32 KV the engine's first token of
              each request equals the argmax of the dense forward pass;
              speculative decoding at T=0 gives plain greedy's tokens,
              bucketed admission gives unbucketed admission's, a
              mixed-tenant batch gives each request's tokens served
              alone, and gather equals paged with LoRA and speculation on.
              qwen2-moe-a2.7b at full width with 4 of its 24 layers, f32
              weights: gather == paged tokens in bf16 and int8 KV.
              granite-3-2b at 4 layers, full width, f32 weights: three
              training steps (two microbatches each) through the flash
              kernels equal three through eager attention.  The lockstep
              Server's greedy tokens equal the engine's (llama2-7b x4,
              f32); for falcon-mamba-7b, recurrentgemma-2b,
              llama2-7b-mla and whisper-base at 4 layers in f32, step
              fed token by token equals forward within 1e-4.
6. quant    — K5's main path: llama2-7b at full width and depth, random
              bf16 weights from seed 0; quantize_tree on the card (exactly
              embed and lm_head, as in the reference), its storage bytes
              against LIFE's int4 formula, lm_head quantized on the card
              == on the CPU bit for bit; quant_dense through K5 on lm_head
              and all 32 layers' seven projections at m = 4 and 256 (450
              launches), each held to the plain version; each shape's
              time beside LIFE's price of the int4 linear on nvidia-h100.
7. measure  — repro_torch.api.measure on llama2-7b at full width and
              depth (paged, 4 slots, 8 requests of 512 + 64, chunk 256, a
              shared 256-token prefix; K1 and K2 launch), against
              api.forecast of the same scenario for nvidia-h100, declared
              and replaying the measured trace: TTFT, TPOT and TPS with
              each relative error.
8. moe      — qwen2-moe-a2.7b at full width and depth (24 layers, 60
              routed experts of 1408, top-4, 4 shared; random bf16
              weights from seed 0, 28.6 GB): the engine phase's plain
              pass (K2, K1) and its speculative pass with four LoRA
              tenants (K2, K3, K4), each zeroing the launch counts before
              it and reading them after; TTFT, TPOT, TPS and peak memory;
              then measure against forecast as in phase 7.  The weights
              are freed.
9. vlm      — internvl2-26b at full width and depth (48 layers, d=6144,
              39.8 GB) served as text (K2, K1); one forward over 256
              vision patches + 256 tokens through K6, each layer's K6
              output held to its plain version, against the eager
              forward; the same at 4 layers in f32, flash == eager
              within 1e-5.
10. lockstep — the lockstep Server (repro_torch.runtime.serve) at full
              width and depth, random bf16 weights from seed 0, each
              model freed before the next: falcon-mamba-7b (4 x (512 +
              64), chunks of 256; a profiled decode step by class;
              api.measure against api.forecast on nvidia-h100),
              recurrentgemma-2b (4 x 2048 unchunked: its 8 local layers
              through K6's wide mma forward at d = 256, the first held
              to the plain blockwise loop; 63 decode steps on the ring),
              llama2-7b-mla (4 x (512 + 64), bf16 then int8 KV),
              whisper-base (4 x (16 + 64), 1500 encoder frames at
              prefill), llama2-7b (1 x 4096 over a 5120-position cache:
              32 K6 launches on mma, layer 0 held to the plain loop; 16
              decode steps); TTFT, TPOT, TPS, peak memory; then K6 timed
              at the two lockstep shapes on mma and on fma beside SDPA
              with a boolean mask.

11. multidevice — tensor- and pipeline-parallel serving with every rank on
              this one card (gloo on CUDA tensors, the explicit
              share_device opt-in; NCCL puts no two ranks on one card),
              one spawn per mesh shape running its worlds in turn, each
              freeing its weights before the next, the ranks' launches
              summed, each at full width and 4 layers
              (MD_LAYERS): llama2-7b at pp=2 and at tp=2 (the engine
              phase's plain pass, then its speculative pass with four
              LoRA tenants: K1 on split and bf16 K2/K3 on mma over 16
              heads a rank, K4 on 8 rank lanes; the vocabulary cut over
              the ranks), tp=2 x pp=2 and qwen2-moe-a2.7b at tp=2 (32 of
              64 padded experts a rank);
              TTFT, TPOT, TPS, each rank's shard and peak memory, ms per
              gloo collective, the share of bf16 tokens equal to tp=1's;
              at 4 layers in f32 weights every plan's tokens equal
              tp=1's with f32 KV (with bf16 and int8 KV too at pp; at tp
              their share is reported); then api.measure at tp=2 (4
              layers) against api.forecast for 2 x nvidia-h100.  Then
              the lockstep Server on a mesh (the lockstep phase's runs at
              4 layers (MDL_WORLDS), their tp=1 records served at that
              depth first): at tp=2 falcon-mamba-7b,
              recurrentgemma-2b (K6 on mma at 5 query heads over the one
              KV head), llama2-7b-mla (bf16, int8 KV), whisper-base and
              llama2-7b 1 x 4096 (K6 on mma at 16 heads), each rank's K6
              launches counted and its first held to the plain loop;
              falcon-mamba-7b at pp=2; TTFT, TPOT and TPS against tp=1's,
              ms per all_reduce or stage hop, shard and peak memory per
              rank, the share of tokens equal to tp=1's; at 4 layers in
              f32 weights tp=1's tokens exactly for falcon-mamba-7b in
              every plan, for every family at pp=2 and with f32 KV at
              tp (bf16 and int8 KV at tp: the share); then api.measure
              of falcon-mamba-7b at tp=2 (4 layers) against api.forecast
              for 2 x nvidia-h100.  The kernels phase holds K1-K4 and K6 to their
              plain versions at a tp=2 rank's shapes too.

12. trainmesh — the trainer on a mesh with every rank on this one card
              (gloo on CUDA tensors, share_device): granite-3-2b at full
              width through Trainer.run, bf16, 4 x 2048 Zipf tokens (the
              train phase's data, optimizer and seed), flash attention
              (K6 on mma at a rank's heads and rows) and remat, 3 steps,
              8 layers (TM_WORLDS), at tp=2, and at dp=2 and dp=2 x tp=2
              with FSDP: step time, tokens/s, peak memory and shard per
              rank, gloo bytes, calls and seconds per step, each rank's
              K6 launches (zeroed before its run, read after) summed; at
              2 layers (TM_PARITY_LAYERS) in f32, three steps at
              dp=2, dp=2 FSDP, tp=2, dp=2 x tp=2 FSDP and dp=2 with two
              microbatches against this process's one-rank step (loss
              1e-5 relative, params 1e-4 relative norm); a Trainer saved
              after step 1 at dp=2 x tp=2 FSDP, restored by
              restore_sharded and continued at tp=1 and tp=2, against an
              uninterrupted run.  The kernels phase holds K6 to its
              plain version and times it at the two rank shapes.

13. audit   — repro_torch.analysis.run_audit on qwen2-7b at full width:
              the single-card targets, LoRA rank 64 and tp=2 on two
              ranks sharing the card (the vocabulary cut over them),
              each step's counted work against WorkloadModel; K1-K3
              launches counted == the wrappers'; the rebuild pass; one
              dry-run cell on the meta device.  Fails on an error
              finding.

14. examples — examples/serve_batched_torch.py (qwen2-7b at full width,
              paged: K2 and K1, bf16 and int8 KV; its launches read in
              its process) and examples/train_100m_torch.py at its
              defaults but 50 steps (EXAMPLE_TRAIN_STEPS), each run
              from the repo root in its own process:
              the five scenarios' measured tok/s and twin ratio on
              nvidia-h100, the shared prompt's measured prefix hit rate
              equal to the forecast's, the 100M run's parameter count,
              time per step and falling loss.

``--phases profile`` (run only when named) profiles engine steps,
qwen2-moe-a2.7b's engine steps by class (expert products, shared
experts, router and dispatch, attention kernels, the rest) and one
training step of each of the train phase's configurations (K6 forward
and backward, cuBLAS, elementwise, the optimizer's range and the
recurrences' forward range).

The last lines are the quant/measure, moe/vlm/lockstep, multidevice,
train/trainmesh, audit/examples and engine JSON summaries, the kernels'
JSON record (K1-K4 launches summed over the engine, moe, multidevice,
audit and examples phases, K6's over the train and trainmesh phases and
the lockstep prefills on one rank and on a mesh), the card's name and
power limit, and ``{"ok": true, "device": {...}}``.  A phase that fails prints
``[fail] <phase>: ...`` on stdout; the script exits non-zero.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "engine", "train", "parity", "quant",
          "measure", "moe", "vlm", "lockstep", "multidevice", "trainmesh",
          "audit", "examples")
EXTRA_PHASES = ("profile",)     # run only when named

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12          # f32 on the CUDA cores (no tensor cores)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call (CUDA events around ``iters``)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, tries: int = 3, skip: tuple = (),
              miss: Optional[dict] = None) -> Optional[float]:
    """Mean device milliseconds per call from torch.profiler: the kernels'
    own durations summed, without the host's launch gaps that
    :func:`time_ms` includes when a call's host work outlasts its
    kernels, and without the device events whose names start with one of
    ``skip``.  None (null in the record) if no profile came back whole:
    not measured, and ``miss`` then says why (:func:`device_ms_by_kernel`)."""
    ms = device_ms_by_kernel(fn, iters, tries, miss)
    kept = [v for k, v in ms.items() if not k.startswith(skip)]
    return sum(kept) if kept else None


def device_rec(key: str, fn, **kw) -> dict:
    """``{key: device_ms(fn)}`` for a record; a null comes with
    ``key + "_why"``: each kernel's event count in every try, against the
    calls profiled."""
    miss: dict = {}
    ms = device_ms(fn, miss=miss, **kw)
    return {key: ms} if ms is not None else {key: None, key + "_why": miss}


def device_ms_by_kernel(fn, iters: int = 20, tries: int = 3,
                        miss: Optional[dict] = None) -> dict:
    """Mean device milliseconds per call of each kernel ``fn`` launches
    (torch.profiler).  A profile that comes back without device events,
    or with a kernel seen a number of times that is not a multiple of
    ``iters`` (events lost: seen now and then on the card), is taken
    again, up to ``tries`` times; empty if no try came back whole, and
    then ``miss`` (if given) gets ``iters`` and each try's event count by
    kernel name.  (Late in a long run the profiler has dropped whole
    calls' events, every kernel's alike: 17 of 20 calls.)"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and _self_device_us(e) > 0]
        if kernels and all(e.count % iters == 0 for e in kernels):
            return {e.key: _self_device_us(e) / 1e3 / iters for e in kernels}
        if miss is not None:
            miss.setdefault("iters", iters)
            miss.setdefault("tries", []).append(
                {e.key: e.count for e in kernels})
    return {}


#: bytes of each of the two buffers a cold timing copies between calls:
#: 128 MB read and written, more than the H100's 50 MB L2
L2_FLUSH_BYTES = 64 << 20


def l2_flush(device):
    """The two buffers of :func:`cold_times`, and a check that their copy
    is one device-to-device memcpy (its profiler events, left out of a
    cold device time, are named ``Memcpy ...``)."""
    import torch
    src = torch.ones(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    names = set(device_ms_by_kernel(lambda: dst.copy_(src), iters=1))
    check(bool(names) and all(n.startswith("Memcpy") for n in names),
          f"the L2 flush ran {names}, not one memcpy")
    return src, dst


def cold_times(fn, flush) -> dict:
    """``fn`` with its operands out of L2, as the engine finds K/V (a
    layer's weights pass through L2 between two K1 calls): each call
    follows a copy of ``flush``'s 64 MB.  Event time: (copy + call) less
    the copy alone; device time: torch.profiler's, the copy's events
    left out."""
    src, dst = flush
    copy = lambda: dst.copy_(src)
    both = lambda: (copy(), fn())
    return dict(cold_ms=time_ms(both) - time_ms(copy),
                **device_rec("cold_device_ms", both, skip=("Memcpy",)))


def fmt_ms(ms: Optional[float]) -> str:
    """A time for the log: four decimals, or "not measured" for None."""
    return "not measured" if ms is None else f"{ms:.4f}"


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _pool(N, bs, Hk, d, kv_dtype, gen, device):
    import torch
    if kv_dtype == torch.int8:
        mk = lambda: torch.randint(-40, 41, (N, bs, Hk, d), generator=gen,
                                   device=device, dtype=torch.int8)
    else:
        mk = lambda: torch.randn((N, bs, Hk, d), generator=gen,
                                 device=device).to(kv_dtype)
    return mk(), mk()


def _tables(S, nb, N, shared, gen, device):
    """S block tables over an N-block pool; rows 1.. share the first
    ``shared`` blocks of row 0 (a radix prefix hit)."""
    import torch
    perm = torch.randperm(N, generator=gen, device=device).to(torch.int32)
    need = S * nb - (S - 1) * shared
    assert need <= N
    rows, cur = [perm[:nb]], nb
    for _ in range(1, S):
        own = perm[cur:cur + nb - shared]
        cur += nb - shared
        rows.append(torch.cat([perm[:shared], own]))
    return torch.stack(rows).contiguous()


def _compare(out, ref, cache_v, what, worst, quiet=False):
    """Hold a kernel's output to its plain version elementwise, within
    ``kernel_tolerance`` (stated in its docstring); returns max|err| and
    keeps the largest err/limit ratio seen in ``worst`` (``quiet`` logs
    nothing unless the check fails)."""
    from repro_torch.kernels.paged_attention.ref import kernel_tolerance
    diff = (out.float() - ref.float()).abs()
    ratio = float((diff / kernel_tolerance(ref, cache_v)).max())
    err = float(diff.max())
    worst[0] = max(worst[0], ratio)
    if not quiet:
        log(f"[kernels] {what} max_abs_err={err:.3e} err/limit={ratio:.3e}")
    check(ratio <= 1.0, f"{what}: |kernel - plain| exceeds the limit "
          f"({ratio:.3f} of it)")
    return err


def decode_bound(q, cache_k, tables, pos, bs):
    """Each distinct (block, offset <= cursor) of K and V is read once:
    blocks that several tables share count once."""
    S, Hk, G, d = q.shape
    kv_bytes = cache_k.element_size()
    need = {}                                   # block id -> keys read
    for row, p in zip(tables.tolist(), pos.tolist()):
        for t in range(p // bs + 1):
            n = bs if t < p // bs else p % bs + 1
            need[row[t]] = max(need.get(row[t], 0), n)
    keys = sum(need.values())
    blocks = sum(p // bs + 1 for p in pos.tolist())
    nbytes = (2 * q.numel() * q.element_size()          # q in, out
              + keys * Hk * d * 2 * kv_bytes            # K and V once
              + blocks * 4 + S * 4)                     # table ids, cursors
    pairs = sum(p + 1 for p in pos.tolist())            # (query, key)
    flops = 4 * pairs * Hk * G * d                      # QK^T and PV
    return (max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3,
            "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S
            else "operations")


def prefill_bound(q, cache_k, start, valid, bs):
    C, Hk, G, d = q.shape
    kv_bytes = cache_k.element_size()
    keys = start + valid
    nbytes = (2 * q.numel() * q.element_size()
              + keys * Hk * d * 2 * kv_bytes + (-(-keys // bs)) * 4)
    pairs = sum(start + c + 1 for c in range(valid))    # causal (row, key)
    flops = 4 * pairs * Hk * G * d
    return (max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3,
            "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S
            else "operations")


def verify_bound(q, cache_k, tables, pos, bs):
    """Distinct (block, offset) pairs any query of a slot attends, read
    once (blocks several tables share count once), plus q in and out."""
    S, Q, Hk, G, d = q.shape
    nb = tables.shape[1]
    kv_bytes = cache_k.element_size()
    need, pairs, blocks = {}, 0, 0
    for row, p in zip(tables.tolist(), pos.tolist()):
        last = min(p + Q - 1, nb * bs - 1)
        blocks += last // bs + 1
        for t in range(last // bs + 1):
            n = bs if t < last // bs else last % bs + 1
            need[row[t]] = max(need.get(row[t], 0), n)
        pairs += sum(min(p + i, nb * bs - 1) + 1 for i in range(Q))
    nbytes = (2 * q.numel() * q.element_size()
              + sum(need.values()) * Hk * d * 2 * kv_bytes
              + blocks * 4 + S * 4)
    flops = 4 * pairs * Hk * G * d
    return (max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3,
            "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S
            else "operations")


def lora_bound(x, factors, idx):
    """x in once, each (A, B)'s delta out, and the (padded) factors of each
    distinct adapter the batch uses read once; holes read no factor."""
    S, T, k = x.shape
    live = [i for i in idx.tolist() if i >= 0]
    nbytes = x.numel() * x.element_size() + S * 4
    flops = 0
    for A, B in factors:
        R, n = A.shape[2], B.shape[2]
        nbytes += (S * T * n * x.element_size()
                   + len(set(live)) * (k * R + R * n) * A.element_size())
        flops += 2 * T * (k * R + R * n) * len(live)
    return (max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3,
            "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S
            else "operations")


def _body_of(counts, before) -> str:
    """The one body whose launch count rose since ``before``."""
    rose = [b for b, n in counts.items() if n != before[b]]
    check(len(rose) == 1, f"expected one body launch, got {rose}")
    return rose[0]


def _time_verify(q, ck, cv, bt, pos, worst, what):
    """K3 against its plain version at one shape, then its time, its
    bound, its plain version's time and SDPA's with a mask over K/V
    gathered once into contiguous (S, Hk, L, d) buffers outside the
    timing."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops

    S, Q, Hk, G, d = q.shape
    bs, nb = ck.shape[1], bt.shape[1]
    before = dict(ops.BODY_LAUNCHES["paged_verify"])
    err = _compare(ops.paged_verify(q, ck, cv, bt, pos),
                   ops.paged_verify_ref(q, ck, cv, bt, pos), cv, what, worst)
    body = _body_of(ops.BODY_LAUNCHES["paged_verify"], before)
    L = int(pos.max()) + Q
    kg = ck[bt.long()].reshape(S, nb * bs, Hk, d)[:, :L].transpose(1, 2)
    vg = cv[bt.long()].reshape(S, nb * bs, Hk, d)[:, :L].transpose(1, 2)
    kg, vg = kg.contiguous(), vg.contiguous()
    qs = q.permute(0, 2, 3, 1, 4).reshape(S, Hk * G, Q, d)
    q_pos = pos.long()[:, None] + torch.arange(Q, device=q.device)[None, :]
    mask = (torch.arange(L, device=q.device)[None, None, :]
            <= q_pos[:, :, None])[:, None]
    lib = lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask)
    bound, by = verify_bound(q, ck, bt, pos, bs)
    return dict(
        ms=time_ms(lambda: ops.paged_verify(q, ck, cv, bt, pos)),
        **device_rec("device_ms",
                     lambda: ops.paged_verify(q, ck, cv, bt, pos)),
        plain_ms=time_ms(lambda: ops.paged_verify_ref(q, ck, cv, bt, pos)),
        bound_ms=bound, bound_by=by, library_ms=time_ms(lib),
        **device_rec("library_device_ms", lib), max_abs_err=err, body=body,
        shape=f"S={S} Q={Q} Hk={Hk} G={G} d={d} bs={bs} nb={nb} "
              f"pos={pos.tolist()} kv=bf16")


def _time_decode(q, ck, cv, bt, pos, worst, flush, what):
    """K1 against its plain version at one shape, a repeat bit-identical;
    then its time warm and cold (``cold_times``), event and device, its
    bound, its plain version's time, and SDPA (``enable_gqa`` for G > 1;
    the port never calls it) over K/V gathered once into contiguous (S,
    Hk, L, d) buffers outside the timing, warm and cold."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops

    S, Hk, G, d = q.shape
    bs, nb = ck.shape[1], bt.shape[1]
    run = lambda: ops.paged_decode(q, ck, cv, bt, pos)
    before = dict(ops.BODY_LAUNCHES["paged_decode"])
    out = run()
    body = _body_of(ops.BODY_LAUNCHES["paged_decode"], before)
    err = _compare(out, ops.paged_decode_ref(q, ck, cv, bt, pos), cv,
                   f"{what} ({body})", worst)
    check(torch.equal(run(), out), f"{what}: a repeat gave other bits")
    L = int(pos.max()) + 1
    kg = ck[bt.long()].reshape(S, nb * bs, Hk, d)[:, :L].transpose(1, 2)
    vg = cv[bt.long()].reshape(S, nb * bs, Hk, d)[:, :L].transpose(1, 2)
    kg, vg = kg.contiguous(), vg.contiguous()
    qs = q.reshape(S, Hk * G, 1, d)
    mask = (torch.arange(L, device=q.device)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask,
                                                 enable_gqa=G > 1)
    bound, by = decode_bound(q, ck, bt, pos, bs)
    lib_cold = cold_times(lib, flush)
    return dict(
        ms=time_ms(run), **device_rec("device_ms", run),
        **cold_times(run, flush),
        plain_ms=time_ms(lambda: ops.paged_decode_ref(q, ck, cv, bt, pos)),
        bound_ms=bound, bound_by=by, library_ms=time_ms(lib),
        **device_rec("library_device_ms", lib),
        **{"library_" + k: v for k, v in lib_cold.items()},
        max_abs_err=err, body=body,
        shape=f"S={S} Hk={Hk} G={G} d={d} bs={bs} nb={nb} "
              f"pos={pos.tolist()} kv=bf16 split="
              f"{tuple(ops.decode_split_plan(S, Hk, G, nb, bs, _sm_count(q)))}")


def _time_prefill(qp, ck, cv, table, start, valid, worst, what):
    """K2 against its plain version at one chunk (it must run on the mma
    body), then its time, bound, plain version's time and SDPA's with a
    causal mask over K/V gathered once outside the timing."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops

    C, Hk, G, d = qp.shape
    bs, nb = ck.shape[1], table.shape[0]
    device = qp.device
    before = dict(ops.BODY_LAUNCHES["paged_prefill"])
    err = _compare(ops.paged_prefill(qp, ck, cv, table, start, valid),
                   ops.paged_prefill_ref(qp, ck, cv, table, start, valid),
                   cv, what, worst)
    body = _body_of(ops.BODY_LAUNCHES["paged_prefill"], before)
    check(body == "mma", f"{what} ran {body}")
    L = start + valid
    kg = ck[table.long()].reshape(nb * bs, Hk, d)[:L].transpose(0, 1)[None]
    vg = cv[table.long()].reshape(nb * bs, Hk, d)[:L].transpose(0, 1)[None]
    kg, vg = kg.contiguous(), vg.contiguous()
    qs = qp.permute(1, 2, 0, 3).reshape(1, Hk * G, C, d)
    k_pos = torch.arange(L, device=device)
    q_pos = start + torch.arange(C, device=device)
    mask = (k_pos[None, :] <= q_pos[:, None])[None, None]
    lib = lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask)
    bound, by = prefill_bound(qp, ck, start, valid, bs)
    run = lambda: ops.paged_prefill(qp, ck, cv, table, start, valid)
    return dict(
        ms=time_ms(run), **device_rec("device_ms", run),
        plain_ms=time_ms(lambda: ops.paged_prefill_ref(qp, ck, cv, table,
                                                       start, valid)),
        bound_ms=bound, bound_by=by, library_ms=time_ms(lib),
        **device_rec("library_device_ms", lib), max_abs_err=err, body=body,
        shape=f"C={C} start={start} valid={valid} Hk={Hk} G={G} d={d} "
              f"bs={bs} nb={nb} kv=bf16")


def _sm_count(t) -> int:
    import torch
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _sweep_decode(q, ck, cv, bt, pos, flush, arch):
    """K1's device time, warm and cold, split kernel and combine apart,
    with the table cut into splits of 1, 2, 4, ... blocks, and under
    ``decode_split_plan``'s own choice: the measurement behind the plan's
    constants."""
    from repro_torch.kernels.paged_attention import ops
    S, Hk, G, _ = q.shape
    bs, nb = ck.shape[1], bt.shape[1]
    planned = ops.decode_split_plan(S, Hk, G, nb, bs, _sm_count(q))
    kept = ops.decode_split_plan
    run = lambda: ops.paged_decode(q, ck, cv, bt, pos)
    try:
        for per in sorted({1, 2, 4, 7, 12, 19, nb, planned.split_blocks}):
            plan = ops.DecodePlan(-(-nb // per), per)
            ops.decode_split_plan = lambda *a, plan=plan: plan
            parts = device_ms_by_kernel(run)
            split = sum(v for k, v in parts.items() if "split" in k)
            total = sum(parts.values()) if parts else None
            cold = cold_times(run, flush)["cold_device_ms"]
            log(f"[kernels] paged_decode split sweep {arch}: plan "
                f"{tuple(plan)}{' (planned)' if plan == planned else ''}, "
                f"{plan.splits * S * Hk * -(-G // ops.DECODE_ROWS)} blocks; "
                f"device ms warm {fmt_ms(total)} (split "
                f"{fmt_ms(split if parts else None)}, combine "
                f"{fmt_ms(total - split if parts else None)}), cold "
                f"{fmt_ms(cold)}")
    finally:
        ops.decode_split_plan = kept


def check_verify(device, gen, shapes, worst, results):
    """K3 against its plain version, then timed at the main path's two
    shapes: the speculative pass's (4 slots x 5 queries, llama2-7b heads,
    cursors 540-552) and bucketed admission's (4 slots x a 256-row chunk,
    the first chunk of a 512-token prompt at cursor 0 and the second at
    cursor 256)."""
    import torch
    from repro_torch.kernels.paged_attention import ops

    bs, d, nb, N = 16, 128, 37, 512
    for arch, (Hk, G) in shapes.items():
        for kv_name, kv_dtype in (("bf16", torch.bfloat16),
                                  ("int8", torch.int8)):
            for q_dtype in (torch.bfloat16, torch.float32):
                ck, cv = _pool(N, bs, Hk, d, kv_dtype, gen, device)
                # a fresh slot, both sides of a seam, mid-table, and a
                # cursor whose last rows (a padded chunk) leave the table
                pos = torch.tensor([0, 15, 16, 300, nb * bs - 3],
                                   dtype=torch.int32, device=device)
                bt = _tables(pos.numel(), nb, N, 2, gen, device)
                for Q in (1, 5, 256):
                    q = torch.randn((pos.numel(), Q, Hk, G, d), generator=gen,
                                    device=device).to(q_dtype)
                    out = ops.paged_verify(q, ck, cv, bt, pos)
                    ref = ops.paged_verify_ref(q, ck, cv, bt, pos)
                    _compare(out, ref, cv, f"paged_verify {arch} "
                             f"kv={kv_name} q={str(q_dtype)[6:]} Q={Q}",
                             worst)

    Hk, G = shapes["llama2-7b"]
    ck, cv = _pool(N, bs, Hk, d, torch.bfloat16, gen, device)
    bt = _tables(4, nb, N, 16, gen, device)
    timed = []
    for Q, cursors in ((5, [540, 544, 548, 552]), (256, [0] * 4),
                       (256, [256] * 4)):
        pos = torch.tensor(cursors, dtype=torch.int32, device=device)
        q = torch.randn((4, Q, Hk, G, d), generator=gen, device=device).to(
            torch.bfloat16)
        timed.append(_time_verify(q, ck, cv, bt, pos, worst,
                                  f"paged_verify main-path shape Q={Q} "
                                  f"pos={cursors[0]}"))
    check(all(t["body"] == "mma" for t in timed),
          f"a bf16 paged_verify main-path shape left the mma body: "
          f"{[t['body'] for t in timed]}")
    # the record's numbers are the speculative pass's shape; bucketed
    # admission's two chunks ride along under "more_shapes"
    results["paged_verify"] = dict(timed[0], more_shapes=timed[1:])


def _lora_pool(P, k, n, ranks, R, gen, device):
    """A bf16 adapter pool of P slots, rank ranks[p % len] padded to R."""
    import torch
    A = torch.zeros((P, k, R), device=device)
    B = torch.zeros((P, R, n), device=device)
    for p in range(P):
        r = ranks[p % len(ranks)]
        A[p, :, :r] = torch.randn((k, r), generator=gen,
                                  device=device) * r ** -0.5
        B[p, :r] = torch.randn((r, n), generator=gen, device=device) * 0.05
    return A.bfloat16().contiguous(), B.bfloat16().contiguous()


def _time_lora(x, factors, ix, worst, what):
    """K4's times at one call: the wrapper (one launch for every factor
    pair in ``factors``), the plain version, two torch.bmm per pair on
    factors gathered once (holes pointed at zeroed factors) outside the
    timing; each output held to its plain version."""
    import torch
    from repro_torch.kernels.grouped_lora import ops

    S, T, k = x.shape
    R, n = factors[0][1].shape[1:]
    if len(factors) == 1:
        run = lambda: ops.grouped_lora(x, *factors[0], ix)
    else:
        run = lambda: ops.grouped_lora_qkv(x, *factors, ix)
    plain = lambda: [ops.grouped_lora_ref(x, A_, B_, ix)
                     for A_, B_ in factors]
    gathered = [(A_[ix.long().clamp(min=0)] * (ix >= 0)[:, None, None],
                 B_[ix.long().clamp(min=0)]) for A_, B_ in factors]
    lib = lambda: [torch.bmm(torch.bmm(x, a), b) for a, b in gathered]
    outs = run()
    outs = [outs] if len(factors) == 1 else outs
    err = max(_compare(o, ref, ref, what, worst) for o, ref in
              zip(outs, plain()))
    bound, by = lora_bound(x, factors, ix)
    return dict(ms=time_ms(run), **device_rec("device_ms", run),
                plain_ms=time_ms(plain), bound_ms=bound, bound_by=by,
                library_ms=time_ms(lib),
                **device_rec("library_device_ms", lib),
                max_abs_err=err,
                shape=f"S={S} T={T} k={k} n={n} x {len(factors)} R={R} "
                      f"ranks=(8,16) idx={ix.tolist()} bf16")


def check_grouped_lora(device, gen, worst, results):
    """K4 against its plain version (the elementwise limit of
    ``kernel_tolerance``: one bf16 ulp plus f32 summation slack for bf16
    deltas, 1e-4 of max|delta| for f32 ones) at T in {1, 5, 256}, holes
    exact zeros and a repeat bit-identical; grouped_lora_qkv against three
    plain calls.  Then timed at the speculative pass's shape, 4 slots x 5
    rows through llama2-7b's q projection (4096 -> 4096), ranks 8/16
    padded to 16, one base-model slot; at decode's and the chunks' rows;
    and the q/k/v launch against three single ones."""
    import torch
    from repro_torch.kernels.grouped_lora import ops

    R = 16
    # llama2 q/o, qwen2 k/v, qwen2-moe q/k/v/o
    for k, n in ((4096, 4096), (3584, 512), (2048, 2048)):
        A, B = _lora_pool(4, k, n, (8, 16), R, gen, device)
        idx = torch.tensor([2, -1, 0, 2, 3], dtype=torch.int32,
                           device=device)
        for T in (1, 5, 256):
            for x_dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((idx.numel(), T, k), generator=gen,
                                device=device).to(x_dtype)
                out = ops.grouped_lora(x, A, B, idx)
                ref = ops.grouped_lora_ref(x, A, B, idx)
                _compare(out, ref, ref, f"grouped_lora k={k} n={n} T={T} "
                         f"x={str(x_dtype)[6:]}", worst)
                check(not out[1].any(), "grouped_lora: a hole (idx=-1) "
                      "got a non-zero delta")
                check(torch.equal(ops.grouped_lora(x, A, B, idx), out),
                      f"grouped_lora T={T}: a repeat gave other bits")
    # one launch for a layer's q, k and v: llama2-7b (4096 -> 4096 x 3),
    # qwen2-7b (3584 -> 3584, 512, 512) and qwen2-moe-a2.7b (2048 x 3)
    for k, ns in ((4096, (4096, 4096, 4096)), (3584, (3584, 512, 512)),
                  (2048, (2048, 2048, 2048))):
        pairs = [_lora_pool(4, k, n, (8, 16), R, gen, device) for n in ns]
        idx = torch.tensor([1, -1, 0, 3], dtype=torch.int32, device=device)
        for T in (1, 5, 256):
            x = torch.randn((4, T, k), generator=gen, device=device).to(
                torch.bfloat16)
            got = ops.grouped_lora_qkv(x, *pairs, idx)
            for name, out, (A, B) in zip("qkv", got, pairs):
                ref = ops.grouped_lora_ref(x, A, B, idx)
                _compare(out, ref, ref, f"grouped_lora_qkv {name} k={k} "
                         f"n={B.shape[2]} T={T}", worst)
                check(not out[1].any(), "grouped_lora_qkv: a hole got a "
                      "non-zero delta")

    k = n = 4096
    A, B = _lora_pool(4, k, n, (8, 16), R, gen, device)
    idx = torch.tensor([0, 1, 2, -1], dtype=torch.int32, device=device)

    def timed(S, T, factors, what):
        x = torch.randn((S, T, k), generator=gen, device=device).to(
            torch.bfloat16)
        return _time_lora(x, factors, idx[:S].contiguous(), worst, what)

    main = timed(4, 5, [(A, B)], "grouped_lora main-path shape")
    # a layer's q, k and v: one launch against three single ones
    qkv = [(A, B)] + [_lora_pool(4, k, n, (8, 16), R, gen, device)
                      for _ in range(2)]
    more = [timed(4, 1, [(A, B)], "grouped_lora decode"),
            timed(4, 5, qkv, "grouped_lora_qkv speculative step"),
            timed(1, 256, qkv, "grouped_lora_qkv prefill chunk"),
            timed(4, 256, [(A, B)], "grouped_lora bucketed chunk")]
    r = more[1]
    three = main["device_ms"] and 3 * main["device_ms"]     # None stays None
    log(f"[kernels] grouped_lora_qkv @ {r['shape']}: one launch "
        f"{r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}) against three "
        f"single launches {3 * main['ms']:.4f} ms (device {fmt_ms(three)})")
    results["grouped_lora"] = dict(main, more_shapes=more)


#: the reference's flash attention kernel cases (tests/test_kernels.py):
#: (b, s, L, H, Hk, d, causal, window, q_offset)
FA_CASES = (
    (1, 128, 128, 4, 4, 64, True, None, 0),      # MHA
    (2, 256, 256, 8, 2, 128, True, None, 0),     # GQA 4:1
    (1, 256, 256, 4, 1, 64, True, None, 0),      # MQA
    (1, 100, 100, 4, 2, 64, True, None, 0),      # unaligned seq
    (1, 1, 384, 4, 2, 64, True, None, 383),      # decode step w/ offset
    (2, 192, 192, 4, 4, 64, True, 64, 0),        # local window
    (1, 64, 64, 4, 4, 128, False, None, 0),      # bidirectional
    (1, 128, 128, 2, 2, 256, True, None, 0),     # big head_dim
)
#: the train phase's attention: granite-3-2b at 4 x 2048, causal, bf16
FA_MAIN = (4, 2048, 2048, 32, 8, 64, True, None, 0)
#: the trainmesh phase's rank shapes of it: a tp = 2 rank (its 16 of 32
#: query heads over 4 of 8 KV heads, every row) and a dp = 2 rank (its 2
#: of 4 rows, every head)
FA_TRAIN_RANKS = {"tp=2 rank": (4, 2048, 2048, 16, 4, 64, True, None, 0),
                  "dp=2 rank": (2, 2048, 2048, 32, 8, 64, True, None, 0)}
#: the train phase's recurrentgemma-2b attention: 1 x 4096, 10 query heads
#: over one KV head, d = 256, window 2048 (K6's wide bodies)
FA_TRAIN_WIDE = (1, 4096, 4096, 10, 1, 256, True, 2048, 0)


def attention_pairs(s, L, causal, window, q_offset) -> int:
    """Live (query, key) pairs of one (batch, head)."""
    import numpy as np
    qp = q_offset + np.arange(s)
    hi = np.minimum(L, qp + 1) if causal else np.full(s, L)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros(s, int)
    return int(np.maximum(0, hi - lo).sum())


def flash_bound(case, elem, backward):
    """Forward: q, k, v read once, o and the f32 log-sum-exp written once;
    4*b*H*d flops per live pair (QK^T and PV).  Backward: q, k, v, o, dO
    and the log-sum-exp read, dq, dk, dv written; 2.5x the forward's
    flops (QK^T again, dO V^T, dV, dQ, dK)."""
    b, s, L, H, Hk, d, causal, window, q_offset = case
    q_el, kv_el, lse = b * s * H * d, b * L * Hk * d, b * H * s * 4
    flops = 4 * b * H * d * attention_pairs(s, L, causal, window, q_offset)
    if backward:
        flops *= 2.5
        nbytes = elem * (3 * q_el + 2 * kv_el) + lse + elem * (q_el + 2 * kv_el)
    else:
        nbytes = elem * (2 * q_el + 2 * kv_el) + lse
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_flash(device, gen, worst, results):
    """K6 forward against its plain version (``kernel_tolerance``) and its
    backward's dq, dk, dv against autograd through the plain version,
    with one random upstream gradient, as relative norms
    ||kernel - plain|| / ||plain||: at most 1e-5 in f32 (the ``fma``
    body: the same f32 arithmetic summed in another order) and 2e-2 in
    bf16 (D = rowsum(dO*O) reads the bf16-rounded output where autograd
    uses the f32 one, every gradient rounds once to bf16, and the ``mma``
    body rounds P and dS once to bf16).  Every bf16 case runs on the
    bodies ``flash_body`` picks for each direction (at d = 256 the wide
    ``mma`` forward and backward) and, where they are ``mma``, on the
    ``fma`` body forced too.  Then both bodies timed at the train phase's
    shape (CUDA events and torch.profiler's device time), beside the
    plain version and SDPA (``is_causal``, ``enable_gqa``; the port never
    calls it); the same for the backward at recurrentgemma-2b's training
    shape (``FA_TRAIN_WIDE``, SDPA with a boolean window mask)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops

    limit = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    # largest forward err/limit and relative error of each gradient, by body
    largest = {b: [0.0, 0.0, 0.0, 0.0] for b in ops.BODIES}

    def one(case, dtype, what, body=None):
        b, s, L, H, Hk, d, causal, window, q_offset = case
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        mk = lambda *shape: torch.randn(shape, generator=gen,
                                        device=device).to(dtype)
        q, k, v, do = mk(b, s, H, d), mk(b, L, Hk, d), mk(b, L, Hk, d), \
            mk(b, s, H, d)
        want = {n: body or ops.flash_body(n, dtype, d)
                for n in ops.BODY_LAUNCHES}
        before = {n: dict(c) for n, c in ops.BODY_LAUNCHES.items()}
        o, lse = ops.flash_fwd(q, k, v, body=want["flash_fwd"], **kw)
        grads = ops.flash_bwd(q, k, v, o, lse, do, body=want["flash_bwd"],
                              **kw)
        ran = {n: _body_of(ops.BODY_LAUNCHES[n], before[n])
               for n in before}
        check(ran == want, f"flash {what}: ran on {ran}, expected {want}")
        body, bwd_body = ran["flash_fwd"], ran["flash_bwd"]
        what = (f"{what} ({body})" if body == bwd_body
                else f"{what} (forward {body}, backward {bwd_body})")
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        ref = ops.attention_ref(*leaves, **kw)
        ref_grads = torch.autograd.grad(ref, leaves, do)
        mine = [0.0]
        err = _compare(o, ref.detach(), v, f"flash_fwd {what}", mine)
        ratio = mine[0]
        worst[0] = max(worst[0], ratio)
        rel = [float((a.float() - r.float()).norm() / r.float().norm())
               for a, r in zip(grads, ref_grads)]
        grad_err = max(float((a.float() - r.float()).abs().max())
                       for a, r in zip(grads, ref_grads))
        if dtype == torch.bfloat16:
            largest[body][0] = max(largest[body][0], ratio)
            largest[bwd_body][1:] = [max(x, y) for x, y in
                                     zip(largest[bwd_body][1:], rel)]
        log(f"[kernels] flash_bwd {what} dq/dk/dv rel err "
            f"{rel[0]:.3e}/{rel[1]:.3e}/{rel[2]:.3e} (limit "
            f"{limit[dtype]:.0e}) max_abs_err={grad_err:.3e}")
        check(max(rel) <= limit[dtype], f"flash_bwd {what}: relative "
              f"error {max(rel):.3e} above {limit[dtype]:.0e}")
        return (q, k, v, do, o, lse), err, grad_err

    for case in FA_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            one(case, dtype, f"{case} {str(dtype)[6:]}")
        if ops.flash_body("flash_fwd", torch.bfloat16, case[5]) == "mma":
            one(case, torch.bfloat16, f"{case} bfloat16", body="fma")
    (q, k, v, do, o, lse), err, grad_err = one(FA_MAIN, torch.bfloat16,
                                               "main-path shape")
    _, err_fma, grad_err_fma = one(FA_MAIN, torch.bfloat16,
                                   "main-path shape", body="fma")
    for body, (r, dq, dk, dv) in largest.items():
        log(f"[kernels] flash {body} body, bf16, over FA_CASES and "
            f"FA_MAIN: largest forward err/limit {r:.4f}, largest dq/dk/dv "
            f"rel err {dq:.3e}/{dk:.3e}/{dv:.3e}")
    b, s, L, H, Hk, d = FA_MAIN[:6]
    shape = f"b={b} s={s} L={L} H={H} Hk={Hk} d={d} causal bf16"
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref = ops.attention_ref(*leaves)
    plain_bwd = lambda: torch.autograd.grad(ref, leaves, do, retain_graph=True)
    # SDPA takes (b, H, s, d); the transposes are made once, outside timing
    ql, kl, vl, dol = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    sdpa = lambda *a: F.scaled_dot_product_attention(*a, is_causal=True,
                                                     enable_gqa=True)
    lib_leaves = [t.clone().requires_grad_() for t in (ql, kl, vl)]
    lib_out = sdpa(*lib_leaves)
    lib_bwd = lambda: torch.autograd.grad(lib_out, lib_leaves, dol,
                                          retain_graph=True)
    lib_fwd_bwd = lambda: torch.autograd.grad(sdpa(*lib_leaves), lib_leaves,
                                              dol)
    fwd_common = dict(
        plain_ms=time_ms(lambda: ops.attention_ref(q, k, v)),
        library_ms=time_ms(lambda: sdpa(ql, kl, vl)),
        **device_rec("library_device_ms", lambda: sdpa(ql, kl, vl)))
    fwd_common["bound_ms"], fwd_common["bound_by"] = flash_bound(
        FA_MAIN, 2, backward=False)
    bwd_common = dict(plain_ms=time_ms(plain_bwd),
                      library_ms=time_ms(lib_bwd),
                      **device_rec("library_device_ms", lib_bwd))
    bwd_common["bound_ms"], bwd_common["bound_by"] = flash_bound(
        FA_MAIN, 2, backward=True)
    bwd_shape = (shape + " (backward alone; plain and library: autograd "
                 "backward of a kept graph)")

    def timed(body, fwd):
        if fwd:
            fn = lambda: ops.flash_fwd(q, k, v, body=body)
        else:
            fn = lambda: ops.flash_bwd(q, k, v, o, lse, do, body=body)
        return dict(ms=time_ms(fn), **device_rec("device_ms", fn), body=body)

    results["flash_fwd"] = dict(
        **timed("mma", True), **fwd_common, max_abs_err=err, shape=shape,
        more_shapes=[dict(**timed("fma", True), **fwd_common,
                          max_abs_err=err_fma, shape=shape)])
    results["flash_bwd"] = dict(
        **timed("mma", False), **bwd_common, max_abs_err=grad_err,
        shape=bwd_shape,
        more_shapes=[dict(**timed("fma", False), **bwd_common,
                          max_abs_err=grad_err_fma, shape=bwd_shape)])
    log(f"[kernels] SDPA forward+backward at {shape}: "
        f"{time_ms(lib_fwd_bwd):.4f} ms")
    del ref, lib_out
    torch.cuda.empty_cache()
    for what, case in FA_TRAIN_RANKS.items():
        _time_k6_train_rank(what, case, one, results)
    _time_k6_train_wide(one, results)


def _time_k6_train_wide(one, results):
    """K6's backward at ``FA_TRAIN_WIDE`` (the wide ``mma`` body, and the
    ``fma`` body forced): held to the plain version by ``check_flash``'s
    ``one``, then timed on both (CUDA events and device time) beside the
    plain version's autograd backward and SDPA's backward with a boolean
    window mask (events and device time), with the bound, into
    ``flash_bwd``'s ``more_shapes``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    case = FA_TRAIN_WIDE
    b, s, L, H, Hk, d, causal, window, q_offset = case
    what = "recurrentgemma-2b training shape"
    _, _, grad_err_fma = one(case, torch.bfloat16, what, body="fma")
    (q, k, v, do, o, lse), _, grad_err = one(case, torch.bfloat16, what)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    shape = (f"{what}: b={b} s={s} L={L} H={H} Hk={Hk} d={d} causal "
             f"window={window} bf16 (backward alone; plain and library: "
             f"autograd backward of a kept graph)")
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref = ops.attention_ref(*leaves, **kw)
    plain_bwd = lambda: torch.autograd.grad(ref, leaves, do,
                                            retain_graph=True)
    qp = q_offset + torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(L, device=q.device)[None, :]
    mask = (kp <= qp) & (kp > qp - window)
    ql, kl, vl, dol = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    lib_leaves = [t.clone().requires_grad_() for t in (ql, kl, vl)]
    lib_out = F.scaled_dot_product_attention(
        *lib_leaves, attn_mask=mask[None, None], enable_gqa=True)
    lib_bwd = lambda: torch.autograd.grad(lib_out, lib_leaves, dol,
                                          retain_graph=True)
    common = dict(plain_ms=time_ms(plain_bwd, iters=5, warmup=1),
                  library_ms=time_ms(lib_bwd),
                  **device_rec("library_device_ms", lib_bwd))
    common["bound_ms"], common["bound_by"] = flash_bound(case, 2, True)
    del ref, leaves
    for body, e in (("mma", grad_err), ("fma", grad_err_fma)):
        fn = lambda: ops.flash_bwd(q, k, v, o, lse, do, body=body, **kw)
        iters = 20 if body == "mma" else 5
        rec = dict(ms=time_ms(fn, iters=iters),
                   **device_rec("device_ms", fn, iters=iters), body=body,
                   **common, max_abs_err=e, shape=shape)
        results["flash_bwd"].setdefault("more_shapes", []).append(rec)
        log(f"[kernels] flash_bwd ({body}) at {shape}: {rec['ms']:.4f} ms, "
            f"device {fmt_ms(rec['device_ms'])}, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), plain "
            f"{rec['plain_ms']:.4f} ms, SDPA with a boolean mask "
            f"{rec['library_ms']:.4f} ms, device "
            f"{fmt_ms(rec['library_device_ms'])}")
    del lib_out, lib_leaves
    torch.cuda.empty_cache()


def _time_k6_train_rank(what, case, one, results):
    """K6 forward and backward at a training rank's shape (bf16, the mma
    body): held to the plain version by ``check_flash``'s ``one``, then
    timed (CUDA events and device time) beside the plain version and
    SDPA, with the bound, into each kernel's ``more_shapes``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    (q, k, v, do, o, lse), err, grad_err = one(case, torch.bfloat16, what)
    b, s, L, H, Hk, d = case[:6]
    shape = f"{what}: b={b} s={s} L={L} H={H} Hk={Hk} d={d} causal bf16"
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref = ops.attention_ref(*leaves)
    ql, kl, vl, dol = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    sdpa = lambda *a: F.scaled_dot_product_attention(*a, is_causal=True,
                                                     enable_gqa=True)
    lib_leaves = [t.clone().requires_grad_() for t in (ql, kl, vl)]
    lib_out = sdpa(*lib_leaves)
    fwd = lambda: ops.flash_fwd(q, k, v)
    bwd = lambda: ops.flash_bwd(q, k, v, o, lse, do)
    lib_fwd = lambda: sdpa(ql, kl, vl)
    lib_bwd = lambda: torch.autograd.grad(lib_out, lib_leaves, dol,
                                          retain_graph=True)
    recs = {}
    for name, fn, plain, lib, backward, e in (
            ("flash_fwd", fwd, lambda: ops.attention_ref(q, k, v), lib_fwd,
             False, err),
            ("flash_bwd", bwd, lambda: torch.autograd.grad(
                ref, leaves, do, retain_graph=True), lib_bwd, True,
             grad_err)):
        rec = dict(ms=time_ms(fn), **device_rec("device_ms", fn),
                   body="mma", plain_ms=time_ms(plain), library_ms=time_ms(lib),
                   **device_rec("library_device_ms", lib), max_abs_err=e,
                   shape=shape + (" (backward alone)" if backward else ""))
        rec["bound_ms"], rec["bound_by"] = flash_bound(case, 2, backward)
        results[name].setdefault("more_shapes", []).append(rec)
        recs[name] = rec
        log(f"[kernels] {name} at {shape}: {rec['ms']:.4f} ms, device "
            f"{fmt_ms(rec['device_ms'])}, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), plain {rec['plain_ms']:.4f} ms, SDPA "
            f"{rec['library_ms']:.4f} ms, device "
            f"{fmt_ms(rec['library_device_ms'])}")
    del ref, lib_out
    torch.cuda.empty_cache()
    return recs


#: llama2-7b's linear shapes (k, n): wq/wk/wv/wo, gate/up, down, lm_head
QMM_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
#: K5's timed rows: decode of 4 slots, a 64-row chunk, a 256-row chunk
QMM_ROWS = (4, 64, 256)
#: a layer's seven projections, as (group, name) in the param tree; each
#: is quantized on its 2-D view: wq/wk/wv (d, heads, hd) as (d, heads*hd),
#: wo (H, hd, d) as (H*hd, d)
LAYER_PROJECTIONS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                     ("attn", "wo"), ("mlp", "gate"), ("mlp", "up"),
                     ("mlp", "down"))


def qmm_bound(x, q):
    """x read once, w_q (one byte per value), scale and zero (bf16) read
    once, y written once; 2*m*k*n flops of the product at the peak rate
    of x's type (bf16 tensor cores, or f32 on the CUDA cores)."""
    m, k = x.shape
    n = q.w_q.shape[1]
    elem = x.element_size()
    nbytes = (m * k * elem + q.w_q.numel() + 2 * q.scales.numel() * 2
              + m * n * elem)
    peak = BF16_FLOPS_PER_S if elem == 2 else F32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * m * k * n / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _time_qmm(x, q, worst, what):
    """K5 against its plain version at one shape (``kernel_tolerance``
    with ref as its scale: one bf16 ulp plus 1e-3 of the mean magnitude
    for bf16 outputs, 1e-4 of max|y| for f32 ones), then its time, its
    bound, the plain version's time and ``torch.matmul`` on the weight
    dequantized once to x's dtype outside the timing (the GEMM the int4
    path exists to beat at decode; the port never calls it for K5)."""
    import torch
    from repro_torch.kernels.quant_matmul import ops
    from repro_torch.quant import dequantize_weight
    args = (x, q.w_q, q.scales, q.zeros)
    g = q.group_size
    before = dict(ops.BODY_LAUNCHES)
    out = ops.quant_matmul(*args, group_size=g)
    body = _body_of(ops.BODY_LAUNCHES, before)
    ref = ops.quant_matmul_ref(*args, g)
    err = _compare(out, ref, ref, f"{what} ({body})", worst)
    w = dequantize_weight(q, x.dtype)
    bound, by = qmm_bound(x, q)
    res = dict(
        ms=time_ms(lambda: ops.quant_matmul(*args, group_size=g)),
        **device_rec("device_ms",
                     lambda: ops.quant_matmul(*args, group_size=g)),
        plain_ms=time_ms(lambda: ops.quant_matmul_ref(*args, g)),
        bound_ms=bound, bound_by=by,
        library_ms=time_ms(lambda: torch.matmul(x, w)),
        **device_rec("library_device_ms", lambda: torch.matmul(x, w)),
        max_abs_err=err, body=body,
        shape=f"m={x.shape[0]} k={x.shape[1]} n={q.w_q.shape[1]} "
              f"g={g} int{q.bits} x={str(x.dtype)[6:]}")
    del w
    return res


def check_quant_matmul(device, gen, worst, results):
    """K5 at every llama2-7b linear shape at m = 4 (decode: the splitk
    body), m = 64 and m = 256 (prefill chunks: the wgmma body), bf16 x,
    int4, g = 128; one int8 case; a ragged case (m = 5, n = 200, g = 64)
    in f32 and bf16.  Weights are normal (std 0.02) and quantized on the
    card by the port's ``quantize_weight``.  The record's numbers are
    lm_head at decode; the rest ride along under "more_shapes".  Then
    both bodies, each forced, at m = 8 ... 128 on 4096 x 4096 and
    lm_head: the measurement behind WGMMA_MIN_ROWS."""
    import torch
    from repro_torch.kernels.quant_matmul import ops
    from repro_torch.quant import quantize_weight

    def weight(k, n):
        return torch.randn((k, n), generator=gen, device=device) * 0.02

    def act(m, k, dtype):
        return torch.randn((m, k), generator=gen, device=device).to(dtype)

    timed = []
    for k, n in QMM_SHAPES:
        q = quantize_weight(weight(k, n), group_size=128, bits=4)
        for m in QMM_ROWS:
            timed.append(_time_qmm(act(m, k, torch.bfloat16), q, worst,
                                   f"quant_matmul k={k} n={n} m={m} int4 bf16"))
        del q
    q = quantize_weight(weight(4096, 4096), group_size=128, bits=8)
    timed.append(_time_qmm(act(4, 4096, torch.bfloat16), q, worst,
                           "quant_matmul k=4096 n=4096 m=4 int8 bf16"))
    q = quantize_weight(weight(1024, 200), group_size=64, bits=4)
    for dtype in (torch.float32, torch.bfloat16):
        timed.append(_time_qmm(act(5, 1024, dtype), q, worst,
                               f"quant_matmul ragged m=5 k=1024 n=200 g=64 "
                               f"{str(dtype)[6:]}"))
    for r in timed[:len(QMM_SHAPES) * len(QMM_ROWS)]:
        m, _, n = (int(f.split("=")[1]) for f in r["shape"].split()[:3])
        want = ops.qmm_body(torch.bfloat16, m, n, 128)
        check(r["body"] == want, f"quant_matmul {r['shape']} ran on "
              f"{r['body']}, not {want}")
    main = next(r for r in timed if r["shape"].startswith("m=4 k=4096 n=32000"))
    threshold = ops.WGMMA_MIN_ROWS
    try:
        for k, n in ((4096, 4096), (4096, 32000)):
            q = quantize_weight(weight(k, n), group_size=128, bits=4)
            for m in (8, 16, 32, 64, 128):
                x = act(m, k, torch.bfloat16)
                ms = {}
                for body, rows in (("splitk", 1 << 30), ("wgmma", 1)):
                    ops.WGMMA_MIN_ROWS = rows
                    ms[body] = device_ms(lambda: ops.quant_matmul(
                        x, q.w_q, q.scales, q.zeros, group_size=128))
                log(f"[kernels] quant_matmul threshold k={k} n={n} m={m}: "
                    f"device ms splitk {fmt_ms(ms['splitk'])}, wgmma "
                    f"{fmt_ms(ms['wgmma'])}")
            del q
    finally:
        ops.WGMMA_MIN_ROWS = threshold
    results["quant_matmul"] = dict(
        main, more_shapes=[r for r in timed if r is not main])
    torch.cuda.empty_cache()


def _sharded_kernel_shapes(device, flush):
    """K1-K4 held to their plain versions, and timed, at the shapes a
    tp = 2 rank gives them: llama2-7b's 16 and qwen2-moe-a2.7b's 8 KV heads
    per rank (K1 at the decode cursors, K2 at the second 256-token chunk,
    K3 at the speculative pass), and K4 on 8 of 16 rank lanes through
    llama2-7b's widths (the o projection's input is gathered whole, so
    every projection has k = 4096).  Part of the kernels phase, with its
    L2 flush; the records join each kernel's ``more_shapes``."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(4321)
    bs, d, nb, N = 16, 128, 37, 512
    worst = [0.0]
    pos = torch.tensor([540, 544, 548, 552], dtype=torch.int32,
                       device=device)
    out = {k: [] for k in ENGINE_KERNELS}

    def tagged(name, rec, arch):
        out[name].append(dict(rec, shape=f"{rec['shape']} ({arch}, a tp=2 "
                                         f"rank)"))

    for arch, Hk in (("llama2-7b", 16), (MOE_ARCH, 8)):
        ck, cv = _pool(N, bs, Hk, d, torch.bfloat16, gen, device)
        bt = _tables(4, nb, N, 16, gen, device)
        q = torch.randn((4, Hk, 1, d), generator=gen, device=device).to(
            torch.bfloat16)
        rec = _time_decode(q, ck, cv, bt, pos, worst, flush,
                           f"paged_decode {arch} tp=2 rank")
        check(rec["body"] == "split", f"paged_decode ran {rec['body']}")
        tagged("paged_decode", rec, arch)
        qp = torch.randn((256, Hk, 1, d), generator=gen, device=device).to(
            torch.bfloat16)
        tagged("paged_prefill", _time_prefill(
            qp, ck, cv, bt[0].contiguous(), 256, 256, worst,
            f"paged_prefill {arch} tp=2 rank"), arch)
        if arch == "llama2-7b":
            qv = torch.randn((4, 5, Hk, 1, d), generator=gen,
                             device=device).to(torch.bfloat16)
            rec = _time_verify(qv, ck, cv, bt, pos, worst,
                               f"paged_verify {arch} tp=2 rank")
            check(rec["body"] == "mma", f"paged_verify ran {rec['body']}")
            tagged("paged_verify", rec, arch)
    k = n = 4096
    lanes = 8
    pairs = [_lora_pool(4, k, n, (8, 16), 16, gen, device) for _ in "qkv"]
    idx = torch.tensor([0, 1, 2, -1], dtype=torch.int32, device=device)
    for r in range(2):                        # each rank's 8 lanes
        cut = [(A[..., r * lanes:(r + 1) * lanes].contiguous(),
                B[:, r * lanes:(r + 1) * lanes].contiguous())
               for A, B in pairs]
        for T in (1, 5, 256):
            x = torch.randn((4, T, k), generator=gen, device=device).to(
                torch.bfloat16)
            got = _kernel_ops()[1].grouped_lora_qkv(x, *cut, idx)
            for name, o, (A, B) in zip("qkv", got, cut):
                _compare(o, _kernel_ops()[1].grouped_lora_ref(x, A, B, idx),
                         o, f"grouped_lora_qkv {name} lanes {r} T={T}", worst)
        x = torch.randn((4, 5, k), generator=gen, device=device).to(
            torch.bfloat16)
        if r == 0:
            tagged("grouped_lora", _time_lora(
                x, cut, idx, worst, "grouped_lora_qkv tp=2 rank lanes"),
                "llama2-7b")
    log(f"[kernels] at a tp=2 rank's shapes held to their plain "
        f"versions: largest err/limit {worst[0]:.3e}")
    return out


def phase_kernels(device, results):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops

    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    bs, d, nb, N = 16, 128, 37, 512
    shapes = {"llama2-7b": (32, 1), "qwen2-7b": (4, 7),
              "qwen2-moe-a2.7b": (16, 1)}
    worst = [0.0]
    for arch, (Hk, G) in shapes.items():
        for kv_name, kv_dtype in (("bf16", torch.bfloat16),
                                  ("int8", torch.int8)):
            for q_dtype in (torch.bfloat16, torch.float32):
                ck, cv = _pool(N, bs, Hk, d, kv_dtype, gen, device)
                tag = f"{arch} kv={kv_name} q={str(q_dtype)[6:]}"
                # decode: cursors at 0, mid-block, both sides of a seam,
                # deep in the table and on its last position
                pos = torch.tensor([0, 7, 15, 16, 300, nb * bs - 1],
                                   dtype=torch.int32, device=device)
                S = pos.numel()
                bt = _tables(S, nb, N, 2, gen, device)
                q = torch.randn((S, Hk, G, d), generator=gen,
                                device=device).to(q_dtype)
                before = dict(ops.BODY_LAUNCHES["paged_decode"])
                out = ops.paged_decode(q, ck, cv, bt, pos)
                body = _body_of(ops.BODY_LAUNCHES["paged_decode"], before)
                ref = ops.paged_decode_ref(q, ck, cv, bt, pos)
                _compare(out, ref, cv, f"paged_decode ({body}) {tag}", worst)
                check(body == "split" and torch.equal(
                    ops.paged_decode(q, ck, cv, bt, pos), out),
                      f"paged_decode {tag}: body {body}, or a repeat gave "
                      f"other bits")
                # prefill: an admission chunk, a chunk at start>0 with
                # valid<C that starts mid-block, a short tail chunk (the
                # key limit start+valid below every padding row's causal
                # one); every row held, padding rows too, on the body the
                # rule picks (mma for bf16 q, rows for f32 q)
                C = 256
                table = bt[1].contiguous()       # shares blocks with row 0
                want = ops.prefill_body(q_dtype, kv_dtype, d, C * G)[0]
                check(want == ("mma" if q_dtype == torch.bfloat16
                               else "rows"), f"prefill_body {tag}: {want}")
                for start, valid in ((0, 256), (200, 77), (520, 3)):
                    qp = torch.randn((C, Hk, G, d), generator=gen,
                                     device=device).to(q_dtype)
                    before = dict(ops.BODY_LAUNCHES["paged_prefill"])
                    out = ops.paged_prefill(qp, ck, cv, table, start, valid)
                    body = _body_of(ops.BODY_LAUNCHES["paged_prefill"],
                                    before)
                    ref = ops.paged_prefill_ref(qp, ck, cv, table, start,
                                                valid)
                    check(body == want and bool(torch.isfinite(
                        out.float()).all()), f"paged_prefill {tag}: body "
                        f"{body}, finite {bool(torch.isfinite(out).all())}")
                    _compare(out, ref, cv,
                             f"paged_prefill ({body}) {tag} start={start} "
                             f"valid={valid}", worst)

    # timing at the main path's shapes: llama2-7b, 4 slots, bf16 q and KV,
    # cursors around the middle of the 64-token decode after a 512 prompt;
    # then qwen2-7b's heads at the same cursors
    flush = l2_flush(device)
    pos = torch.tensor([540, 544, 548, 552], dtype=torch.int32, device=device)
    S = pos.numel()
    timed = []
    for arch in shapes:
        Hk, G = shapes[arch]
        ck, cv = _pool(N, bs, Hk, d, torch.bfloat16, gen, device)
        bt = _tables(S, nb, N, 16, gen, device)
        q = torch.randn((S, Hk, G, d), generator=gen, device=device).to(
            torch.bfloat16)
        timed.append(_time_decode(q, ck, cv, bt, pos, worst, flush,
                                  f"paged_decode main-path shape {arch}"))
        if arch != "qwen2-moe-a2.7b":     # the two shapes behind the plan
            _sweep_decode(q, ck, cv, bt, pos, flush, arch)
        if arch == "llama2-7b":
            main_pool = ck, cv, bt
    check(all(t["body"] == "split" for t in timed),
          f"paged_decode left the split body: {[t['body'] for t in timed]}")
    results["paged_decode"] = dict(timed[0], more_shapes=timed[1:])
    sharded = _sharded_kernel_shapes(device, flush)
    del flush
    Hk, G = shapes["llama2-7b"]
    ck, cv, bt = main_pool

    # prefill: the second 256-token chunk of a 512-token prompt
    qp = torch.randn((256, Hk, G, d), generator=gen, device=device).to(
        torch.bfloat16)
    results["paged_prefill"] = _time_prefill(qp, ck, cv, bt[0].contiguous(),
                                             256, 256, worst,
                                             "paged_prefill main-path shape")
    check_verify(device, gen, shapes, worst, results)
    check_grouped_lora(device, gen, worst, results)
    check_flash(device, gen, worst, results)
    # K6 at a tp = 2 rank's lockstep shapes, early in the process (where
    # profiles come back whole)
    results["flash_fwd"]["more_shapes"] = (
        results["flash_fwd"].get("more_shapes", [])
        + [dict(rec, shape=f"{rec['shape']} ({arch}, a tp=2 rank)")
           for arch, case in K6_LOCKSTEP_TP2.items()
           for rec in [_time_k6_lockstep(case, device, "kernels")]])
    check_quant_matmul(device, gen, worst, results)
    for name, recs in sharded.items():   # a tp = 2 rank's shapes
        results[name]["more_shapes"] = (results[name].get("more_shapes", [])
                                        + recs)
    log(f"[kernels] largest err/limit over every comparison: "
        f"{worst[0]:.3e}")
    for name, res in results.items():
        for r in (res, *res.get("more_shapes", ())):
            body = f" ({r['body']})" if "body" in r else ""
            extra = lambda *keys: "".join(
                f" {k}={fmt_ms(r[k])}" for k in keys if k in r)
            log(f"[kernels] {name}{body} @ {r['shape']}: "
                f"kernel_ms={r['ms']:.4f}"
                f"{extra('device_ms', 'cold_ms', 'cold_device_ms')} "
                f"plain_ms={r['plain_ms']:.4f} "
                f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                f"library_ms={r['library_ms']:.4f}"
                + extra('library_device_ms', 'library_cold_ms',
                        'library_cold_device_ms'))
            _log_misses("kernels", r)


# ---------------------------------------------------------------------------
# phases 3 and 4: the engine
# ---------------------------------------------------------------------------

def _requests(vocab, n, prompt_len, max_new, shared, seed):
    """n prompts; request 1 shares the first ``shared`` tokens of request
    0 (radix hit) and request 3 repeats request 2 (copy-on-write fork)."""
    import numpy as np
    from repro_torch.engine import Request
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, vocab, (n, prompt_len))
    prompts[1, :shared] = prompts[0, :shared]
    prompts[3] = prompts[2]
    return [Request(rid=i, prompt=prompts[i].tolist(), max_new=max_new)
            for i in range(n)]


#: every kernel of the port: (name, CUDA source, the TPU kernel it replaces)
KERNELS = (
    ("paged_decode", "src/repro_torch/kernels/paged_attention/csrc/"
     "paged_attention.cu",
     "src/repro/kernels/paged_attention/paged_attention.py:80"),
    ("paged_prefill", "src/repro_torch/kernels/paged_attention/csrc/"
     "paged_attention.cu",
     "src/repro/kernels/paged_attention/paged_attention.py:170"),
    ("paged_verify", "src/repro_torch/kernels/paged_attention/csrc/"
     "paged_attention.cu",
     "src/repro/kernels/paged_attention/paged_attention.py:266"),
    ("grouped_lora", "src/repro_torch/kernels/grouped_lora/csrc/"
     "grouped_lora.cu",
     "src/repro/kernels/grouped_lora/grouped_lora.py:68"),
    ("flash_fwd", "src/repro_torch/kernels/flash_attention/csrc/"
     "flash_attention.cu",
     "src/repro/kernels/flash_attention/flash_attention.py:92"),
    # the reference has no backward kernel: its custom VJP recomputes
    # through the oracle (the plain version) with jax.vjp
    ("flash_bwd", "src/repro_torch/kernels/flash_attention/csrc/"
     "flash_attention.cu",
     "src/repro/kernels/flash_attention/ops.py:33"),
    ("quant_matmul", "src/repro_torch/kernels/quant_matmul/csrc/"
     "quant_matmul.cu",
     "src/repro/kernels/quant_matmul/quant_matmul.py:45"),
)
#: the kernels the engine passes launch (the train phase launches K6)
ENGINE_KERNELS = ("paged_decode", "paged_prefill", "paged_verify",
                  "grouped_lora")


def _kernel_ops():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.grouped_lora import ops as lora_ops
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.quant_matmul import ops as qmm_ops
    return ops, lora_ops, fa_ops, qmm_ops


def _reset_launches() -> None:
    for mod in _kernel_ops():
        mod.reset_launch_counts()


def _launches() -> dict:
    """Launches by kernel since the reset: K4's two wrappers launch one
    kernel, counted under ``grouped_lora``."""
    counts = {k: n for mod in _kernel_ops() for k, n in mod.LAUNCHES.items()}
    counts["grouped_lora"] += counts.pop("grouped_lora_qkv")
    return counts


def _engine_bodies() -> dict:
    """K1's, K2's and K3's launches by body, K4's by wrapper, since the
    reset."""
    ops, lora_ops = _kernel_ops()[:2]
    return {**{w: dict(c) for w, c in ops.BODY_LAUNCHES.items()},
            "grouped_lora": dict(lora_ops.LAUNCHES)}


def _check_engine_bodies(tag, launches, bodies) -> None:
    """Every K1 launch ran on the split body, every bf16 K2 and K3 launch
    on the mma body, and K4 ran once for a layer's q, k and v and once for
    its output projection (two launches per layer per step, where separate
    q, k and v made four)."""
    check(bodies["paged_decode"] == {"split": launches["paged_decode"]},
          f"{tag}: a paged_decode call left the split body: "
          f"{bodies['paged_decode']} of {launches['paged_decode']}")
    for w in ("paged_prefill", "paged_verify"):
        check(bodies[w] == {"mma": launches[w], "rows": 0},
              f"{tag}: a bf16 {w} call left the mma body: {bodies[w]} of "
              f"{launches[w]}")
    lora = bodies["grouped_lora"]
    check(lora["grouped_lora_qkv"] == lora["grouped_lora"]
          and sum(lora.values()) == launches["grouped_lora"],
          f"{tag}: grouped_lora launches {lora} do not pair one q/k/v "
          f"launch with each output projection's")


def _with_tenants(reqs, tenants):
    """The requests with LoRA tenants round-robin; the last one is served
    by the base model."""
    return [dataclasses.replace(r, adapter_id=(i % tenants
                                               if i < len(reqs) - 1 else None))
            for i, r in enumerate(reqs)]


def _serve(cfg, params, ec, reqs, device, drafter=None):
    from repro_torch.engine import Engine
    eng = Engine(cfg, params, ec, device=device, drafter=drafter)
    eng.warmup()
    results = eng.run(reqs)
    return eng, results


def _check_results(cfg, reqs, results, tag):
    check(len(results) == len(reqs), f"{tag}: {len(results)} results")
    for req, res in zip(reqs, results):
        check(len(res.tokens) == req.max_new,
              f"{tag}: request {res.rid} made {len(res.tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in res.tokens),
              f"{tag}: request {res.rid} token out of range")
        check(res.finished >= res.first_token >= res.admitted,
              f"{tag}: request {res.rid} timestamps out of order")


def phase_engine(device, summary):
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.engine import EngineConfig
    from repro_torch.models import init_params

    cfg = configs.get("llama2-7b")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[engine] llama2-7b params {n_params / 1e9:.3f} B "
        f"({n_params * 2 / 1e9:.2f} GB bf16), init "
        f"{time.perf_counter() - t0:.1f} s")
    prompt_len, max_new = 512, 64
    reqs = _requests(cfg.vocab_size, 8, prompt_len, max_new, 256, seed=1)
    ec = EngineConfig(max_slots=4, max_len=prompt_len + max_new + 16,
                      chunk_size=256, decode_block=8, block_size=16,
                      n_blocks=512, kv_dtype="bf16", attn_impl="paged")
    torch.cuda.reset_peak_memory_stats(device)
    _reset_launches()                         # the main path starts here
    t0 = time.perf_counter()
    eng, results = _serve(cfg, params, ec, reqs, device)
    wall = time.perf_counter() - t0
    launches = _launches()                    # ... and ends here
    bodies = _engine_bodies()
    _check_results(cfg, reqs, results, "engine bf16")
    TP1_TOKENS[("llama2-7b", None)] = [r.tokens for r in results]
    check(launches["paged_decode"] > 0 and launches["paged_prefill"] > 0,
          f"main path did not launch both kernels: {launches}")
    _check_engine_bodies("engine bf16", launches, bodies)
    check(results[1].cached_tokens == 256,
          f"request 1 radix hit {results[1].cached_tokens} != 256")
    check(results[3].cached_tokens == prompt_len - 1,
          f"request 3 COW hit {results[3].cached_tokens} != {prompt_len - 1}")
    n_chunks = sum(1 for e in eng.trace if e.kind == "prefill_chunk")
    n_steps = sum(e.n_steps for e in eng.trace if e.kind == "decode_block")
    kv_gb = eng.cache.total_bytes() / 1e9
    summary["engine_bf16"] = dict(
        ttft_p50_ms=float(np.median([r.ttft for r in results]) * 1e3),
        tpot_p50_ms=float(np.median([r.tpot for r in results]) * 1e3),
        tps=eng.aggregate_tps(), prefix_hit_rate=eng.prefix_hit_rate,
        launches=launches, bodies=bodies, prefill_chunks=n_chunks,
        decode_steps=n_steps,
        kv_pool_gb=kv_gb, wall_s=wall,
        peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9)
    log(f"[engine] llama2-7b paged bf16: 8 requests x ({prompt_len} prompt + "
        f"{max_new} new), 4 slots, KV pool {kv_gb:.2f} GB; "
        f"TTFT p50 {summary['engine_bf16']['ttft_p50_ms']:.2f} ms, "
        f"TPOT p50 {summary['engine_bf16']['tpot_p50_ms']:.3f} ms, "
        f"TPS {summary['engine_bf16']['tps']:.1f}, prefix hit rate "
        f"{eng.prefix_hit_rate:.4f}; launches {launches} (by body "
        f"{bodies}) over {n_chunks} "
        f"prefill chunks and {n_steps} decode steps x {cfg.n_layers} layers; "
        f"wall {wall:.1f} s (warm-up included), peak memory "
        f"{summary['engine_bf16']['peak_mem_gb']:.2f} GB")
    log(f"[engine] request 2 vs its COW twin 3: first 8 tokens "
        f"{results[2].tokens[:8]} / {results[3].tokens[:8]}")
    del eng
    torch.cuda.empty_cache()

    # the same requests with four LoRA tenants (ranks 8/16) and one
    # base-model request: with speculative decoding (K2 admits, K3
    # verifies, K4 adds the deltas), then with bucketed admission (K3
    # admits the groups, K1 decodes, K4 adds the deltas)
    tenants = 4
    for tag, extra, path in (
            ("engine_spec_lora", dict(spec_k=4),
             ("paged_prefill", "paged_verify", "grouped_lora")),
            ("engine_bucketed_lora", dict(prefill_batch=4),
             ("paged_verify", "paged_decode", "grouped_lora"))):
        reqs_l = _with_tenants(reqs, tenants)
        ec_l = dataclasses.replace(ec, lora_tenants=tenants,
                                   lora_ranks=(8, 16), **extra)
        _reset_launches()                     # this path starts here
        t0 = time.perf_counter()
        eng, results = _serve(cfg, params, ec_l, reqs_l, device)
        wall = time.perf_counter() - t0
        launches = _launches()                # ... and ends here
        bodies = _engine_bodies()
        _check_results(cfg, reqs_l, results, tag)
        check(all(launches[k] > 0 for k in path),
              f"{tag} did not launch {path}: {launches}")
        _check_engine_bodies(tag, launches, bodies)
        pool = eng.adapter_pool
        check(pool.misses == tenants and pool.evictions == 0,
              f"{tag}: adapter pool misses {pool.misses}, evictions "
              f"{pool.evictions}")
        ranks = {r for e in eng.trace for r in e.adapter_ranks}
        check(ranks == {0, 8, 16}, f"{tag}: adapter ranks {ranks}")
        kinds = {e.kind for e in eng.trace}
        want = "spec_step" if "spec_k" in extra else "prefill_batch"
        check(want in kinds, f"{tag}: no {want} event in the trace")
        summary[tag] = dict(
            ttft_p50_ms=float(np.median([r.ttft for r in results]) * 1e3),
            tpot_p50_ms=float(np.median([r.tpot for r in results]) * 1e3),
            tps=eng.aggregate_tps(), adapter_hit_rate=eng.adapter_hit_rate,
            launches=launches, bodies=bodies, wall_s=wall)
        if "spec_k" in extra:
            summary[tag].update(spec_acceptance=eng.spec_acceptance,
                                spec_tokens_per_step=eng.spec_tokens_per_step,
                                spec_steps=eng.spec_steps)
        else:
            summary[tag].update(batched_chunks=sum(
                1 for e in eng.trace if e.kind == "prefill_batch"))
        r = summary[tag]
        log(f"[engine] llama2-7b paged bf16 {tag}: 8 requests x "
            f"({prompt_len} + {max_new}), {tenants} tenants + 1 base; "
            f"TTFT p50 {r['ttft_p50_ms']:.2f} ms, TPOT p50 "
            f"{r['tpot_p50_ms']:.3f} ms, TPS {r['tps']:.1f}, adapter hit "
            f"rate {r['adapter_hit_rate']:.4f}"
            + (f", acceptance {r['spec_acceptance']:.4f}, tokens/step "
               f"{r['spec_tokens_per_step']:.4f} over {r['spec_steps']} "
               f"steps" if "spec_k" in extra else
               f", {r['batched_chunks']} batched chunks")
            + f"; launches {launches}, by body {bodies}; wall "
            f"{wall:.1f} s (warm-up included)")
        del eng
        torch.cuda.empty_cache()
    total = {k: sum(summary[t]["launches"][k] for t in
                    ("engine_bf16", "engine_spec_lora",
                     "engine_bucketed_lora")) for k in ENGINE_KERNELS}
    check(all(v > 0 for v in total.values()),
          f"the engine passes did not launch every kernel: {total}")
    summary["launches_total"] = total
    passes = ("engine_bf16", "engine_spec_lora", "engine_bucketed_lora")
    summary["bodies_total"] = {
        w: {b: sum(summary[t]["bodies"][w][b] for t in passes) for b in c}
        for w, c in summary["engine_bf16"]["bodies"].items()}
    log(f"[engine] launches over the three passes {total}, by body "
        f"{summary['bodies_total']}")

    # a short second pass with int8 KV
    reqs8 = _requests(cfg.vocab_size, 4, prompt_len, 16, 256, seed=2)
    ec8 = dataclasses.replace(ec, kv_dtype="int8", max_len=prompt_len + 32)
    _reset_launches()
    eng, results = _serve(cfg, params, ec8, reqs8, device)
    _check_results(cfg, reqs8, results, "engine int8")
    check(eng.state["cache_k"].dtype == torch.int8, "int8 pool dtype")
    _check_engine_bodies("engine int8", _launches(), _engine_bodies())
    summary["engine_int8"] = dict(
        ttft_p50_ms=float(np.median([r.ttft for r in results]) * 1e3),
        tpot_p50_ms=float(np.median([r.tpot for r in results]) * 1e3),
        tps=eng.aggregate_tps(), prefix_hit_rate=eng.prefix_hit_rate)
    log(f"[engine] llama2-7b paged int8: 4 requests x ({prompt_len} + 16); "
        f"TTFT p50 {summary['engine_int8']['ttft_p50_ms']:.2f} ms, "
        f"TPOT p50 {summary['engine_int8']['tpot_p50_ms']:.3f} ms, "
        f"TPS {summary['engine_int8']['tps']:.1f}")
    del eng, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: the trainer
# ---------------------------------------------------------------------------

TRAIN_ARCH = "granite-3-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 4
#: the hybrid cell: recurrentgemma-2b (26 layers, 8 of them local
#: attention at d = 256, window 2048) at the reference's train_4k length,
#: where the window cuts into the keys; K6 on the wide bodies
TRAIN_WIDE_ARCH = "recurrentgemma-2b"
TRAIN_WIDE_BATCH, TRAIN_WIDE_SEQ, TRAIN_WIDE_STEPS = 1, 4096, 3
#: its peak learning rate: AdamW's first update moves every weight by
#: about the learning rate, and at granite-3-2b's 3e-4 the last of its
#: three steps' losses rose above the first's (12.96, 12.53, 14.47 on an
#: H100 80GB HBM3 at 700 W)
TRAIN_WIDE_LR = 1e-4
#: the card's memory, which a training step's peak must stay under
CARD_BYTES = 80e9


def train_flops(cfg, batch, seq) -> float:
    """Model FLOPs of one training step: 6*N per token, plus attention's
    forward and backward (3 x 4*b*H*hd per live causal pair) in each
    attention layer (8 of recurrentgemma-2b's 26, every layer of a dense
    model).  Remat's recompute is not counted: it is not the model's
    work."""
    pairs = attention_pairs(seq, seq, True, cfg.local_window or None, 0)
    n_attn = cfg.block_kinds().count("attn")
    return (6 * cfg.param_count() * batch * seq
            + 12 * batch * cfg.n_heads * cfg.head_dim * pairs * n_attn)


def _trainer(cfg, ckpt_dir, total, ckpt_every, device, seed=0,
             batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS, lr=3e-4,
             **kw):
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.optim import AdamW
    from repro_torch.runtime import Trainer, TrainerConfig
    data = SyntheticTokens(cfg, DataConfig(batch, seq, seed), device=device)
    opt = AdamW(lr=lr, warmup_steps=1, total_steps=steps)
    tc = TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                       ckpt_dir=ckpt_dir, log_every=1)
    return Trainer(cfg, opt, data, tc, use_flash=True, device=device, **kw)


def _train_run(arch, batch, seq, steps, device, lr=3e-4) -> dict:
    """``arch`` at full width and depth through ``Trainer.run`` (random
    bf16 weights from seed 0, flash attention, remat, AdamW at peak
    learning rate ``lr``, no checkpoint: granite-3-2b's is 25 GB of
    disk), ``steps`` steps of batch x seq tokens; per step its loss, grad
    norm, time, tokens/s, train_mfu, peak memory and K6 launches.  Fails unless the losses are
    finite and fall, the peak stays under the card's memory, and K6
    launches twice per attention layer and step forward (remat) and once
    backward, every launch on the body ``flash_body`` picks, ``mma``."""
    import math
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.optim.adamw import tree_leaves

    cfg = configs.get(arch)
    fa_ops = _kernel_ops()[2]
    tokens = batch * seq
    flops = train_flops(cfg, batch, seq)
    n_attn = cfg.block_kinds().count("attn")
    marks = []

    def mark(step):
        """The trainer's per-step hook, called before each step: the peak
        memory and launch counts up to here, then a fresh peak."""
        marks.append((torch.cuda.max_memory_allocated(device), _launches()))
        torch.cuda.reset_peak_memory_stats(device)

    with tempfile.TemporaryDirectory() as ckpt:
        trainer = _trainer(cfg, ckpt, steps, steps + 1, device, batch=batch,
                           seq=seq, steps=steps, lr=lr, failure_injector=mark)
        torch.cuda.reset_peak_memory_stats(device)
        _reset_launches()                     # the main path starts here
        t0 = time.perf_counter()
        params, opt_state, log_ = trainer.run(seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()                # ... and ends here
        bodies = {n: dict(c) for n, c in fa_ops.BODY_LAUNCHES.items()}
    marks.append((torch.cuda.max_memory_allocated(device), launches))
    n_params = sum(t.numel() for t in tree_leaves(params))
    tag = f"[train] {arch}"
    log(f"{tag} params {n_params / 1e9:.4f} B, {cfg.n_layers} layers "
        f"({n_attn} attention, head dim {cfg.head_dim}, window "
        f"{cfg.local_window or 'none'}), d={cfg.d_model}, {batch} x {seq} "
        f"tokens per step, flash attention, remat, AdamW (peak lr {lr:g}); "
        f"{flops / 1e12:.2f} TFLOP per step (model); init + {steps} steps "
        f"in {wall:.1f} s")
    check(len(log_) == steps, f"train {arch}: {len(log_)} steps logged")
    for e, (peak, after), (_, before) in zip(log_, marks[1:], marks[:-1]):
        e["tokens_per_s"] = tokens / e["step_s"]
        e["train_mfu"] = flops / (e["step_s"] * BF16_FLOPS_PER_S)
        e["peak_mem_gb"] = peak / 1e9
        e["launches"] = {k: after[k] - before[k]
                         for k in ("flash_fwd", "flash_bwd")}
        log(f"{tag} step {e['step']}: loss {e['loss']:.5f} grad_norm "
            f"{e['grad_norm']:.5f} step {e['step_s'] * 1e3:.1f} ms, "
            f"{e['tokens_per_s']:.1f} tokens/s, train_mfu "
            f"{e['train_mfu']:.4f}, peak memory {e['peak_mem_gb']:.2f} GB, "
            f"K6 launches {e['launches']}")
    check(all(math.isfinite(e["loss"]) and math.isfinite(e["grad_norm"])
              for e in log_), f"train {arch}: a loss or grad norm is not "
          f"finite")
    check(log_[-1]["loss"] < log_[0]["loss"],
          f"train {arch}: loss did not fall ({log_[0]['loss']} -> "
          f"{log_[-1]['loss']})")
    peak = max(e["peak_mem_gb"] for e in log_)
    check(peak * 1e9 < CARD_BYTES, f"train {arch}: peak memory {peak:.2f} "
          f"GB, not under {CARD_BYTES / 1e9:.0f} GB")
    want = {"flash_fwd": 2 * n_attn * steps, "flash_bwd": n_attn * steps}
    got = {k: launches[k] for k in want}
    check(got == want, f"train {arch}: K6 launches {got}, expected {want} "
          f"(the forward twice per attention layer and step under remat)")
    # every call is bf16 at the config's head dim: the rule's body, mma
    rule = {k: fa_ops.flash_body(k, torch.bfloat16, cfg.head_dim)
            for k in want}
    check(all(rule[k] == "mma" and bodies[k] == {"mma": want[k], "fma": 0}
              for k in want),
          f"train {arch}: K6 launches by body {bodies} (rule {rule}); "
          f"every bf16 call must run on the mma body")
    steady = log_[1:]
    rec = dict(
        arch=arch, params=n_params, layers=cfg.n_layers,
        attention_layers=n_attn, head_dim=cfg.head_dim, steps=steps,
        batch=batch, seq=seq, lr=lr, step_flops=flops,
        loss=[e["loss"] for e in log_],
        grad_norm=[e["grad_norm"] for e in log_],
        step_ms=[e["step_s"] * 1e3 for e in log_],
        tokens_per_s=sum(e["tokens_per_s"] for e in steady) / len(steady),
        train_mfu=sum(e["train_mfu"] for e in steady) / len(steady),
        peak_mem_gb=peak, launches=got, bodies=bodies, wall_s=wall)
    log(f"{tag} steps 1-{steps - 1}: {rec['tokens_per_s']:.1f} tokens/s, "
        f"train_mfu {rec['train_mfu']:.4f}; peak memory "
        f"{rec['peak_mem_gb']:.2f} GB; launches {got}, by body {bodies}")
    del trainer, params, opt_state
    torch.cuda.empty_cache()
    return rec


def phase_train(device, summary):
    """granite-3-2b and recurrentgemma-2b at full width and depth through
    ``Trainer.run`` with flash attention; then the resume check at 4
    layers of granite-3-2b, full width."""
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.optim.adamw import tree_leaves

    summary["train"] = _train_run(TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ,
                                  TRAIN_STEPS, device)
    summary["train_wide"] = _train_run(TRAIN_WIDE_ARCH, TRAIN_WIDE_BATCH,
                                       TRAIN_WIDE_SEQ, TRAIN_WIDE_STEPS,
                                       device, lr=TRAIN_WIDE_LR)
    cfg = configs.get(TRAIN_ARCH)

    # resume: checkpoint after step 1, a new Trainer resumes from it, and
    # its params after step 3 equal an uninterrupted run's bit for bit
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        _trainer(cfg4, a, 2, 2, device, seed=1).run(seed=0)
        resumed, rstate, rlog = _trainer(cfg4, a, 4, 2, device,
                                         seed=1).run(seed=0)
        straight, sstate, slog = _trainer(cfg4, b, 4, 100, device,
                                          seed=1).run(seed=0)
        torch.cuda.synchronize()
        check(rlog[0]["step"] == 2, f"resume started at step "
              f"{rlog[0]['step']}, not 2")
        same = all(torch.equal(x, y) for x, y in zip(
            [*tree_leaves(resumed), *tree_leaves(rstate.mu),
             *tree_leaves(rstate.nu), rstate.count],
            [*tree_leaves(straight), *tree_leaves(sstate.mu),
             *tree_leaves(sstate.nu), sstate.count]))
    wall = time.perf_counter() - t0
    log(f"[train] resume at 4 layers, full width: checkpoint after step 1, "
        f"resumed params and moments after step 3 == uninterrupted: {same} "
        f"(losses {[round(e['loss'], 5) for e in rlog]} / "
        f"{[round(e['loss'], 5) for e in slog[2:]]}); {wall:.1f} s")
    check(same, "resumed training differs from an uninterrupted run")
    summary["train"]["resume_s"] = wall
    del resumed, rstate, straight, sstate
    torch.cuda.empty_cache()


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _parity_tokens(cfg, params, reqs, kv, impl, device, drafter=None,
                   **extra):
    from repro_torch.engine import EngineConfig
    ec = EngineConfig(max_slots=4, max_len=128, chunk_size=64,
                      decode_block=4, block_size=16, kv_dtype=kv,
                      attn_impl=impl, **extra)
    eng, results = _serve(cfg, params, ec, reqs, device, drafter)
    _check_results(cfg, reqs, results, f"parity {kv} {impl} {extra}")
    if drafter is not None:
        drafter.acceptance = eng.spec_acceptance
    return [r.tokens for r in results]


def _oracle_drafter(reqs, greedy, vocab):
    """A drafter that proposes each request's plain greedy continuation,
    with one wrong draft every third step: speculative steps then accept
    several drafts, reject others and roll the cursor back, which random
    weights and the n-gram drafter hardly ever do."""
    from repro_torch.engine import Drafter

    class Oracle(Drafter):
        acceptance = None

        def propose(self, tokens, k):
            for r, g in zip(reqs, greedy):
                n = len(r.prompt)
                if list(tokens[:n]) == list(r.prompt):
                    done = len(tokens) - n
                    out = (list(g[done:done + k]) + [0] * k)[:k]
                    if done % 3 == 2:
                        out[-1] = (out[-1] + 1) % vocab
                    return out
            return [0] * k                  # the warm-up request
    return Oracle()


def phase_parity(device):
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.engine import Request
    from repro_torch.models import forward, init_params

    cfg = dataclasses.replace(configs.get("llama2-7b"), n_layers=4)
    params = init_params(cfg, 0, device=device, dtype=torch.float32)
    reqs = _requests(cfg.vocab_size, 6, 100, 16, 48, seed=3)
    # the first token of each request is the argmax of the dense forward
    first = []
    with torch.no_grad():
        for r in reqs:
            ids = torch.tensor([r.prompt], device=device)
            logits, _ = forward(cfg, params, ids)
            first.append(int(logits[0, -1].argmax()))
    for kv in ("bf16", "int8"):
        toks = {}
        for impl in ("gather", "paged"):
            toks[impl] = _parity_tokens(cfg, params, reqs, kv, impl, device)
        same = toks["gather"] == toks["paged"]
        log(f"[parity] llama2-7b x4 layers f32, kv={kv}: gather == paged "
            f"tokens: {same}")
        check(same, f"gather and paged tokens differ with {kv} KV")
    # with f32 KV nothing is rounded between the two: the engine's first
    # token (paged prefill through the block tables) is the argmax of the
    # dense forward pass over the same prompt
    greedy = _parity_tokens(cfg, params, reqs, "fp32", "paged", device)
    firsts = [t[0] for t in greedy]
    log(f"[parity] kv=fp32: engine first tokens {firsts}, dense forward "
        f"argmax {first}")
    check(firsts == first, "engine first tokens differ from dense forward")
    # the lockstep Server's greedy tokens are the engine's on the same
    # prompts (the relation the reference's tests/test_engine.py asserts)
    from repro_torch.runtime import ServeConfig, Server
    lockstep, _ = Server(cfg, params, ServeConfig(
        batch=len(reqs), max_len=128, kv_dtype="fp32"),
        device=device).generate(
        torch.tensor([r.prompt for r in reqs], device=device), 16)
    same = lockstep.tolist() == greedy
    log(f"[parity] llama2-7b x4 layers f32: lockstep Server == engine "
        f"tokens: {same}")
    check(same, "the lockstep Server's tokens differ from the engine's")

    # the reference's invariants of the three features (its tests
    # test_spec_decode.py and test_lora_serving.py).  The runs compared
    # batch their rows differently (a verify pass, a batched chunk, one
    # request alone), so they keep f32 KV: bf16 rounding of K/V could
    # part two runs at a near-tie of the logits
    def tokens(reqs_, impl="paged", drafter=None, **extra):
        return _parity_tokens(cfg, params, reqs_, "fp32", impl, device,
                              drafter, **extra)

    spec = tokens(reqs, spec_k=4)
    log(f"[parity] spec_k=4 (n-gram drafter) at T=0 == greedy tokens: "
        f"{spec == greedy}")
    check(spec == greedy, "speculative decoding at T=0 differs from greedy")
    oracle = _oracle_drafter(reqs, greedy, cfg.vocab_size)
    spec = tokens(reqs, drafter=oracle, spec_k=4)
    log(f"[parity] spec_k=4 (greedy-continuation drafter, acceptance "
        f"{oracle.acceptance:.4f}) at T=0 == greedy tokens: {spec == greedy}")
    check(spec == greedy and 0 < oracle.acceptance < 1,
          "speculative decoding with accepted drafts differs from greedy")
    bucketed = tokens(reqs, prefill_batch=4)
    log(f"[parity] prefill_batch=4 == unbucketed tokens: "
        f"{bucketed == greedy}")
    check(bucketed == greedy, "bucketed admission differs from unbucketed")
    lora = dict(lora_tenants=3, lora_ranks=(8, 16))
    # distinct prompts here: the radix index is not keyed by tenant (as
    # in the reference), so a shared prefix would reuse another tenant's
    # K/V and a request served alone would differ by design
    rng = np.random.default_rng(5)
    plain = [Request(rid=i, max_new=16, prompt=rng.integers(
        0, cfg.vocab_size, 100).tolist()) for i in range(6)]
    treqs = _with_tenants(plain, 3)
    nolora = tokens(plain)
    mixed = tokens(treqs, **lora)
    alone = [tokens([r], **lora)[0] for r in treqs]
    log(f"[parity] mixed-tenant batch == each request alone: "
        f"{mixed == alone}; base request == no-LoRA engine: "
        f"{mixed[-1] == nolora[-1]}; tenant 0 differs from the base "
        f"model: {mixed[0] != nolora[0]}")
    check(mixed == alone, "a mixed-tenant batch differs from serving each "
          "request alone")
    check(mixed[-1] == nolora[-1], "the base-model request differs from a "
          "LoRA-free engine")
    check(mixed[0] != nolora[0], "tenant 0's adapter changed no token")
    both = dict(lora, spec_k=4)
    same = tokens(treqs, "gather", **both) == tokens(treqs, "paged", **both)
    log(f"[parity] gather == paged with LoRA and spec_k=4: {same}")
    check(same, "gather and paged tokens differ with LoRA and speculation")
    del params
    torch.cuda.empty_cache()
    _moe_parity(device)
    _train_parity(device)
    _lockstep_parity(device)


def _moe_parity(device):
    """qwen2-moe-a2.7b at full width (60 experts of 1408, top-4, 4 shared)
    with 4 of its 24 layers and f32 weights: gather and paged attention
    give identical greedy tokens with bf16 and with int8 KV.  (The first
    token is not held to the dense forward's argmax: the engine routes a
    prompt in chunks, and capacity counts each chunk's own tokens, as in
    the reference.)"""
    import torch
    from repro_torch import configs
    from repro_torch.models import init_params

    cfg = dataclasses.replace(configs.get(MOE_ARCH), n_layers=4)
    params = init_params(cfg, 0, device=device, dtype=torch.float32)
    reqs = _requests(cfg.vocab_size, 6, 100, 16, 48, seed=3)
    for kv in ("bf16", "int8"):
        toks = {impl: _parity_tokens(cfg, params, reqs, kv, impl, device)
                for impl in ("gather", "paged")}
        same = toks["gather"] == toks["paged"]
        log(f"[parity] {MOE_ARCH} x4 layers f32, kv={kv}: gather == paged "
            f"tokens: {same}")
        check(same, f"{MOE_ARCH}: gather and paged tokens differ with {kv} "
              f"KV")
    del params
    torch.cuda.empty_cache()


def _train_parity(device):
    """granite-3-2b at 4 layers, full width, f32 weights, f32 matmuls
    (``allow_tf32`` is off, set in ``main``): three training steps of two
    microbatches through the flash kernels against three through eager
    attention from the same weights and batches.  Losses agree to 1e-5
    relative and params to 1e-4 relative norm: both sides compute in
    f32, the kernel's sums run in another order, and AdamW's first steps
    turn small gradient differences into parameter differences of the
    order of lr * (relative gradient error)."""
    import torch
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import init_params
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import make_train_step

    cfg = dataclasses.replace(configs.get(TRAIN_ARCH), n_layers=4)
    data = SyntheticTokens(cfg, DataConfig(TRAIN_BATCH, TRAIN_SEQ, seed=2),
                           device=device)
    runs = {}
    for use_flash in (True, False):
        params = init_params(cfg, 0, device=device, dtype=torch.float32)
        opt = AdamW(lr=3e-4, warmup_steps=1, total_steps=3)
        state = opt.init(params)
        step = make_train_step(cfg, opt, microbatches=2, use_flash=use_flash)
        losses = []
        for i in range(3):
            params, state, m = step(params, state, data.batch(i))
            losses.append(float(m["loss"]))
        runs[use_flash] = (losses, params)
        del state
    (lf, pf), (le, pe) = runs[True], runs[False]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lf, le))
    with torch.no_grad():
        num = sum(float((a - b).double().square().sum())
                  for a, b in zip(tree_leaves(pf), tree_leaves(pe)))
        den = sum(float(b.double().square().sum()) for b in tree_leaves(pe))
    param_rel = (num / den) ** 0.5
    log(f"[parity] {TRAIN_ARCH} x4 layers f32, {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"3 steps x 2 microbatches: flash losses {lf}, eager {le} (largest "
        f"relative difference {loss_rel:.3e}); params relative difference "
        f"{param_rel:.3e}")
    check(loss_rel <= 1e-5, f"flash and eager training losses differ by "
          f"{loss_rel:.3e} (relative)")
    check(param_rel <= 1e-4, f"flash and eager training params differ by "
          f"{param_rel:.3e} (relative norm)")
    del runs, pf, pe
    torch.cuda.empty_cache()


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _kind(name: str) -> str:
    n = name.lower()
    if "paged_decode" in n:
        return "paged_decode kernel"
    if "paged_prefill" in n:
        return "paged_prefill kernel"
    if "paged_verify" in n:
        return "paged_verify kernel"
    if "grouped_lora" in n:
        return "grouped_lora kernel"
    if "flash_fwd" in n:
        return "flash_fwd kernel"
    if "flash_bwd" in n:
        return "flash_bwd kernels"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "nvjet", "sm90_xmma",
                            "cublas")):
        return "matmul (cuBLAS)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    return "elementwise / norm / index"


def phase_profile(device):
    """Where the time goes on the main path: torch.profiler over one
    admission step (4 prefills of 512 tokens) and over the decode blocks
    that follow, llama2-7b bf16, paged attention; then the same with
    three LoRA tenants and a base-model request (K4's two launches per
    layer per step on top), with speculative decoding (spec_k=4: K3
    verifies each step's candidates), and again with bucketed admission
    (prefill_batch=4: K3 admits the group in batched chunks)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.models import init_params

    cfg = configs.get("llama2-7b")
    params = init_params(cfg, 0, device=device, dtype=torch.bfloat16)
    reqs = _requests(cfg.vocab_size, 4, 512, 33, 256, seed=4)
    ec = EngineConfig(max_slots=4, max_len=512 + 64 + 16, chunk_size=256,
                      decode_block=8, block_size=16, n_blocks=512,
                      kv_dtype="bf16", attn_impl="paged")
    for tag, ec_t, reqs_t in (
            ("plain", ec, reqs),
            ("lora", dataclasses.replace(ec, lora_tenants=3,
                                         lora_ranks=(8, 16)),
             _with_tenants(reqs, 3)),
            ("spec lora", dataclasses.replace(
                ec, lora_tenants=3, lora_ranks=(8, 16), spec_k=4),
             _with_tenants(reqs, 3)),
            ("bucketed lora", dataclasses.replace(
                ec, lora_tenants=3, lora_ranks=(8, 16), prefill_batch=4),
             _with_tenants(reqs, 3))):
        eng = Engine(cfg, params, ec_t, device=device)
        eng.warmup()
        for r in reqs_t:
            eng.submit(r)
        windows = []
        while not eng.done:
            n0 = len(eng.trace)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            kinds, _ = _device_kinds(prof)
            events = [e.kind for e in eng.trace[n0:]]
            kind = "+".join(f"{k}x{events.count(k)}"
                            for k in dict.fromkeys(events))
            windows.append((kind, wall, kinds))
        for i, (kind, wall, kinds) in enumerate(windows):
            busy = sum(kinds.values()) / 1e6
            parts = ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in
                              sorted(kinds.items(), key=lambda kv: -kv[1]))
            log(f"[profile] {tag} step {i} "
                f"({kind}): "
                f"wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms "
                f"(idle share {max(0.0, 1 - busy / wall):.3f}); {parts}")
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    _profile_moe(device)
    _profile_train(device)
    _profile_train(device, TRAIN_WIDE_ARCH, TRAIN_WIDE_BATCH, TRAIN_WIDE_SEQ,
                   TRAIN_WIDE_STEPS, TRAIN_WIDE_LR)


def _device_kinds(prof):
    """Device time by kind (us) from a profile, over the device-side
    events only (kernels, copies), each counted once: a CPU op's own
    device time would count again a kernel launched outside any aten op
    (K1-K6 through ctypes) under its enclosing autograd node.  Also the
    kernel time inside the ``optimizer`` range."""
    from torch.autograd import DeviceType
    kinds, optimizer = {}, 0.0
    for evt in prof.key_averages():
        on_device = evt.device_type == DeviceType.CUDA
        if evt.key == "optimizer" and not on_device:
            optimizer += float(evt.device_time_total)
        if not on_device or evt.is_user_annotation:
            continue
        us = _self_device_us(evt)
        if us > 0:
            kinds[_kind(evt.key)] = kinds.get(_kind(evt.key), 0.0) + us
    check(bool(kinds), "profile: the trace holds no device events")
    return kinds, optimizer


def _profile_train(device, arch=TRAIN_ARCH, batch=TRAIN_BATCH,
                   seq=TRAIN_SEQ, steps=TRAIN_STEPS, lr=3e-4):
    """One profiled training step of a train phase configuration (flash
    attention, remat; granite-3-2b at 4 x 2048 by default), after an
    unprofiled one: device busy and idle share, K6 forward and backward,
    cuBLAS, elementwise, the optimizer (the kernels inside
    ``make_train_step``'s ``optimizer`` range, a part of the elementwise
    time) and the recurrences' forward work (the ``ssm recurrence``
    range, forward and remat's recompute, also a part of it)."""
    import tempfile
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs

    cfg = configs.get(arch)
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = _trainer(cfg, ckpt, steps, steps + 1, device, batch=batch,
                           seq=seq, steps=steps, lr=lr)
        params, state = trainer.init_state(0)
        params, state, _ = trainer.step_fn(params, state,
                                           trainer.data.batch(0))
        batch_1 = trainer.data.batch(1)
        torch.cuda.synchronize()
        with _SsmRanges(), profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, state, m = trainer.step_fn(params, state, batch_1)
            float(m["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kinds, optimizer = _device_kinds(prof)
    recurrence = sum(float(e.device_time_total) for e in prof.key_averages()
                     if e.key == _SsmRanges.NAME
                     and e.device_type != DeviceType.CUDA)
    busy = sum(kinds.values()) / 1e6
    parts = ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in
                      sorted(kinds.items(), key=lambda kv: -kv[1]))
    log(f"[profile] train step ({arch}, {cfg.n_layers} layers, "
        f"{batch} x {seq}, flash, remat): wall {wall * 1e3:.2f} "
        f"ms, device busy {busy * 1e3:.2f} ms (idle share "
        f"{max(0.0, 1 - busy / wall):.3f}); {parts}; optimizer range "
        f"{optimizer / 1e3:.2f} ms of device time; recurrence range "
        f"(forward and recompute) {recurrence / 1e3:.2f} ms")
    del trainer, params, state
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase: quantized weights (K5's main path)
# ---------------------------------------------------------------------------

def _quantized_paths(tree, prefix=""):
    from repro_torch.quant import QuantizedTensor
    out = []
    for key, leaf in tree.items():
        path = f"{prefix}{key}"
        if isinstance(leaf, dict):
            out += _quantized_paths(leaf, path + ".")
        elif isinstance(leaf, QuantizedTensor):
            out.append(path)
    return out


def _life_linear(m, k, n):
    """LIFE's price of one int4 linear (bf16 activations, g = 128) on the
    H100 spec: ``core.operators.linear`` priced by ``core.forecast``."""
    from repro_torch.core import StatsDB, hardware
    from repro_torch.core import operators as F
    from repro_torch.core.forecast import Forecaster
    db = StatsDB()
    F.linear(db, m, k, n, dtype_w="int4", group_size=128)
    return Forecaster(hardware.get("nvidia-h100")).phase(db.totals())


def phase_quant(device, summary):
    """llama2-7b at full width and depth, random bf16 weights from seed 0:
    ``quantize_tree`` on the card (it quantizes exactly ``embed`` and
    ``lm_head``, as the reference's does), its storage bytes against
    LIFE's ``dtypes`` formula, ``lm_head`` quantized on the card against
    the CPU bit for bit; then ``quant_dense`` through K5 on ``lm_head``
    and on all 32 layers' seven projections (``quantize_weight`` on their
    2-D views) at m = 4 and m = 256, each call held to the plain version,
    450 K5 launches; then each shape's time beside LIFE's price of the
    same int4 linear on ``nvidia-h100``."""
    import torch
    from repro_torch import configs
    from repro_torch.core import dtypes
    from repro_torch.kernels.quant_matmul import ops as qmm
    from repro_torch.models import init_params
    from repro_torch.quant import (quant_dense, quantize_tree,
                                   quantize_weight, tree_storage_bytes)

    cfg = configs.get("llama2-7b")
    g = 128
    params = init_params(cfg, 0, device=device, dtype=torch.bfloat16)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    act = lambda m, k: torch.randn((m, k), generator=gen,
                                   device=device).to(torch.bfloat16)
    worst = [0.0]

    def held(x, q, what):
        y = quant_dense(x, q)
        ref = qmm.quant_matmul_ref(x, q.w_q, q.scales, q.zeros, q.group_size)
        _compare(y, ref, ref, what, worst, quiet=True)

    t0 = time.perf_counter()
    qmm.reset_launch_counts()                  # the main path starts here
    qtree = quantize_tree(params, group_size=g, bits=4)
    quantized = sorted(_quantized_paths(qtree))
    check(quantized == ["embed", "lm_head"],
          f"quantize_tree quantized {quantized}, not embed and lm_head")
    rest = sum(t.numel() * t.element_size() for t in _leaves(params)) - sum(
        params[k].numel() * 2 for k in quantized)
    analytical = sum(dtypes.get("int4").storage_bytes(params[k].numel(), g)
                     for k in quantized) + rest
    real = tree_storage_bytes(qtree)
    log(f"[quant] quantize_tree on llama2-7b: quantized {quantized}; "
        f"tree_storage_bytes {real} == LIFE int4 storage + bf16 rest "
        f"{analytical:.0f}: {real == analytical}")
    check(real == analytical, f"tree_storage_bytes {real} != {analytical}")
    lm = qtree["lm_head"]
    cpu = quantize_weight(params["lm_head"].cpu(), group_size=g, bits=4)
    same = (torch.equal(cpu.w_q, lm.w_q.cpu())
            and torch.equal(cpu.scales.view(torch.int16),
                            lm.scales.cpu().view(torch.int16))
            and torch.equal(cpu.zeros.view(torch.int16),
                            lm.zeros.cpu().view(torch.int16)))
    log(f"[quant] lm_head quantized on the card == on the CPU bit for bit: "
        f"{same}")
    check(same, "lm_head quantized on the card differs from the CPU")
    del cpu
    for m in (4, 256):
        held(act(m, cfg.d_model), lm, f"quant lm_head m={m}")
    samples = {}
    for layer in range(cfg.n_layers):
        for group, name in LAYER_PROJECTIONS:
            w = params["layers"][group][name][layer]
            w = (w.reshape(-1, w.shape[-1]) if name == "wo"
                 else w.reshape(w.shape[0], -1))
            k, n = w.shape
            q = quantize_weight(w, group_size=g, bits=4)
            for m in (4, 256):
                held(act(m, k), q, f"quant layer {layer} {name} m={m}")
            if layer == 0:
                samples[(k, n)] = q
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(qmm.LAUNCHES)              # ... and ends here
    bodies = dict(qmm.BODY_LAUNCHES)
    want = 2 + cfg.n_layers * len(LAYER_PROJECTIONS) * 2
    want_bodies = {b: 0 for b in bodies}
    for m in (4, 256):        # every llama2-7b width is a multiple of 16
        want_bodies[qmm.qmm_body(torch.bfloat16, m, cfg.d_model, g)] += \
            want // 2
    log(f"[quant] K5 launches {launches['quant_matmul']} (expected {want}); "
        f"every call within kernel_tolerance of the plain version (largest "
        f"err/limit {worst[0]:.3e}); {wall:.1f} s")
    check(launches["quant_matmul"] == want,
          f"quant: K5 launched {launches['quant_matmul']} times, not {want}")
    log(f"[quant] K5 launches by body {bodies} (expected {want_bodies})")
    check(bodies == want_bodies, f"quant: K5 bodies {bodies}, not "
          f"{want_bodies}")
    samples[(cfg.d_model, cfg.vocab_size)] = lm
    rows = []
    for (k, n), q in samples.items():
        for m in (4, 256):
            x = act(m, k)
            ms = time_ms(lambda: quant_dense(x, q))
            life = _life_linear(m, k, n)
            rows.append(dict(m=m, k=k, n=n, ms=ms,
                             life_ms=life.latency * 1e3,
                             life_bound=life.bound,
                             life_t_compute_ms=life.t_compute * 1e3,
                             life_t_memory_ms=life.t_memory * 1e3))
            log(f"[quant] int4 linear m={m} k={k} n={n}: K5 {ms:.4f} ms; "
                f"LIFE on nvidia-h100 {life.latency * 1e3:.4f} ms "
                f"({life.bound}-bound: t_c {life.t_compute * 1e3:.4f}, t_m "
                f"{life.t_memory * 1e3:.4f}, dispatch "
                f"{life.t_dispatch * 1e3:.4f} ms); measured/LIFE "
                f"{ms / (life.latency * 1e3):.2f}")
    summary["quant"] = dict(launches=launches, bodies=bodies,
                            quantized=quantized,
                            storage_bytes=real, worst_err_over_limit=worst[0],
                            wall_s=wall, linears=rows)
    del params, qtree, samples, lm
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase: api.measure on the card against api.forecast for the H100 spec
# ---------------------------------------------------------------------------

def phase_measure(device, summary):
    """``repro_torch.api.measure`` on llama2-7b at full width and depth
    against ``api.forecast`` for ``nvidia-h100`` (:func:`_measure_vs_forecast`)."""
    summary["measure"] = _measure_vs_forecast("llama2-7b", device)


def _measure_vs_forecast(model, device, tp: int = 1, layers=None):
    """``repro_torch.api.measure`` on ``model`` at full width and depth
    (``layers`` deep if given; bf16-bf16, paged attention, 4 slots, 8 requests of 512 + 64 tokens,
    chunk 256, decode block 8, a shared 256-token prefix); K1 and K2 must
    launch.  Then ``api.forecast`` of the same scenario for
    ``nvidia-h100``, declared and replaying the measured trace, and each
    metric's relative error (findings, not gates).  At ``tp > 1`` the
    ranks share this one card (gloo): they launch the kernels in their
    own processes, so the check is the report's plan instead, and the
    forecast is of ``tp`` cards."""
    import math

    import torch
    from repro_torch import api

    scn = api.Scenario(model=model if layers is None else
                       _depth_cfg(model, layers), variant="bf16-bf16",
                       batch=4, n_requests=8, prompt_len=512, gen_len=64, chunk=256,
                       decode_block=8, attn_impl="paged",
                       shared_prefix_len=256, seed=0, tp=tp)
    _reset_launches()                         # the main path starts here
    t0 = time.perf_counter()
    measured = api.measure(scn, device=device, share_device=tp > 1)
    wall = time.perf_counter() - t0
    launches = _launches()                    # ... and ends here
    if tp == 1:
        check(launches["paged_decode"] > 0 and launches["paged_prefill"] > 0,
              f"measure {model} did not launch K1 and K2: {launches}")
    else:
        check(measured.extras["tp"] == tp and measured.trace[0].tp == tp,
              f"measure {model} at tp={tp}: its report says tp="
              f"{measured.extras['tp']}, its trace {measured.trace[0].tp}")
    ex = measured.extras
    check(ex["mode"] == "engine" and ex["requests"] == 8
          and ex["tokens"] == 8 * 64, f"measure extras {ex}")
    check(all(map(math.isfinite, (measured.ttft_s, measured.tpot_s,
                                  measured.tps))), "measure: a metric is "
          "not finite")
    declared = api.forecast(scn, "nvidia-h100")
    replay = api.forecast(scn, "nvidia-h100", trace=measured.trace)
    out = dict(measured=dict(ttft_ms=measured.ttft_s * 1e3,
                             tpot_ms=measured.tpot_s * 1e3,
                             tps=measured.tps, hardware=measured.hardware,
                             prefix_hit_rate=ex["prefix_hit_rate"],
                             wall_s=ex["wall_s"]),
               # a sharded run's launches are counted in its ranks
               launches=({k: launches[k] for k in ENGINE_KERNELS}
                         if tp == 1 else None),
               wall_s=wall)
    for tag, fc in (("declared", declared), ("trace_replay", replay)):
        d = api.compare(fc, measured)
        out[tag] = {name: dict(forecast=m.forecast, measured=m.measured,
                               rel_err=m.rel_err)
                    for name, m in (("ttft_s", d.ttft), ("tpot_s", d.tpot),
                                    ("tps", d.tps))}
        head = (f"{model} {tag} forecast on nvidia-h100 vs measured on "
                f"{measured.hardware}" if tp == 1 else
                f"{model} x{layers or 'all'} layers tp={tp} {tag} forecast "
                f"on {tp} x nvidia-h100 vs "
                f"measured by {tp} ranks sharing one {measured.hardware} "
                f"over gloo (not a {tp}-card measurement)")
        log(f"[measure] {head}: "
            + "; ".join(f"{n} {v['forecast']:.6g} vs {v['measured']:.6g} "
                        f"(rel err {v['rel_err']:+.4f})"
                        for n, v in out[tag].items()))
    log(f"[measure] {model} launches {out['launches']}; prefix hit rate "
        f"{ex['prefix_hit_rate']:.4f}; measured window {ex['wall_s']:.2f} s, "
        f"measure() {wall:.1f} s")
    del measured
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases: the MoE and VLM decoders
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"
VLM_ARCH = "internvl2-26b"


class _MoeRanges:
    """While active, torch.profiler ranges around the port's MoE layer
    (``moe layer``: router, dispatch, experts, combine, shared experts),
    its routed expert products (``moe experts``) and its shared experts
    (``moe shared``), wrapped around ``repro_torch.models.blocks``'
    functions (which look each other up at call time)."""

    NAMES = {"_moe_forward_local": "moe layer", "_experts": "moe experts",
             "_shared": "moe shared"}

    def __enter__(self):
        import torch
        from repro_torch.models import blocks
        self.saved = {f: getattr(blocks, f) for f in self.NAMES}
        for f, name in self.NAMES.items():
            def ranged(*a, _real=self.saved[f], _name=name, **kw):
                with torch.profiler.record_function(_name):
                    return _real(*a, **kw)
            setattr(blocks, f, ranged)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import blocks
        for f, real in self.saved.items():
            setattr(blocks, f, real)


def _moe_classes(prof):
    """Device time (us) of one profiled MoE engine step by class: routed
    expert products, shared experts, router and dispatch (the rest of
    the MoE layer: routing, slot assignment, scatter, gather and
    combine), the port's attention kernels (K1-K4), and everything else
    (attention projections, norms, embedding, lm_head, sampling)."""
    from torch.autograd import DeviceType
    kinds, _ = _device_kinds(prof)
    ranges = dict.fromkeys(_MoeRanges.NAMES.values(), 0.0)
    for evt in prof.key_averages():
        if evt.key in ranges and evt.device_type != DeviceType.CUDA:
            ranges[evt.key] += float(evt.device_time_total)
    busy = sum(kinds.values())
    attn = sum(v for k, v in kinds.items()
               if k.startswith(("paged_", "grouped_lora")))
    experts, shared = ranges["moe experts"], ranges["moe shared"]
    return {"expert products": experts, "shared experts": shared,
            "router and dispatch": ranges["moe layer"] - experts - shared,
            "attention kernels": attn,
            "other": busy - ranges["moe layer"] - attn}, busy


def _moe_engine_config():
    """The moe phase's engine: 4 slots of 512 + 64 (+ 16), chunks of 256,
    decode blocks of 8, bf16 KV in paged blocks of 16."""
    from repro_torch.engine import EngineConfig
    return EngineConfig(max_slots=4, max_len=512 + 64 + 16, chunk_size=256,
                        decode_block=8, block_size=16, n_blocks=512,
                        kv_dtype="bf16", attn_impl="paged")


def _profile_moe(device):
    """qwen2-moe-a2.7b at full width and depth (the moe phase's weights
    and engine), torch.profiler over each step of 4 requests of 512 + 17
    tokens (an admission step, then decode blocks of 8 steps), MoE ranges
    on: each step's device time by class (:func:`_moe_classes`), and per
    decode step of each block on its own.  Run by the profile phase: the
    profiler's processing took most of the moe phase's 90.8-103.6 s."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.engine import Engine
    from repro_torch.models import init_params

    cfg = configs.get(MOE_ARCH)
    params = init_params(cfg, 0, device=device, dtype=torch.bfloat16)
    ec = _moe_engine_config()
    reqs = _requests(cfg.vocab_size, 4, 512, 17, 256, seed=4)
    eng = Engine(cfg, params, ec, device=device)
    eng.warmup()
    for r in reqs:
        eng.submit(r)
    out = []
    with _MoeRanges():
        while not eng.done:
            n0 = len(eng.trace)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            classes, busy = _moe_classes(prof)
            events = [e.kind for e in eng.trace[n0:]]
            kind = "+".join(f"{k}x{events.count(k)}"
                            for k in dict.fromkeys(events))
            steps = sum(e.n_steps for e in eng.trace[n0:]
                        if e.kind == "decode_block")
            out.append(dict(kind=kind, wall_ms=wall * 1e3,
                            busy_ms=busy / 1e3, decode_steps=steps,
                            idle_share=max(0.0, 1 - busy / 1e6 / wall),
                            classes_ms={k: v / 1e3
                                        for k, v in classes.items()}))
            parts = ", ".join(f"{k} {v / 1e3:.2f} ms"
                              for k, v in classes.items())
            log(f"[moe] profile step {len(out) - 1} ({kind}): wall "
                f"{wall * 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
                f"(idle share {out[-1]['idle_share']:.3f}); {parts}")
    del eng, params
    torch.cuda.empty_cache()
    blocks_ = [p for p in out if p["kind"] == "decode_blockx1"]
    check(bool(blocks_), "moe profile: no decode block on its own")
    for p in blocks_:
        per_step = {k: v / p["decode_steps"]
                    for k, v in p["classes_ms"].items()}
        log(f"[moe] decode block of {p['decode_steps']} steps: device "
            f"{p['busy_ms'] / p['decode_steps']:.3f} ms per step ("
            + ", ".join(f"{k} {v:.3f}" for k, v in per_step.items())
            + f"); wall {p['wall_ms'] / p['decode_steps']:.3f} ms per step, "
            f"idle share {p['idle_share']:.3f}")
    return out


def phase_moe(device, summary):
    """qwen2-moe-a2.7b at full width and depth (24 layers, 60 routed
    experts of 1408, top-4, 4 shared; random bf16 weights from seed 0)
    served by the engine with paged attention: the llama2-7b engine
    phase's plain pass (K2 admits, K1 decodes) and its speculative pass
    with four LoRA tenants (K2, K3, K4); ``api.measure`` against
    ``api.forecast`` for ``nvidia-h100``.  The weights are freed at the
    end.  (Its profile by class is the profile phase's.)"""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import init_params

    cfg = configs.get(MOE_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[moe] {MOE_ARCH}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{cfg.n_experts} experts of {cfg.d_ff_expert} (top-{cfg.top_k}) + "
        f"{cfg.n_shared_experts} shared; params {n_params / 1e9:.3f} B "
        f"({n_params * 2 / 1e9:.2f} GB bf16), init "
        f"{time.perf_counter() - t0:.1f} s")
    prompt_len, max_new = 512, 64
    reqs = _requests(cfg.vocab_size, 8, prompt_len, max_new, 256, seed=1)
    ec = _moe_engine_config()
    out = {"params": n_params}
    tenants = 4
    for tag, ec_t, reqs_t, path in (
            ("plain", ec, reqs, ("paged_prefill", "paged_decode")),
            ("spec_lora", dataclasses.replace(
                ec, spec_k=4, lora_tenants=tenants, lora_ranks=(8, 16)),
             _with_tenants(reqs, tenants),
             ("paged_prefill", "paged_verify", "grouped_lora"))):
        torch.cuda.reset_peak_memory_stats(device)
        _reset_launches()                     # this path starts here
        t0 = time.perf_counter()
        eng, results = _serve(cfg, params, ec_t, reqs_t, device)
        wall = time.perf_counter() - t0
        launches = _launches()                # ... and ends here
        bodies = _engine_bodies()
        _check_results(cfg, reqs_t, results, f"moe {tag}")
        if tag == "plain":
            TP1_TOKENS[(MOE_ARCH, None)] = [r.tokens for r in results]
        check(all(launches[k] > 0 for k in path),
              f"moe {tag} did not launch {path}: {launches}")
        _check_engine_bodies(f"moe {tag}", launches, bodies)
        check(results[1].cached_tokens == 256,
              f"moe {tag}: request 1 radix hit {results[1].cached_tokens}")
        r = out[tag] = dict(
            ttft_p50_ms=float(np.median([x.ttft for x in results]) * 1e3),
            tpot_p50_ms=float(np.median([x.tpot for x in results]) * 1e3),
            tps=eng.aggregate_tps(), launches=launches, bodies=bodies,
            kv_pool_gb=eng.cache.total_bytes() / 1e9, wall_s=wall,
            peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9)
        if ec_t.spec_k:
            r.update(spec_acceptance=eng.spec_acceptance,
                     spec_tokens_per_step=eng.spec_tokens_per_step,
                     adapter_hit_rate=eng.adapter_hit_rate)
            check(eng.adapter_pool.misses == tenants,
                  f"moe {tag}: adapter pool misses "
                  f"{eng.adapter_pool.misses}")
        log(f"[moe] {MOE_ARCH} paged bf16 {tag}: 8 requests x ({prompt_len} "
            f"+ {max_new}), 4 slots, KV pool {r['kv_pool_gb']:.2f} GB; TTFT "
            f"p50 {r['ttft_p50_ms']:.2f} ms, TPOT p50 {r['tpot_p50_ms']:.3f} "
            f"ms, TPS {r['tps']:.1f}, peak memory {r['peak_mem_gb']:.2f} GB"
            + (f", acceptance {r['spec_acceptance']:.4f}, tokens/step "
               f"{r['spec_tokens_per_step']:.4f}" if ec_t.spec_k else "")
            + f"; launches {launches}, by body {bodies}; wall {wall:.1f} s "
            f"(warm-up included)")
        del eng
        torch.cuda.empty_cache()
    out["launches_total"] = {k: out["plain"]["launches"][k]
                             + out["spec_lora"]["launches"][k]
                             for k in ENGINE_KERNELS}
    check(all(v > 0 for v in out["launches_total"].values()),
          f"the moe passes did not launch every kernel: "
          f"{out['launches_total']}")
    out["bodies_total"] = {
        w: {b: out["plain"]["bodies"][w][b] + out["spec_lora"]["bodies"][w][b]
            for b in c} for w, c in out["plain"]["bodies"].items()}
    del params
    torch.cuda.empty_cache()
    out["measure"] = _measure_vs_forecast(MOE_ARCH, device)
    summary["moe"] = out


def _vlm_forward(cfg, params, device):
    """One forward of 1 x (vision prefix + 256 text tokens) through the
    flash kernel (K6, one launch per layer, on the body ``flash_body``
    picks), each layer's K6 output held to its plain version on the same
    q, k, v (``kernel_tolerance``), then the eager forward: the logits'
    relative norm difference, top-1 agreement and text cross-entropy.  In
    f32 the two paths must agree within the train phase's f32 limit
    (1e-5); in bf16 the eager path rounds scores and probabilities to
    bf16 where K6 keeps them in f32, so there the difference is a
    finding."""
    import torch
    from repro_torch.models import attention, forward
    from repro_torch.runtime.train import cross_entropy

    fa_ops = _kernel_ops()[2]
    dtype = params["embed"].dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    P = cfg.vision_prefix_len
    ve = torch.randn((1, P, cfg.d_model), generator=gen,
                     device=device).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen,
                         device=device)
    worst = [0.0]
    real = attention.flash_attention

    def held(q, k, v, **kw):
        out = real(q, k, v, **kw)
        ref = fa_ops.attention_ref(q, k, v, **{
            n: kw[n] for n in ("causal", "window", "q_offset") if n in kw})
        _compare(out, ref, v, "vlm flash layer", worst, quiet=True)
        return out

    logits = {}
    with torch.no_grad():
        _reset_launches()
        attention.flash_attention = held
        try:
            logits["flash"], _ = forward(cfg, params, toks, vision_embeds=ve,
                                         use_flash=True)
        finally:
            attention.flash_attention = real
        k6 = (_launches()["flash_fwd"],
              dict(fa_ops.BODY_LAUNCHES["flash_fwd"]))
        logits["eager"], _ = forward(cfg, params, toks, vision_embeds=ve)
    body = fa_ops.flash_body("flash_fwd", dtype, cfg.head_dim)
    check(k6[0] == cfg.n_layers and k6[1][body] == cfg.n_layers,
          f"vlm forward: K6 launches {k6}, expected one per layer on "
          f"{body}")
    fl, ea = logits["flash"].float(), logits["eager"].float()
    check(fl.shape == (1, P + 256, cfg.vocab_size)
          and bool(torch.isfinite(fl).all()), f"vlm forward: logits "
          f"{tuple(fl.shape)}, finite {bool(torch.isfinite(fl).all())}")
    rel = float((fl - ea).norm() / ea.norm())
    mask = torch.ones((1, 255), device=device)
    ce = [float(cross_entropy(x[:, P:-1], toks[:, 1:], mask))
          for x in (fl, ea)]
    top1 = float((fl[0].argmax(-1) == ea[0].argmax(-1)).float().mean())
    limit = 1e-5 if dtype == torch.float32 else None
    tag = f"{cfg.n_layers} layers {str(dtype)[6:]}"
    log(f"[vlm] forward {tag}, 1 x ({P} patches + 256 tokens): K6 x "
        f"{k6[0]} on {body}, each layer's output against its plain version "
        f"largest err/limit {worst[0]:.3e}; flash vs eager logits relative "
        f"norm difference {rel:.3e} (limit {limit or 'none: a finding'}), "
        f"top-1 agreement {top1:.4f}, text cross-entropy {ce[0]:.6f} vs "
        f"{ce[1]:.6f}")
    check(worst[0] <= 1.0, f"vlm forward {tag}: a K6 layer output is "
          f"{worst[0]:.3f} of its limit")
    if limit is not None:
        check(rel <= limit, f"vlm forward {tag}: flash and eager logits "
              f"differ by {rel:.3e} (relative norm)")
    return dict(rel_norm=rel, limit=limit, top1=top1, ce=ce,
                k6_launches=k6[0], body=body, layer_err_ratio=worst[0])


def phase_vlm(device, summary):
    """internvl2-26b at full width and depth (48 layers, d=6144; random
    bf16 weights from seed 0): an engine pass served as text, as both
    packages serve a VLM (paged, 4 requests of 256 + 16 tokens: K2 and
    K1); then one forward of 1 x (256 vision patches + 256 text tokens)
    through the flash kernel (K6) against the eager path
    (:func:`_vlm_forward`), at full depth in bf16 and, with the train
    phase's cut and limit, at 4 layers in f32."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.engine import EngineConfig
    from repro_torch.models import init_params

    cfg = configs.get(VLM_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[vlm] {VLM_ARCH}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"params {n_params / 1e9:.3f} B ({n_params * 2 / 1e9:.2f} GB bf16), "
        f"init {time.perf_counter() - t0:.1f} s")
    prompt_len, max_new = 256, 16
    reqs = _requests(cfg.vocab_size, 4, prompt_len, max_new, 128, seed=6)
    ec = EngineConfig(max_slots=4, max_len=prompt_len + max_new + 16,
                      chunk_size=256, decode_block=8, block_size=16,
                      n_blocks=128, kv_dtype="bf16", attn_impl="paged")
    torch.cuda.reset_peak_memory_stats(device)
    _reset_launches()                         # the engine path starts here
    t0 = time.perf_counter()
    eng, results = _serve(cfg, params, ec, reqs, device)
    wall = time.perf_counter() - t0
    launches = _launches()                    # ... and ends here
    bodies = _engine_bodies()
    _check_results(cfg, reqs, results, "vlm engine")
    check(launches["paged_decode"] > 0 and launches["paged_prefill"] > 0,
          f"vlm engine did not launch K1 and K2: {launches}")
    _check_engine_bodies("vlm engine", launches, bodies)
    out = dict(params=n_params, engine=dict(
        ttft_p50_ms=float(np.median([r.ttft for r in results]) * 1e3),
        tpot_p50_ms=float(np.median([r.tpot for r in results]) * 1e3),
        tps=eng.aggregate_tps(), launches=launches, wall_s=wall,
        peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9))
    r = out["engine"]
    log(f"[vlm] {VLM_ARCH} paged bf16 as text: 4 requests x ({prompt_len} + "
        f"{max_new}); TTFT p50 {r['ttft_p50_ms']:.2f} ms, TPOT p50 "
        f"{r['tpot_p50_ms']:.3f} ms, TPS {r['tps']:.1f}, peak memory "
        f"{r['peak_mem_gb']:.2f} GB; launches {launches}; wall {wall:.1f} s")
    del eng
    torch.cuda.empty_cache()

    out["forward"] = _vlm_forward(cfg, params, device)
    del params
    torch.cuda.empty_cache()
    # f32 at the train phase's cut (4 layers, full width): flash (the fma
    # body) == eager within the train phase's f32 limit
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    params = init_params(cfg4, 0, device=device, dtype=torch.float32)
    out["forward_f32_4_layers"] = _vlm_forward(cfg4, params, device)
    del params
    torch.cuda.empty_cache()
    summary["vlm"] = out


# ---------------------------------------------------------------------------
# phase: the lockstep server and the SSM, hybrid, MLA and encdec families
# ---------------------------------------------------------------------------

class _Capture:
    """While active, ``repro_torch.models.attention.lockstep_blockwise``
    (the step's blockwise branches: K6 on the card) keeps the inputs and
    output of its first call, so that they can be held to the plain
    blockwise loop afterwards; the model looks it up at call time."""

    def __enter__(self):
        from repro_torch.models import attention
        self.real, self.first = attention.lockstep_blockwise, None

        def keep(q, k, v, **kw):
            out = self.real(q, k, v, **kw)
            if self.first is None:
                self.first = (q, k, v, kw, out)
            return out
        attention.lockstep_blockwise = keep
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention
        attention.lockstep_blockwise = self.real

    def held(self, tag):
        """The first call's K6 output against the plain blockwise loop
        on the same q, k, v (``kernel_tolerance``): max|err|, err/limit."""
        from repro_torch.models import attention
        q, k, v, kw, out = self.first
        plain = attention.blockwise_attention(q, k, v, q.shape[-1] ** -0.5,
                                              causal=True, **kw)
        worst = [0.0]
        err = _compare(out, plain, v, f"{tag}: first K6 layer output vs "
                       f"the plain blockwise loop", worst)
        return err, worst[0]


class _SsmRanges:
    """While active, a torch.profiler range (``ssm recurrence``) around
    each position of the selective scan (``blocks._ssm_update``) and each
    chunk's RG-LRU scan (``blocks._rglru_scan``): the recurrences'
    elementwise work, forward (the backward's runs outside any range)."""

    NAME = "ssm recurrence"
    FUNCTIONS = ("_ssm_update", "_rglru_scan")

    def __enter__(self):
        import torch
        from repro_torch.models import blocks
        self.saved = {f: getattr(blocks, f) for f in self.FUNCTIONS}

        def ranged(real):
            def fn(*a):
                with torch.profiler.record_function(self.NAME):
                    return real(*a)
            return fn
        for f, real in self.saved.items():
            setattr(blocks, f, ranged(real))
        return self

    def __exit__(self, *exc):
        from repro_torch.models import blocks
        for f, real in self.saved.items():
            setattr(blocks, f, real)


def _serve_lockstep(tag, cfg, params, device, *, batch, prompt_len, n_new,
                    chunk=None, kv="bf16", max_len=None, extra=None, seed=0,
                    capture=False, mesh=None):
    """The port's lockstep ``Server`` (on this rank of ``mesh``, if
    given) on ``batch`` random prompts, greedy: an untimed two-token
    warm-up (with ``capture``, the first blockwise call is kept for
    :meth:`_Capture.held`), then a timed run with the launch counts
    zeroed before it and read after it, in two legs as ``api.measure``
    times them: TTFT (prefill and the first token), TPOT (the other
    tokens), TPS, peak memory; the record's ``tokens`` are the greedy
    tokens.  On a mesh only rank 0 logs.  Returns (record, server,
    state, last tokens, capture)."""
    import torch
    from repro_torch.engine.sampling import sample
    from repro_torch.runtime import ServeConfig, Server

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=device)
    max_len = max_len or prompt_len + n_new + 8
    server = Server(cfg, params, ServeConfig(batch=batch, max_len=max_len,
                                             chunk_size=chunk, kv_dtype=kv),
                    device=device, mesh=mesh)
    cap = _Capture() if capture else None
    if cap:
        with cap:
            server.generate(prompts, 2, extra=extra)
    else:
        server.generate(prompts, 2, extra=extra)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _reset_launches()                         # the lockstep path starts here
    t0 = time.perf_counter()
    state = server.init_state()
    step = chunk or prompt_len
    for off in range(0, prompt_len, step):
        logits, state = server.prefill(state, prompts[:, off:off + step],
                                       extra if off == 0 else None)
    tok = sample(logits, 0.0, vocab=cfg.vocab_size)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all())
    toks = [tok]
    for _ in range(n_new - 1):
        logits, state = server.decode(state, tok[:, None])
        tok = sample(logits, 0.0, vocab=cfg.vocab_size)
        toks.append(tok)
    toks = torch.stack(toks, dim=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()                    # ... and ends here
    fa_ops = _kernel_ops()[2]
    bodies = dict(fa_ops.BODY_LAUNCHES["flash_fwd"])
    finite = finite and bool(torch.isfinite(logits).all())
    check(finite and tuple(toks.shape) == (batch, n_new)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
          and state["pos"] == prompt_len + n_new - 1,
          f"lockstep {tag}: tokens {tuple(toks.shape)}, logits finite "
          f"{finite}, pos {state['pos']}")
    rec = dict(batch=batch, prompt_len=prompt_len, new_tokens=n_new,
               chunk=chunk, kv=kv, max_len=max_len,
               ttft_ms=ttft * 1e3,
               tpot_ms=(wall - ttft) / max(n_new - 1, 1) * 1e3,
               tps=batch * n_new / wall, wall_s=wall,
               peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9,
               k6_launches=launches["flash_fwd"], k6_bodies=bodies,
               tokens=toks.tolist())
    if mesh is None or mesh.rank == 0:
        log(f"[lockstep] {tag}: {batch} x ({prompt_len} + {n_new})"
            f"{f' in chunks of {chunk}' if chunk else ''}, {kv} KV: TTFT "
            f"{rec['ttft_ms']:.2f} ms, TPOT {rec['tpot_ms']:.3f} ms, TPS "
            f"{rec['tps']:.1f}, peak memory {rec['peak_mem_gb']:.2f} GB, K6 "
            f"launches {launches['flash_fwd']} {bodies}; wall {wall:.2f} s")
    return rec, server, state, tok, cap


def _profile_lockstep_step(tag, server, state, tok):
    """One more decode step under torch.profiler, the recurrence's range
    on: wall, device busy, idle share and device time by class
    (projections: the cuBLAS kernels; the SSM recurrence's elementwise
    work; the rest: norms, the conv, gates, casts, residuals, copies)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with _SsmRanges():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            server.decode(state, tok[:, None])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kinds, _ = _device_kinds(prof)
    recurrence = sum(float(e.device_time_total) for e in prof.key_averages()
                     if e.key == _SsmRanges.NAME
                     and e.device_type != DeviceType.CUDA)
    busy = sum(kinds.values())
    proj = kinds.get("matmul (cuBLAS)", 0.0)
    classes = {"projections": proj, "recurrence": recurrence,
               "rest": busy - proj - recurrence}
    out = dict(wall_ms=wall * 1e3, busy_ms=busy / 1e3,
               idle_share=max(0.0, 1 - busy / 1e6 / wall),
               classes_ms={k: v / 1e3 for k, v in classes.items()})
    log(f"[lockstep] {tag} profile of one decode step: wall "
        f"{wall * 1e3:.2f} ms, device busy {busy / 1e3:.3f} ms (idle share "
        f"{out['idle_share']:.3f}); "
        + ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in classes.items()))
    return out


def _lockstep_measure(device, tp: int = 1, layers=None):
    """``api.measure`` on falcon-mamba-7b (``layers`` deep if given; the
    lockstep branch: 4 x (512 + 64), chunk 256; at ``tp > 1`` its ranks
    share this card over gloo)
    beside ``api.forecast(..., "nvidia-h100")`` of the same scenario (of
    ``tp`` cards), each metric's relative error (a finding, not a
    gate)."""
    import math
    from repro_torch import api

    scn = api.Scenario(model="falcon-mamba-7b" if layers is None else
                       _depth_cfg("falcon-mamba-7b", layers),
                       variant="bf16-bf16", batch=4, prompt_len=512, gen_len=64, chunk=256, seed=0, tp=tp)
    measured = api.measure(scn, device=device, share_device=tp > 1)
    ex = measured.extras
    check(ex["mode"] == "legacy-lockstep" and ex["tokens"] == 4 * 64
          and all(map(math.isfinite, (measured.ttft_s, measured.tpot_s,
                                      measured.tps))),
          f"lockstep measure: extras {ex}")
    d = api.compare(api.forecast(scn, "nvidia-h100"), measured)
    out = {name: dict(forecast=m.forecast, measured=m.measured,
                      rel_err=m.rel_err)
           for name, m in (("ttft_s", d.ttft), ("tpot_s", d.tpot),
                           ("tps", d.tps))}
    where = (f"nvidia-h100 vs measured on {measured.hardware}" if tp == 1
             else f"{tp} x nvidia-h100 vs measured by {tp} ranks sharing "
             f"one {measured.hardware} over gloo (not a {tp}-card "
             f"measurement)")
    log(f"[measure] falcon-mamba-7b x{layers or 'all'} layers tp={tp} "
        f"declared forecast on {where} "
        f"(lockstep): "
        + "; ".join(f"{n} {v['forecast']:.6g} vs {v['measured']:.6g} "
                    f"(rel err {v['rel_err']:+.4f})" for n, v in out.items()))
    return out


#: the lockstep phase's K6 shapes: (b, s, L, H, Hk, d, causal, window,
#: q_offset) — recurrentgemma-2b's local layers at a 2048-token prompt,
#: llama2-7b's layers at a 4096-token prompt over a 5120-position cache
K6_LOCKSTEP = {"recurrentgemma-2b": (4, 2048, 2048, 10, 1, 256, True, 2048, 0),
               "llama2-7b": (1, 4096, 5120, 32, 32, 128, True, None, 0)}
#: the same at a tp = 2 rank's heads: recurrentgemma-2b's 5 of 10 query
#: heads over its one KV head (kept whole), llama2-7b's 16 of 32
K6_LOCKSTEP_TP2 = {
    "recurrentgemma-2b": (4, 2048, 2048, 5, 1, 256, True, 2048, 0),
    "llama2-7b": (1, 4096, 5120, 16, 16, 128, True, None, 0)}


def _k6_fwd_kernel(body: str, d: int) -> str:
    """The CUDA function K6's forward runs on ``body`` at head dim d."""
    if body == "fma":
        return "flash_fwd_kernel"
    return "flash_fwd_mma_wide_kernel" if d > 128 else "flash_fwd_mma_kernel"


def _time_k6_lockstep(case, device, tag="lockstep"):
    """K6 at a lockstep shape (bf16) on the body ``flash_body`` picks for
    the forward and, where that is ``mma``, on the ``fma`` body forced
    (its time the earlier one), each held to the plain blockwise loop,
    then timed (events and device time; ``fma`` in fewer calls) beside
    the plain loop, SDPA with an explicit boolean mask (its device time
    too) and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import attention

    fa_ops = _kernel_ops()[2]
    b, s, L, H, Hk, d, causal, window, q_offset = case
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    mk = lambda *shape: torch.randn(shape, generator=gen,
                                    device=device).to(torch.bfloat16)
    q, k, v = mk(b, s, H, d), mk(b, L, Hk, d), mk(b, L, Hk, d)
    q5 = q.view(b, s, Hk, H // Hk, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    on = lambda body: (lambda: fa_ops.flash_fwd(q, k, v, body=body, **kw))
    plain = lambda: attention.blockwise_attention(q5, k, v, d ** -0.5,
                                                  **kw)
    want = plain()
    rule = fa_ops.flash_body("flash_fwd", torch.bfloat16, d)
    held = {}
    for body in dict.fromkeys((rule, "fma")):
        worst = [0.0]
        err = _compare(on(body)()[0].reshape(b, s, H * d), want, v,
                       f"flash_fwd lockstep {case} ({body})", worst)
        held[body] = (err, worst[0])
    del want
    qp = q_offset + torch.arange(s, device=device)[:, None]
    kp = torch.arange(L, device=device)[None, :]
    mask = kp <= qp
    if window:
        mask &= kp > qp - window
    ql, kl, vl = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(
        ql, kl, vl, attn_mask=mask[None, None], enable_gqa=Hk != H)
    bound, bound_by = flash_bound(case, 2, backward=False)
    shape = (f"b={b} s={s} L={L} H={H} Hk={Hk} d={d} causal"
             f"{f' window={window}' if window else ''} q_offset={q_offset} "
             f"bf16 (lockstep)")
    rec = dict(ms=time_ms(on(rule)), **device_rec("device_ms", on(rule)),
               body=rule, kernel=_k6_fwd_kernel(rule, d),
               plain_ms=time_ms(plain, iters=5, warmup=1),
               library_ms=time_ms(sdpa),
               **device_rec("library_device_ms", sdpa),
               bound_ms=bound, bound_by=bound_by, max_abs_err=held[rule][0],
               err_ratio=held[rule][1], shape=shape)
    earlier = ""
    if rule != "fma":
        rec["fma"] = dict(ms=time_ms(on("fma"), iters=5, warmup=1),
                          **device_rec("device_ms", on("fma"), iters=5),
                          kernel=_k6_fwd_kernel("fma", d),
                          max_abs_err=held["fma"][0],
                          err_ratio=held["fma"][1])
        earlier = (f" [fma {rec['fma']['ms']:.4f} ms, device "
                   f"{fmt_ms(rec['fma']['device_ms'])}]")
        _log_misses(f"{tag} fma", rec["fma"])
    log(f"[{tag}] K6 at {shape} on {rec['body']} ({rec['kernel']}): "
        f"{rec['ms']:.4f} ms (device {fmt_ms(rec['device_ms'])}){earlier}, "
        f"err/limit {rec['err_ratio']:.4f}, plain blockwise "
        f"{rec['plain_ms']:.4f} ms, SDPA with a boolean mask "
        f"{rec['library_ms']:.4f} ms (device "
        f"{fmt_ms(rec['library_device_ms'])}), bound {bound:.4f} ms "
        f"({bound_by})")
    _log_misses(tag, rec)
    return rec


def _log_misses(tag: str, rec: dict) -> None:
    """A log line for each device time of ``rec`` that is null, with
    the event counts of every profile taken (:func:`device_rec`)."""
    for key, why in rec.items():
        if key.endswith("_why"):
            log(f"[{tag}] {key[:-4]} not measured at {rec.get('shape')}: "
                f"{why.get('iters')} calls profiled; event counts by "
                f"kernel, per try: {why.get('tries')}")


#: the lockstep serving runs at full width and depth, by tag: (arch,
#: ``_serve_lockstep`` keywords).  The lockstep phase serves each on one
#: rank, the multidevice phase on a mesh.
LOCKSTEP_RUNS = {
    "falcon-mamba-7b": ("falcon-mamba-7b", dict(
        batch=4, prompt_len=512, n_new=64, chunk=256)),
    "recurrentgemma-2b": ("recurrentgemma-2b", dict(
        batch=4, prompt_len=2048, n_new=64, capture=True)),
    "llama2-7b-mla bf16": ("llama2-7b-mla", dict(
        batch=4, prompt_len=512, n_new=64, chunk=256, kv="bf16")),
    "llama2-7b-mla int8": ("llama2-7b-mla", dict(
        batch=4, prompt_len=512, n_new=64, chunk=256, kv="int8")),
    "whisper-base": ("whisper-base", dict(batch=4, prompt_len=16, n_new=64)),
    "llama2-7b": ("llama2-7b", dict(batch=1, prompt_len=4096, n_new=64,
                                    max_len=5120, capture=True)),
}
#: each run's one-rank record with its greedy tokens by (tag, layers;
#: None: the full depth), kept by the lockstep phase (and the
#: multidevice phase at a world's cut depth) for the multidevice
#: phase's comparison
TP1_LOCKSTEP: dict = {}


def _lockstep_extra(cfg, device):
    """whisper-base's 1500 random encoder frames for 4 prompts (seed 8,
    bf16, at prefill); nothing for the other families."""
    import torch
    if cfg.family != "encdec":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    return {"frames": torch.randn((4, cfg.encoder_len, cfg.d_model),
                                  generator=gen, device=device).to(
        torch.bfloat16)}


def _run_lockstep(tag, cfg, params, device, mesh=None, layers=None):
    """:func:`_serve_lockstep` of ``LOCKSTEP_RUNS[tag]`` (``cfg`` cut to
    ``layers``; None: the full depth); on one rank its record and tokens
    are kept in ``TP1_LOCKSTEP`` under ``(tag, layers)``."""
    kw = LOCKSTEP_RUNS[tag][1]
    out = _serve_lockstep(tag, cfg, params, device, mesh=mesh,
                          extra=_lockstep_extra(cfg, device), **kw)
    if mesh is None:
        TP1_LOCKSTEP[(tag, layers)] = dict(out[0])
    return out


def phase_lockstep(device, summary, engine_tpot_ms=None):
    """The lockstep ``Server`` (``repro_torch.runtime.serve``) at full
    width and depth, random bf16 weights from seed 0, each model freed
    before the next: falcon-mamba-7b (4 x (512 + 64) in chunks of 256, a
    profiled decode step, ``api.measure`` against the forecast);
    recurrentgemma-2b (4 x 2048 unchunked, so its 8 local layers take the
    blockwise branch through K6, then 63 decode steps on the ring);
    llama2-7b-mla (4 x (512 + 64) in chunks of 256, bf16 then int8 KV);
    whisper-base (4 x (16 + 64), 1500 random encoder frames at prefill);
    llama2-7b (1 x 4096 over a 5120-position cache: 32 K6 launches on the
    dense branch, 63 decode steps).  K6 launches are zeroed before each
    timed run and read after it; each checked K6 output is held to the
    plain blockwise loop; llama2-7b's TPOT is printed beside the engine
    phase's TPOT p50 (``engine_tpot_ms``) where that phase ran.  Then K6
    timed at the two lockstep shapes."""
    import torch
    from repro_torch import configs
    from repro_torch.models import init_params

    fa_ops = _kernel_ops()[2]
    t_phase = time.perf_counter()
    out = {"k6_launches": 0, "k6_bodies": {b: 0 for b in fa_ops.BODIES},
           "card": card_name_and_power_limit()}
    log(f"[lockstep] on {out['card']}")

    def load(arch):
        cfg = configs.get(arch)
        params = init_params(cfg, 0, device=device, dtype=torch.bfloat16)
        n = sum(t.numel() for t in _leaves(params))
        log(f"[lockstep] {arch}: {cfg.n_layers} layers, d={cfg.d_model}, "
            f"params {n / 1e9:.3f} B")
        return cfg, params

    def count_k6(rec, want, body):
        check(rec["k6_launches"] == want
              and rec["k6_bodies"].get(body) == want,
              f"lockstep: K6 launches {rec['k6_launches']} "
              f"{rec['k6_bodies']}, expected {want} on {body}")
        out["k6_launches"] += rec["k6_launches"]
        for b_, n in rec["k6_bodies"].items():
            out["k6_bodies"][b_] += n

    # falcon-mamba-7b
    cfg, params = load("falcon-mamba-7b")
    rec, server, state, tok, _ = _run_lockstep("falcon-mamba-7b", cfg,
                                               params, device)
    rec["profile"] = _profile_lockstep_step("falcon-mamba-7b", server,
                                            state, tok)
    out["falcon-mamba-7b"] = rec
    del server, state, params
    torch.cuda.empty_cache()
    out["falcon-mamba-7b"]["measure"] = _lockstep_measure(device)
    torch.cuda.empty_cache()

    # recurrentgemma-2b: the local layers' blockwise branch through K6
    cfg, params = load("recurrentgemma-2b")
    n_local = cfg.block_kinds().count("attn")
    rec, server, state, _, cap = _run_lockstep("recurrentgemma-2b", cfg,
                                               params, device)
    count_k6(rec, n_local, fa_ops.flash_body("flash_fwd", torch.bfloat16,
                                             cfg.head_dim))
    rec["k6_first_layer"] = cap.held("recurrentgemma-2b")
    out["recurrentgemma-2b"] = rec
    del server, state, params, cap
    torch.cuda.empty_cache()

    # llama2-7b-mla: the latent cache, bf16 then int8
    cfg, params = load("llama2-7b-mla")
    out["llama2-7b-mla"] = {}
    for kv in ("bf16", "int8"):
        rec, server, state, _, _ = _run_lockstep(f"llama2-7b-mla {kv}", cfg,
                                                 params, device)
        out["llama2-7b-mla"][kv] = rec
        del server, state
    del params
    torch.cuda.empty_cache()

    # whisper-base: encoder frames at prefill
    cfg, params = load("whisper-base")
    rec, server, state, _, _ = _run_lockstep("whisper-base", cfg, params,
                                             device)
    check(bool(state["cross_k"].abs().sum() > 0), "lockstep whisper-base: "
          "the cross K/V were not encoded from the frames")
    out["whisper-base"] = rec
    del server, state, params
    torch.cuda.empty_cache()

    # llama2-7b: a 4096-token prompt takes the dense blockwise branch
    cfg, params = load("llama2-7b")
    rec, server, state, _, cap = _run_lockstep("llama2-7b", cfg, params,
                                               device)
    count_k6(rec, cfg.n_layers, fa_ops.flash_body("flash_fwd",
                                                  torch.bfloat16,
                                                  cfg.head_dim))
    rec["k6_first_layer"] = cap.held("llama2-7b")
    rec["engine_tpot_p50_ms"] = engine_tpot_ms
    engine = (f"{engine_tpot_ms:.3f} ms (4 slots, 512 + 64)"
              if engine_tpot_ms is not None else "not measured (no engine "
              "phase in this run)")
    log(f"[lockstep] llama2-7b lockstep TPOT {rec['tpot_ms']:.3f} ms (1 x "
        f"4096, 5120-position cache) beside the engine phase's TPOT p50 "
        f"{engine} in this run")
    out["llama2-7b"] = rec
    del server, state, params, cap
    torch.cuda.empty_cache()

    out["k6_shapes"] = {arch: _time_k6_lockstep(case, device)
                        for arch, case in K6_LOCKSTEP.items()}
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[lockstep] K6 launches {out['k6_launches']} {out['k6_bodies']}; "
        f"phase wall {out['wall_s']:.1f} s")
    for rec in (out[a] for a in ("falcon-mamba-7b", "recurrentgemma-2b",
                                 "whisper-base", "llama2-7b")):
        rec.pop("tokens")
    for rec in out["llama2-7b-mla"].values():
        rec.pop("tokens")
    summary["lockstep"] = out


def _lockstep_parity(device):
    """Each lockstep family at full width with 4 layers (recurrentgemma-2b:
    rglru, rglru, attn, rglru) and f32 weights: the logits of ``step``
    fed one token at a time (f32 KV) equal ``forward``'s last-position
    logits within 1e-4 (relative norm)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import forward, init_decode_state, init_params, step

    for arch in ("falcon-mamba-7b", "recurrentgemma-2b", "llama2-7b-mla",
                 "whisper-base"):
        cfg = dataclasses.replace(configs.get(arch), n_layers=4)
        params = init_params(cfg, 0, device=device, dtype=torch.float32)
        gen = torch.Generator(device=device)
        gen.manual_seed(9)
        toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                             device=device)
        extra = {}
        if cfg.family == "encdec":
            extra["frames"] = torch.randn(
                (2, cfg.encoder_len, cfg.d_model), generator=gen,
                device=device)
        with torch.no_grad():
            full, _ = forward(cfg, params, toks, **extra)
            state = init_decode_state(cfg, 2, 24, torch.float32,
                                      device=device)
            for t in range(toks.shape[1]):
                last, state = step(cfg, params, toks[:, t:t + 1], state,
                                   **(extra if t == 0 else {}))
        want = full[:, -1].double()
        rel = float((last.double() - want).norm() / want.norm())
        log(f"[parity] {arch} x4 layers f32: token-by-token step vs "
            f"forward last-position logits, relative norm {rel:.3e} "
            f"(limit 1e-4)")
        check(rel <= 1e-4, f"{arch}: step and forward logits differ by "
              f"{rel:.3e}")
        del params, state, full
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 11: tensor- and pipeline-parallel serving, ranks sharing the card
# ---------------------------------------------------------------------------

#: each plain pass's tp = 1 tokens by (arch, layers; None: the full
#: depth), kept by the engine and moe phases for the multidevice phase's
#: bf16 agreement share
TP1_TOKENS: dict = {}

#: the multidevice worlds, in order: (arch, tp, pp, layers of the serving
#: passes (None: the full depth), serving passes at full width in bf16,
#: parity jobs at 4 layers in f32 weights: a KV dtype, or ``spec_lora``
#: with f32 KV).  Every world serves ``MD_LAYERS``, and api.measure at
#: tp=2 too, for the 1200 s limit: with tp=2 at 8 layers and pp=2 at the
#: full depth the script took 1040.8 s of phases on one host and passed
#: 1200 s on a slower one, where ranks sharing a card over gloo pay most
MD_LAYERS = 4
MD_WORLDS = (
    ("llama2-7b", 2, 1, MD_LAYERS, ("plain", "spec_lora"),
     ("fp32", "bf16", "int8", "spec_lora")),
    ("llama2-7b", 1, 2, MD_LAYERS, ("plain",), ("fp32", "bf16", "int8")),
    ("llama2-7b", 2, 2, MD_LAYERS, ("plain",), ("fp32", "bf16", "int8")),
    (MOE_ARCH, 2, 1, MD_LAYERS, ("plain",), ("fp32", "bf16", "int8")),
)
MD_PARITY_LAYERS = 4


def _depth_cfg(arch: str, layers=None):
    """``arch``'s config at full width, cut to ``layers`` if given and
    shallower than the model."""
    from repro_torch import configs
    cfg = configs.get(arch)
    if layers is None or layers >= cfg.n_layers:
        return cfg
    return dataclasses.replace(cfg, n_layers=layers)


def _md_exact(tag: str, tp: int) -> bool:
    """Whether a parity job must give tp = 1's tokens exactly.  Stages
    run tp = 1's op sequence, so every job must at pp.  Tensor
    parallelism sums the row-parallel products in another order; in f32
    that moves a logit by ~1e-6, but a bf16 or int8 KV cache rounds the
    moved K/V to another value now and then (on the card, llama2-7b x4:
    logits 3.8e-3 apart with bf16 KV, 6.8e-2 with int8, 0 at pp = 2), so
    exactness is required of the f32 caches only, as the parity phase
    requires it of runs that batch their rows differently; the others
    report the share of equal tokens."""
    return tp == 1 or tag in ("fp32", "spec_lora")


def _md_config(tag: str, parity: bool):
    """The engine phase's passes (``plain``, ``spec_lora``) at full size,
    or the parity phase's geometry with a KV dtype (``fp32``, ``bf16``,
    ``int8``) or the speculative LoRA features (``spec_lora``, f32 KV)."""
    from repro_torch.engine import EngineConfig
    if parity:
        ec = EngineConfig(max_slots=4, max_len=128, chunk_size=64,
                          decode_block=4, block_size=16, attn_impl="paged",
                          kv_dtype=tag if tag in ("bf16", "int8")
                          else "fp32")
    else:
        ec = EngineConfig(max_slots=4, max_len=512 + 64 + 16, chunk_size=256,
                          decode_block=8, block_size=16, n_blocks=512,
                          kv_dtype="bf16", attn_impl="paged")
    if tag == "spec_lora":
        ec = dataclasses.replace(ec, spec_k=4, lora_tenants=4,
                                 lora_ranks=(8, 16))
    return ec


def _md_requests(cfg, tag: str, parity: bool):
    reqs = (_requests(cfg.vocab_size, 6, 100, 16, 48, seed=3) if parity
            else _requests(cfg.vocab_size, 8, 512, 64, 256, seed=1))
    return _with_tenants(reqs, 4) if tag == "spec_lora" else reqs


def _md_tokens(cfg, params, tag: str, device, mesh=None):
    """A parity job's greedy tokens, on one device or on ``mesh``."""
    from repro_torch.engine import Engine
    eng = Engine(cfg, params, _md_config(tag, True), device=device,
                 mesh=mesh)
    return [r.tokens for r in eng.run(_md_requests(cfg, tag, True))]


def _md_rank(mesh, arch, layers, passes, parity):
    """One rank of a multidevice world (every rank on the one card): its
    shard of the seed-0 bf16 weights at full width (``layers`` deep;
    None: the full depth), the serving passes, each with this process's
    launch counts zeroed before it and read after it; then its shard of
    the f32 weights at 4 layers and the parity jobs' tokens.  Returns
    what the parent checks."""
    import numpy as np
    import torch
    from repro_torch.engine import Engine
    from repro_torch.runtime.sharding import init_shard

    dev = mesh.device
    cfg = _depth_cfg(arch, layers)
    out = dict(rank=mesh.rank, coords=dict(mesh.coords),
               backend=mesh.backend, passes={}, parity={})
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_shard(cfg, 0, mesh, device=dev)
    torch.cuda.synchronize(dev)
    out["init_s"] = time.perf_counter() - t0
    out["params_gb"] = sum(t.numel() * t.element_size()
                           for t in _leaves(params)) / 1e9
    out["init_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    for tag in passes:
        ec = _md_config(tag, False)
        reqs = _md_requests(cfg, tag, False)
        _reset_launches()                     # this rank's path starts here
        t0 = time.perf_counter()
        eng = Engine(cfg, params, ec, mesh=mesh)
        eng.warmup()
        results = eng.run(reqs)
        wall = time.perf_counter() - t0
        launches, bodies = _launches(), _engine_bodies()   # ... ends here
        _check_results(cfg, reqs, results, f"{arch} rank {mesh.rank} {tag}")
        out["passes"][tag] = dict(
            launches=launches, bodies=bodies, wall_s=wall,
            tokens=[r.tokens for r in results],
            cached=[r.cached_tokens for r in results],
            ttft_p50_ms=float(np.median([r.ttft for r in results]) * 1e3),
            tpot_p50_ms=float(np.median([r.tpot for r in results]) * 1e3),
            tps=eng.aggregate_tps(),
            pool=list(eng.state["cache_k"].shape),
            pool_gb=eng.cache.total_bytes() / 1e9,
            lanes=(int(eng.state["lora_A_q"].shape[-1])
                   if ec.lora_tenants else 0),
            spec_acceptance=eng.spec_acceptance if ec.spec_k else None)
        del eng
        torch.cuda.empty_cache()
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["collectives"] = _md_collectives(mesh, cfg.d_model)
    del params
    torch.cuda.empty_cache()
    if parity:
        cfg4 = dataclasses.replace(cfg, n_layers=MD_PARITY_LAYERS)
        params = init_shard(cfg4, 0, mesh, device=dev, dtype=torch.float32)
        for tag in parity:
            out["parity"][tag] = _md_tokens(cfg4, params, tag, dev, mesh)
        del params
        torch.cuda.empty_cache()
    return out


def _md_collectives(mesh, width: int) -> dict:
    """Wall milliseconds per collective on this rank (50 calls after 5,
    the stream synchronised after them), at a decode step's (4, 1, d) and
    a prefill chunk's (1, 256, d) bf16 activation: the tp group's
    all_reduce, or at tp = 1 the broadcast along the pipeline column."""
    import torch
    import torch.distributed as dist

    out = {}
    for name, shape in (("decode", (4, 1, width)), ("chunk", (1, 256, width))):
        x = torch.zeros(shape, dtype=torch.bfloat16, device=mesh.device)
        if mesh.groups["model"] is not None:
            key, fn = "all_reduce", lambda: dist.all_reduce(
                x, group=mesh.groups["model"])
        else:
            key, fn = "broadcast", lambda: mesh.from_last_stage(x)
        for _ in range(5):
            fn()
        torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        torch.cuda.synchronize(mesh.device)
        out[f"{key}_{name}_ms"] = (time.perf_counter() - t0) / 50 * 1e3
    return out


#: the lockstep worlds: (tp, pp, layers of the served runs (None: the
#: full depth; whisper-base's 6 stay whole), ``LOCKSTEP_RUNS`` served at
#: full width in bf16, families whose 4-layer f32 tokens are held to
#: tp = 1's with each of ``MDL_KVS``).  Both serve ``MD_LAYERS``, for
#: the 1200 s limit: tp=2 took 100.3-139.5 s at full depth, 52.8 s at 8
#: layers; recurrentgemma-2b keeps one local attention layer of 4
MDL_FAMILIES = ("falcon-mamba-7b", "recurrentgemma-2b", "llama2-7b-mla",
                "whisper-base")
MDL_WORLDS = (
    (2, 1, MD_LAYERS, tuple(LOCKSTEP_RUNS), MDL_FAMILIES),
    (1, 2, MD_LAYERS, ("falcon-mamba-7b",), MDL_FAMILIES),
)
MDL_KVS = ("fp32", "bf16", "int8")


def _mdl_exact(arch: str, kv: str, tp: int) -> bool:
    """Whether a lockstep parity job must give tp = 1's tokens exactly:
    at pp (the stages run tp = 1's op sequence), falcon-mamba-7b (no KV
    cache to round the all-reduce's other sum order), and f32 caches;
    bf16 or int8 KV at tp report the share (``_md_exact``)."""
    return tp == 1 or arch == "falcon-mamba-7b" or kv == "fp32"


def _mdl_parity_tokens(cfg, params, kv, device, mesh=None):
    """A lockstep parity job's greedy tokens: 2 random prompts of 48 in
    chunks of 16 (and whisper-base's 1500 random f32 frames), 16 new
    tokens, on one device or on this rank of ``mesh``."""
    import torch
    from repro_torch.runtime import ServeConfig, Server
    gen = torch.Generator(device=device)
    gen.manual_seed(9)
    prompts = torch.randint(0, cfg.vocab_size, (2, 48), generator=gen,
                            device=device)
    extra = None
    if cfg.family == "encdec":
        extra = {"frames": torch.randn((2, cfg.encoder_len, cfg.d_model),
                                       generator=gen, device=device)}
    sc = ServeConfig(batch=2, max_len=72, chunk_size=16, kv_dtype=kv)
    toks, _ = Server(cfg, params, sc, device=device, mesh=mesh).generate(
        prompts, 16, extra=extra)
    return toks.tolist()


def _mdl_rank(mesh, layers, runs, parity):
    """One rank of a lockstep world (every rank on the one card): for each
    run its shard of the seed-0 bf16 weights at full width (``layers``
    deep; None: the full depth),
    drawn leaf by leaf, and :func:`_run_lockstep` with this process's
    launch counts zeroed before the timed run and read after it (the
    first K6 call held to the plain loop), the collectives' ms at the
    model's width; then the 4-layer f32 parity tokens.  Returns what the
    parent checks."""
    import torch
    from repro_torch import configs
    from repro_torch.runtime.sharding import init_shard

    dev = mesh.device
    out = dict(rank=mesh.rank, coords=dict(mesh.coords),
               backend=mesh.backend, runs={}, parity={})
    for tag in runs:
        cfg = _depth_cfg(LOCKSTEP_RUNS[tag][0], layers)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = init_shard(cfg, 0, mesh, device=dev)
        torch.cuda.synchronize(dev)
        init = dict(init_s=time.perf_counter() - t0,
                    params_gb=sum(t.numel() * t.element_size()
                                  for t in _leaves(params)) / 1e9,
                    init_peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        rec, server, state, _, cap = _run_lockstep(tag, cfg, params, dev,
                                                   mesh)
        rec.update(init, state_gb=sum(
            t.numel() * t.element_size() for k, t in state.items()
            if k != "pos") / 1e9, collectives=_md_collectives(
                mesh, cfg.d_model))
        if cap:
            rec["k6_first_layer"] = cap.held(f"{tag} rank {mesh.rank}")
        out["runs"][tag] = rec
        del params, server, state, cap
        torch.cuda.empty_cache()
    for arch in parity:
        cfg4 = dataclasses.replace(configs.get(arch),
                                   n_layers=MD_PARITY_LAYERS)
        params = init_shard(cfg4, 0, mesh, device=dev, dtype=torch.float32)
        out["parity"][arch] = {kv: _mdl_parity_tokens(cfg4, params, kv, dev,
                                                      mesh)
                               for kv in MDL_KVS}
        del params
        torch.cuda.empty_cache()
    return out


def _md_jobs_rank(mesh, jobs):
    """This rank's part of one spawn's worlds: each job of ``jobs``
    (``("md", args)`` for :func:`_md_rank`, ``("mdl", args)`` for
    :func:`_mdl_rank`) in turn, each freeing its weights before the
    next, with its wall seconds (``job_s``)."""
    out = []
    for kind, args in jobs:
        t0 = time.perf_counter()
        rec = {"md": _md_rank, "mdl": _mdl_rank}[kind](mesh, *args)
        rec["job_s"] = time.perf_counter() - t0
        out.append(rec)
    return out


def _md_spawns(device) -> dict:
    """The worlds of ``MD_WORLDS`` and ``MDL_WORLDS``, one spawn per mesh
    shape (tp=2, pp=2, tp=2 x pp=2), so a shape's ranks start their
    processes once (~10 s a spawn on the card): each world's ranks under
    ``("md", i)`` or ``("mdl", j)``, with its wall seconds (the slowest
    rank's job) and its spawn's."""
    from repro_torch.launch.mesh import spawn
    groups: dict = {}
    for i, (arch, tp, pp, layers, passes, parity) in enumerate(MD_WORLDS):
        groups.setdefault((tp, pp), []).append(
            (("md", i), ("md", (arch, layers, passes, parity))))
    for j, (tp, pp, layers, runs, parity) in enumerate(MDL_WORLDS):
        groups.setdefault((tp, pp), []).append(
            (("mdl", j), ("mdl", (layers, runs, parity))))
    got = {}
    for (tp, pp), members in groups.items():
        t0 = time.perf_counter()
        ranks = spawn(_md_jobs_rank, ([job for _, job in members],),
                      model=tp, pipe=pp, device=device, share_device=True)
        spawn_s = time.perf_counter() - t0
        for k, (key, _) in enumerate(members):
            recs = [r[k] for r in ranks]
            got[key] = dict(ranks=recs, spawn_s=spawn_s,
                            wall_s=max(r["job_s"] for r in recs))
    return got


def _md_lockstep(device, out, card, spawned):
    """The lockstep worlds of ``MDL_WORLDS`` (their ranks' records in
    ``spawned``, :func:`_md_spawns`) against one rank in this process:
    the lockstep phase's records where it ran and the world serves the
    full depth (else each run here, at the world's depth) and the
    4-layer f32 parity tokens; then ``api.measure`` of falcon-mamba-7b at
    tp = 2.  Returns the K6 launches and bodies summed over every
    rank."""
    import torch
    from repro_torch import configs
    from repro_torch.models import init_params

    fa_ops = _kernel_ops()[2]
    k6 = {"launches": 0, "bodies": {b: 0 for b in fa_ops.BODIES}}
    refs = {}
    for arch in dict.fromkeys(a for w in MDL_WORLDS for a in w[4]):
        cfg4 = dataclasses.replace(configs.get(arch),
                                   n_layers=MD_PARITY_LAYERS)
        params = init_params(cfg4, 0, device=device, dtype=torch.float32)
        refs[arch] = {kv: _mdl_parity_tokens(cfg4, params, kv, device)
                      for kv in MDL_KVS}
        del params
        torch.cuda.empty_cache()
    for tag, layers in dict.fromkeys((t, w[2]) for w in MDL_WORLDS
                                     for t in w[3]):
        if (tag, layers) not in TP1_LOCKSTEP:   # the lockstep phase's, or:
            cfg = _depth_cfg(LOCKSTEP_RUNS[tag][0], layers)
            params = init_params(cfg, 0, device=device)
            _run_lockstep(tag, cfg, params, device, layers=layers)
            del params
            torch.cuda.empty_cache()
    worlds = {}
    for j, (tp, pp, layers, runs, parity) in enumerate(MDL_WORLDS):
        label = f"lockstep tp={tp} x pp={pp}" + (
            f" x{layers} layers" if layers else "")
        ranks = spawned[("mdl", j)]["ranks"]
        world = dict(wall_s=spawned[("mdl", j)]["wall_s"],
                     spawn_s=spawned[("mdl", j)]["spawn_s"], runs={},
                     parity={})
        check(all(r["backend"] == "gloo" for r in ranks),
              f"{label}: ranks sharing a card must run gloo")
        for tag in runs:
            arch, kw = LOCKSTEP_RUNS[tag]
            cfg = _depth_cfg(arch, layers)
            recs = [r["runs"][tag] for r in ranks]
            first, one = recs[0], TP1_LOCKSTEP[(tag, layers)]
            want_k6 = {"recurrentgemma-2b": cfg.block_kinds().count("attn"),
                       "llama2-7b": cfg.n_layers}.get(tag, 0) // pp
            body = fa_ops.flash_body("flash_fwd", torch.bfloat16,
                                     cfg.head_dim or 128)
            for r, rec in zip(ranks, recs):
                where = f"{label} {tag} rank {r['rank']}"
                check(rec["tokens"] == first["tokens"],
                      f"{where}: its tokens are not rank 0's")
                check(rec["k6_launches"] == want_k6 and (
                    not want_k6 or rec["k6_bodies"].get(body) == want_k6),
                      f"{where}: K6 launches {rec['k6_launches']} "
                      f"{rec['k6_bodies']}, expected {want_k6} on {body}")
                k6["launches"] += rec["k6_launches"]
                for b_, n in rec["k6_bodies"].items():
                    k6["bodies"][b_] += n
            pairs = [(a, b) for g, w_ in zip(first["tokens"], one["tokens"])
                     for a, b in zip(g, w_)]
            same = sum(a == b for a, b in pairs) / len(pairs)
            keys = ("ttft_ms", "tpot_ms", "tps")
            w = dict({k: first[k] for k in keys},
                     tp1={k: one[k] for k in keys},
                     ratio={k: first[k] / one[k] for k in keys},
                     same_tokens_as_tp1=same,
                     k6_launches=sum(r["k6_launches"] for r in recs),
                     k6_first_layer=[r.get("k6_first_layer") for r in recs],
                     ranks=[dict(coords=r["coords"], **{k: rec[k] for k in (
                         "params_gb", "state_gb", "init_s", "init_peak_gb",
                         "peak_mem_gb", "collectives")})
                         for r, rec in zip(ranks, recs)])
            world["runs"][tag] = w
            log(f"[multidevice] {label} {tag}: {kw['batch']} x "
                f"({kw['prompt_len']} + {kw['n_new']}), {tp * pp} ranks on "
                f"one card ({card}), gloo: TTFT {w['ttft_ms']:.2f} ms "
                f"({w['ratio']['ttft_ms']:.2f}x tp=1's "
                f"{one['ttft_ms']:.2f}), TPOT {w['tpot_ms']:.3f} ms "
                f"({w['ratio']['tpot_ms']:.2f}x {one['tpot_ms']:.3f}), TPS "
                f"{w['tps']:.1f} ({w['ratio']['tps']:.2f}x {one['tps']:.1f});"
                f" bf16 tokens equal to tp=1's: {same:.4f}; K6 launches over "
                f"its ranks {w['k6_launches']}")
            for r in w["ranks"]:
                log(f"[multidevice] {label} {tag} rank {r['coords']}: shard "
                    f"{r['params_gb']:.2f} GB + state {r['state_gb']:.3f} GB,"
                    f" drawn in {r['init_s']:.1f} s (peak while drawing "
                    f"{r['init_peak_gb']:.2f} GB), peak serving "
                    f"{r['peak_mem_gb']:.2f} GB; gloo ms per call: "
                    + ", ".join(f"{k[:-3]} {v:.3f}"
                                for k, v in r["collectives"].items()))
        for arch in parity:
            for kv in MDL_KVS:
                want = refs[arch][kv]
                for r in ranks:
                    check(r["parity"][arch][kv] == ranks[0]["parity"][arch][kv],
                          f"{label} parity {arch} {kv}: rank {r['rank']}'s "
                          f"tokens are not rank 0's")
                got = ranks[0]["parity"][arch][kv]
                pairs = [(a, b) for g, w_ in zip(got, want)
                         for a, b in zip(g, w_)]
                share = sum(a == b for a, b in pairs) / len(pairs)
                world["parity"][f"{arch} {kv}"] = share
                what = (f"{label} parity {arch} {kv} KV (f32 weights, "
                        f"{MD_PARITY_LAYERS} layers, full width)")
                if _mdl_exact(arch, kv, tp):
                    check(got == want, f"{what}: tokens differ from tp=1's")
                log(f"[multidevice] {what}: greedy tokens "
                    + ("== tp=1's" if got == want else
                       f"equal to tp=1's: {share:.4f} (a finding, not a "
                       f"gate)"))
        log(f"[multidevice] {label}: world of {tp * pp} ranks in "
            f"{world['wall_s']:.1f} s (its spawn with its mesh shape's "
            f"other worlds {world['spawn_s']:.1f} s)")
        worlds[label] = world
    out["lockstep_worlds"] = worlds
    out["measure_lockstep_tp2"] = _lockstep_measure(device, tp=2,
                                                    layers=MD_LAYERS)
    return k6


def phase_multidevice(device, summary):
    """Tensor- and pipeline-parallel serving with every rank on this one
    card (``share_device``: gloo on CUDA tensors; one card cannot run
    NCCL's two ranks): the worlds of ``MD_WORLDS`` (spawned with the
    lockstep worlds of their mesh shape, :func:`_md_spawns`), each freed
    before the next, their launches summed over ranks; then
    ``api.measure`` at
    tp = 2 against ``api.forecast`` on nvidia-h100.  The f32 4-layer
    parity jobs must give this process's one-rank tokens as
    ``_md_exact`` says; the bf16 full-depth share equal to tp = 1's is a
    finding (the all_reduce sums in another order)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import init_params

    t_phase = time.perf_counter()
    card = card_name_and_power_limit()
    out = dict(card=card, worlds={},
               launches_total={k: 0 for k in ENGINE_KERNELS})
    bodies_total: dict = {}
    # the one-rank references: every parity job at 4 layers in f32, and
    # the bf16 full-depth plain tokens if no earlier phase kept them
    refs = {}
    for arch in dict.fromkeys(w[0] for w in MD_WORLDS):
        cfg4 = dataclasses.replace(configs.get(arch),
                                   n_layers=MD_PARITY_LAYERS)
        params = init_params(cfg4, 0, device=device, dtype=torch.float32)
        refs[arch] = {tag: _md_tokens(cfg4, params, tag, device)
                      for w in MD_WORLDS if w[0] == arch for tag in w[5]}
        del params
        torch.cuda.empty_cache()
    # the plain pass's tp = 1 tokens at each world's depth (the full
    # depth's kept by the engine or moe phase, if it ran)
    for arch, layers in dict.fromkeys((w[0], w[3]) for w in MD_WORLDS):
        if (arch, layers) not in TP1_TOKENS:
            cfg = _depth_cfg(arch, layers)
            params = init_params(cfg, 0, device=device)
            reqs = _md_requests(cfg, "plain", False)
            eng, results = _serve(cfg, params, _md_config("plain", False),
                                  reqs, device)
            TP1_TOKENS[(arch, layers)] = [r.tokens for r in results]
            tp1 = out.setdefault("tp1", {})[f"{arch} x{cfg.n_layers}"] = \
                dict(ttft_p50_ms=float(np.median([r.ttft for r in results])
                                       * 1e3),
                     tpot_p50_ms=float(np.median([r.tpot for r in results])
                                       * 1e3),
                     tps=eng.aggregate_tps())
            log(f"[multidevice] {arch} x{cfg.n_layers} tp=1 plain (one "
                f"rank, the same requests): TTFT p50 "
                f"{tp1['ttft_p50_ms']:.2f} ms, TPOT p50 "
                f"{tp1['tpot_p50_ms']:.3f} ms, TPS {tp1['tps']:.1f}")
            del eng, params
            torch.cuda.empty_cache()

    spawned = _md_spawns(device)
    for i, (arch, tp, pp, layers, passes, parity) in enumerate(MD_WORLDS):
        cfg = _depth_cfg(arch, layers)
        label = f"{arch} tp={tp} x pp={pp}" + (
            f" x{layers} layers" if layers else "")
        ranks = spawned[("md", i)]["ranks"]
        world = dict(wall_s=spawned[("md", i)]["wall_s"],
                     spawn_s=spawned[("md", i)]["spawn_s"], backend=ranks[0][
            "backend"], ranks=[{k: r[k] for k in (
                "coords", "init_s", "params_gb", "init_peak_gb", "peak_gb",
                "collectives")} for r in ranks], passes={})
        check(all(r["backend"] == "gloo" for r in ranks),
              f"{label}: ranks sharing a card must run gloo")
        for tag in passes:
            recs = [r["passes"][tag] for r in ranks]
            first = recs[0]
            for r, rec in zip(ranks, recs):
                where = f"{label} {tag} rank {r['rank']}"
                check(rec["tokens"] == first["tokens"]
                      and rec["cached"] == first["cached"],
                      f"{where}: its tokens are not rank 0's")
                check(rec["pool"][3] == cfg.n_kv_heads // tp
                      and rec["pool"][0] == cfg.n_layers // pp,
                      f"{where}: pool {rec['pool']}")
                if tag == "spec_lora":
                    check(rec["lanes"] == 16 // tp,
                          f"{where}: K4 on {rec['lanes']} lanes")
                _check_engine_bodies(where, rec["launches"], rec["bodies"])
                path = (("paged_prefill", "paged_decode") if tag == "plain"
                        else ("paged_prefill", "paged_verify",
                              "grouped_lora"))
                check(all(rec["launches"][k] > 0 for k in path),
                      f"{where} did not launch {path}: {rec['launches']}")
            check(first["cached"][1] == 256 and first["cached"][3] == 511,
                  f"{label} {tag}: radix hit / fork {first['cached']}")
            launches = {k: sum(r["launches"][k] for r in recs)
                        for k in ENGINE_KERNELS}
            bodies = {w: {b: sum(r["bodies"][w][b] for r in recs)
                          for b in c} for w, c in first["bodies"].items()}
            for k, v in launches.items():
                out["launches_total"][k] += v
            for w, c in bodies.items():
                tot = bodies_total.setdefault(w, {})
                for b, v in c.items():
                    tot[b] = tot.get(b, 0) + v
            same = None
            if tag == "plain":
                want = TP1_TOKENS[(arch, layers)]
                pairs = [(a, b) for g, w_ in zip(first["tokens"], want)
                         for a, b in zip(g, w_)]
                same = sum(a == b for a, b in pairs) / len(pairs)
            world["passes"][tag] = dict(
                {k: first[k] for k in ("ttft_p50_ms", "tpot_p50_ms", "tps",
                                       "pool", "pool_gb", "lanes",
                                       "spec_acceptance")},
                launches=launches, bodies=bodies,
                wall_s=[r["wall_s"] for r in recs],
                same_tokens_as_tp1=same)
            p = world["passes"][tag]
            log(f"[multidevice] {label} {tag}: 8 requests x (512 + 64), 4 "
                f"slots, {tp * pp} ranks on one card ({card}), gloo: TTFT "
                f"p50 {p['ttft_p50_ms']:.2f} ms, TPOT p50 "
                f"{p['tpot_p50_ms']:.3f} ms, TPS {p['tps']:.1f}; pool "
                f"{p['pool']} per rank ({p['pool_gb']:.2f} GB)"
                + (f"; K4 on {p['lanes']} lanes per rank, acceptance "
                   f"{p['spec_acceptance']:.4f}" if p["lanes"] else "")
                + (f"; bf16 tokens equal to tp=1's: {same:.4f}"
                   if same is not None else "")
                + f"; launches over its ranks {launches}, by body {bodies}")
        world["parity"] = {}
        for tag in parity:
            want = refs[arch][tag]
            for r in ranks:
                check(r["parity"][tag] == ranks[0]["parity"][tag],
                      f"{label} parity {tag}: rank {r['rank']}'s tokens "
                      f"are not rank 0's")
            got = ranks[0]["parity"][tag]
            pairs = [(a, b) for g, w_ in zip(got, want)
                     for a, b in zip(g, w_)]
            share = sum(a == b for a, b in pairs) / len(pairs)
            first = [next((i for i, (a, b) in enumerate(zip(g, w_))
                           if a != b), None) for g, w_ in zip(got, want)]
            world["parity"][tag] = dict(share=share, first_diff=first)
            what = (f"{label} parity {tag} (f32 weights, "
                    f"{MD_PARITY_LAYERS} layers, full width)")
            if _md_exact(tag, tp):
                check(got == want, f"{what}: tokens differ from tp=1's at "
                      f"{first}")
            log(f"[multidevice] {what}: greedy tokens "
                + ("== tp=1's" if got == want else
                   f"equal to tp=1's: {share:.4f} (first difference per "
                   f"request {first}; a finding, not a gate)"))
        for r in world["ranks"]:
            log(f"[multidevice] {label} rank {r['coords']}: shard "
                f"{r['params_gb']:.2f} GB, drawn in {r['init_s']:.1f} s "
                f"(peak while drawing {r['init_peak_gb']:.2f} GB), peak "
                f"memory {r['peak_gb']:.2f} GB; gloo on the shared card, "
                f"ms per call: " + ", ".join(
                    f"{k[:-3]} {v:.3f}" for k, v in r["collectives"].items()))
        log(f"[multidevice] {label}: world of {tp * pp} ranks in "
            f"{world['wall_s']:.1f} s (its spawn with its mesh shape's "
            f"other worlds {world['spawn_s']:.1f} s)")
        out["worlds"][label] = world
    out["bodies_total"] = bodies_total
    out["measure_tp2"] = _measure_vs_forecast("llama2-7b", device, tp=2,
                                              layers=MD_LAYERS)
    k6 = _md_lockstep(device, out, card, spawned)
    out["k6_launches"], out["k6_bodies"] = k6["launches"], k6["bodies"]
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[multidevice] launches over every world and rank "
        f"{out['launches_total']}, by body {bodies_total}; K6 "
        f"{out['k6_launches']} {out['k6_bodies']}; phase "
        f"{out['wall_s']:.1f} s")
    summary["multidevice"] = out


# ---------------------------------------------------------------------------
# phase 12: the trainer on a mesh
# ---------------------------------------------------------------------------

TM_STEPS = 3
#: the worlds at full width: (label, data, model, FSDP, layers; None is
#: the full depth), the 2-rank worlds in one spawn and the 4-rank world
#: in another.  Each trains 8 layers, for the 1200 s limit: dp=2 x tp=2
#: took 15.0 s a step at 40 (gloo 14.2 s), 9.5 s at 20; tp=2 took 27.6 s
#: for its world at 40
TM_WORLDS = (("dp=2 FSDP", 2, 1, True, 8), ("tp=2", 1, 2, False, 8),
             ("dp=2 x tp=2 FSDP", 2, 2, True, 8))
#: the f32 parity meshes at ``TM_PARITY_LAYERS`` (2, for the 1200 s
#: limit: the five meshes, the save and the resume at 4 took most of
#: the phase's 274.5 s): (label, data, model, FSDP, microbatches)
TM_PARITY = (("dp=2", 2, 1, False, 1), ("dp=2 FSDP", 2, 1, True, 1),
             ("tp=2", 1, 2, False, 1), ("dp=2 x tp=2 FSDP", 2, 2, True, 1),
             ("dp=2 mb=2", 2, 1, False, 2))
TM_PARITY_LAYERS = 2
#: f32 against the one-rank step: the loss per step relative and the
#: params' relative norm (``_train_parity``'s limits: f32 summed in
#: other orders, AdamW normalising each element's update)
TM_LOSS_TOL, TM_PARAM_TOL = 1e-5, 1e-4


def _tm_trainer(cfg, mesh, policy, ckpt_dir, total, ckpt_every, dtype,
                injector=None, data_seed=2, device=None):
    """A ``Trainer`` on ``mesh`` (None: one rank on ``device``) drawing its
    weights in ``dtype`` (the f32 checks need an f32 draw; the port's
    ``Trainer`` draws bf16), flash attention, the train phase's
    optimizer and batch shape (its data at ``data_seed`` 0)."""
    import torch
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import init_params
    from repro_torch.optim import AdamW
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.runtime.sharding import init_shard

    class _Trainer(Trainer):
        def init_state(self, seed=0):
            params = (init_params(self.cfg, seed, device=self.device,
                                  dtype=dtype) if self.mesh is None else
                      init_shard(self.cfg, seed, self.mesh, self.policy,
                                 device=self.device, dtype=dtype))
            return params, self.opt.init(params)
    device = mesh.device if mesh is not None else device
    data = SyntheticTokens(cfg, DataConfig(TRAIN_BATCH, TRAIN_SEQ, data_seed),
                           device=device)
    opt = AdamW(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    tc = TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                       ckpt_dir=ckpt_dir, log_every=1)
    return _Trainer(cfg, opt, data, tc, use_flash=True, device=device,
                    mesh=mesh, policy=policy, failure_injector=injector)


class _GlooMeter:
    """Counts what this rank's ``all_reduce`` calls move (bytes of the
    tensor) and the host seconds they take, by wrapping
    ``torch.distributed.all_reduce`` (the port calls it through the
    module, so the wrapper sees every call); ``stop`` restores it."""

    def __init__(self):
        import torch.distributed as dist
        self.dist, self.inner = dist, dist.all_reduce
        self.bytes, self.seconds, self.calls = 0, 0.0, 0
        dist.all_reduce = self._wrapped

    def _wrapped(self, t, *a, **kw):
        t0 = time.perf_counter()
        out = self.inner(t, *a, **kw)
        self.seconds += time.perf_counter() - t0
        self.bytes += t.numel() * t.element_size()
        self.calls += 1
        return out

    def take(self) -> dict:
        out = dict(bytes=self.bytes, seconds=self.seconds, calls=self.calls)
        self.bytes, self.seconds, self.calls = 0, 0.0, 0
        return out

    def stop(self) -> None:
        self.dist.all_reduce = self.inner


def _tm_main(mesh, policy, layers):
    """A world's main path on this rank: granite-3-2b at full width
    (``layers`` deep), bf16, 4 x 2048 Zipf tokens, flash attention and
    remat, ``TM_STEPS`` steps through ``Trainer.run``; per step its
    time, loss, peak memory and gloo traffic, and the K6 launches of the
    run (zeroed just before it, read just after)."""
    import tempfile
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    dev = mesh.device
    cfg = _depth_cfg(TRAIN_ARCH, layers)
    marks, meter = [], _GlooMeter()

    def mark(step):
        marks.append((torch.cuda.max_memory_allocated(dev), meter.take()))
        torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = _tm_trainer(cfg, mesh, policy, ckpt, TM_STEPS,
                              TM_STEPS + 1, torch.bfloat16, mark,
                              data_seed=0)
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches()                   # this rank's path starts here
        t0 = time.perf_counter()
        params, state, steps = trainer.run(seed=0)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = _launches()              # ... and ends here
        bodies = {n: dict(c) for n, c in fa_ops.BODY_LAUNCHES.items()}
    marks.append((torch.cuda.max_memory_allocated(dev), meter.take()))
    meter.stop()
    shard_gb = sum(t.numel() * t.element_size() for t in _leaves(params)
                   ) / 1e9
    for e, (peak, gloo), (_, before) in zip(steps, marks[1:], marks[:-1]):
        e["peak_gb"], e["gloo"] = peak / 1e9, gloo
    del params, state, trainer
    torch.cuda.empty_cache()
    return dict(steps=steps, wall_s=wall, shard_gb=shard_gb,
                launches={k: launches[k] for k in ("flash_fwd", "flash_bwd")},
                bodies={k: bodies[k] for k in ("flash_fwd", "flash_bwd")},
                layers=cfg.n_layers)


def _tm_parity(mesh, policy, microbatches, refs):
    """Three f32 steps of ``make_train_step`` at ``TM_PARITY_LAYERS``,
    full width, on
    this rank's shard of the seed-0 draw; rank 0 holds the whole params
    against the one-rank run's (``refs``: a file of its leaves)."""
    import torch
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.optim import AdamW
    from repro_torch.runtime import make_train_step
    from repro_torch.runtime.sharding import init_shard
    dev = mesh.device
    cfg = _depth_cfg(TRAIN_ARCH, TM_PARITY_LAYERS)
    params = init_shard(cfg, 0, mesh, policy, device=dev,
                        dtype=torch.float32)
    opt = AdamW(lr=3e-4, warmup_steps=1, total_steps=3)
    state = opt.init(params)
    step = make_train_step(cfg, opt, mesh, policy, microbatches=microbatches,
                           use_flash=True)
    data = SyntheticTokens(cfg, DataConfig(TRAIN_BATCH, TRAIN_SEQ, 2),
                           device=dev)
    losses = []
    for i in range(3):
        params, state, m = step(params, state, data.batch(i))
        losses.append(float(m["loss"]))
    del state
    return dict(losses=losses, **_tm_whole_diff(params, cfg, mesh, policy,
                                                refs))


def _tm_whole_diff(params, cfg, mesh, policy, refs) -> dict:
    """||whole - ref||^2 and ||ref||^2 over every leaf, on rank 0 (the
    leaves are assembled whole on every rank, one at a time)."""
    import torch
    from repro_torch.models.layers import param_defs
    from repro_torch.runtime.sharding import unshard_leaf
    want = torch.load(refs, mmap=True) if mesh.rank == 0 else None
    num = den = 0.0

    def walk(t, d, path):
        nonlocal num, den
        for k in sorted(d):
            if isinstance(d[k], dict):
                walk(t[k], d[k], path + (k,))
                continue
            w = unshard_leaf(path + (k,), d[k].axes, t[k].detach(),
                             d[k].shape, mesh, policy)
            if want is not None:
                r = want["/".join(path + (k,))].to(w.device).double()
                num += float((w.double() - r).square().sum())
                den += float(r.square().sum())
    walk(params, param_defs(cfg), ())
    return dict(num=num, den=den)


def _tm_rank(mesh, jobs):
    """One rank of a trainmesh world: ``jobs`` in order, each on the mesh
    of its shape (made here from the spawned world's ranks, every rank
    making every group)."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.sharding import ShardingPolicy
    out = dict(rank=mesh.rank, backend=mesh.backend, coords=dict(mesh.coords),
               jobs=[])
    meshes = {(mesh.shape["data"], mesh.shape["model"]): mesh}
    for job in jobs:
        shape = (job["data"], job["model"])
        if shape not in meshes:
            meshes[shape] = make_host_mesh(*shape, device=mesh.device)
        m = meshes[shape]
        policy = ShardingPolicy(fsdp=job["fsdp"])
        t0 = time.perf_counter()
        if job["kind"] == "main":
            rec = _tm_main(m, policy, job["layers"])
        elif job["kind"] == "parity":
            rec = _tm_parity(m, policy, job["microbatches"], job["refs"])
        else:                     # "save" (2 steps) or "resume" (to 4)
            trainer = _tm_trainer(_depth_cfg(TRAIN_ARCH, TM_PARITY_LAYERS), m, policy,
                                  job["ckpt"], 2 if job["kind"] == "save"
                                  else 4, 2, torch.float32)
            params, state, log = trainer.run(seed=0)
            rec = dict(log=log)
            if job["kind"] == "resume":
                rec.update(_tm_whole_diff(params, trainer.cfg, m, policy,
                                          job["refs"]))
            del params, state, trainer
        torch.cuda.empty_cache()
        rec["coords"], rec["wall_s"] = dict(m.coords), time.perf_counter() - t0
        out["jobs"].append(rec)
    return out


def _tm_one_rank(device, tmp):
    """This process's one-rank f32 runs at ``TM_PARITY_LAYERS``, full
    width: three
    steps of ``make_train_step`` at one and two microbatches, and an
    uninterrupted 4-step ``Trainer``; each run's losses, and its params
    saved to a file for the ranks to read."""
    import torch
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import init_params
    from repro_torch.optim import AdamW
    from repro_torch.runtime import make_train_step
    cfg = _depth_cfg(TRAIN_ARCH, TM_PARITY_LAYERS)
    data = SyntheticTokens(cfg, DataConfig(TRAIN_BATCH, TRAIN_SEQ, 2),
                           device=device)
    refs = {}

    def keep(name, params, losses):
        path = str(Path(tmp) / f"{name}.pt")
        torch.save({"/".join(p): t.detach().cpu() for p, t in
                    _flat_paths(params)}, path)
        refs[name] = dict(path=path, losses=losses)
    for mb in (1, 2):
        params = init_params(cfg, 0, device=device, dtype=torch.float32)
        opt = AdamW(lr=3e-4, warmup_steps=1, total_steps=3)
        state = opt.init(params)
        step = make_train_step(cfg, opt, microbatches=mb, use_flash=True)
        losses = []
        for i in range(3):
            params, state, m = step(params, state, data.batch(i))
            losses.append(float(m["loss"]))
        keep(f"mb{mb}", params, losses)
        del params, state
    trainer = _tm_trainer(cfg, None, None, str(Path(tmp) / "straight"), 4,
                          100, torch.float32, device=device)
    params, _, log = trainer.run(seed=0)
    keep("straight", params, [e["loss"] for e in log])
    del params, trainer
    torch.cuda.empty_cache()
    return refs


def _flat_paths(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat_paths(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def phase_trainmesh(device, summary):
    """The trainer on a mesh, every rank on this one card (gloo on CUDA
    tensors, ``share_device``): granite-3-2b at full width through
    ``Trainer.run`` at tp = 2, and at dp = 2 and dp = 2 x tp = 2 with
    FSDP (``TM_WORLDS``' depths); then the f32
    parity meshes at ``TM_PARITY_LAYERS`` against this process's
    one-rank step, and
    the elastic resume: saved at dp = 2 x tp = 2 FSDP, restored and
    continued at tp = 1 and tp = 2, against an uninterrupted run."""
    import shutil
    import tempfile
    from repro_torch.launch.mesh import spawn

    t_phase = time.perf_counter()
    card = card_name_and_power_limit()
    tmp = tempfile.mkdtemp(prefix="trainmesh_")
    out = dict(card=card, worlds={}, parity={}, launches={
        "flash_fwd": 0, "flash_bwd": 0}, bodies={})
    try:
        refs = _tm_one_rank(device, tmp)
        # the 4-rank spawn first: its save feeds the tp = 1 and tp = 2
        # resumes
        four, two = [], []
        for label, data, model, fsdp, layers in TM_WORLDS:
            (four if data * model == 4 else two).append(dict(
                kind="main", label=label, data=data, model=model,
                fsdp=fsdp, layers=layers))
        for label, data, model, fsdp, mb in TM_PARITY:
            (four if data * model == 4 else two).append(dict(
                kind="parity", label=label, data=data, model=model,
                fsdp=fsdp, microbatches=mb,
                refs=refs[f"mb{mb}"]["path"]))
        saved = str(Path(tmp) / "elastic")
        four.append(dict(kind="save", label="save", data=2, model=2,
                         fsdp=True, ckpt=saved))
        two.append(dict(kind="resume", label="resume tp=2", data=1,
                        model=2, fsdp=False, ckpt=str(Path(tmp) / "tp2"),
                        refs=refs["straight"]["path"]))
        t0 = time.perf_counter()
        ranks4 = spawn(_tm_rank, (four,), data=2, model=2, device=device,
                       share_device=True)
        out["spawn4_s"] = time.perf_counter() - t0
        # the elastic copies: tp = 1 here, tp = 2 in the 2-rank world
        shutil.copytree(saved, str(Path(tmp) / "tp2"))
        shutil.copytree(saved, str(Path(tmp) / "tp1"))
        t0 = time.perf_counter()
        ranks2 = spawn(_tm_rank, (two,), data=2, device=device,
                       share_device=True)
        out["spawn2_s"] = time.perf_counter() - t0
        check(all(r["backend"] == "gloo" for r in ranks2 + ranks4),
              "trainmesh: ranks sharing a card must run gloo")
        _tm_report(out, four, ranks4, refs)
        _tm_report(out, two, ranks2, refs)
        _tm_elastic(out, device, tmp, refs, ranks2[0]["jobs"][-1],
                    ranks4[0]["jobs"][-1])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[trainmesh] K6 launches over every world and rank "
        f"{out['launches']}, by body {out['bodies']}; phase "
        f"{out['wall_s']:.1f} s")
    summary["trainmesh"] = out


def _tm_report(out, jobs, ranks, refs):
    """Check and log one spawn's jobs (every rank's records side by
    side)."""
    for i, job in enumerate(jobs):
        recs = [r["jobs"][i] for r in ranks]
        label = job["label"]
        if job["kind"] == "main":
            _tm_world(out, label, job, recs)
        elif job["kind"] == "parity":
            want = refs[f"mb{job['microbatches']}"]["losses"]
            got = recs[0]["losses"]
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            param_rel = (recs[0]["num"] / recs[0]["den"]) ** 0.5
            out["parity"][label] = dict(losses=got, want=want,
                                        loss_rel=loss_rel,
                                        param_rel=param_rel)
            log(f"[trainmesh] parity {label}: {TM_PARITY_LAYERS} layers, "
                f"full width, f32, {TRAIN_BATCH} x {TRAIN_SEQ}, 3 steps "
                f"against one rank: losses {got} / {want}, largest "
                f"relative difference {loss_rel:.3e} (limit "
                f"{TM_LOSS_TOL:.0e}); params relative difference "
                f"{param_rel:.3e} (limit {TM_PARAM_TOL:.0e})")
            check(all(r["losses"] == got for r in recs),
                  f"trainmesh parity {label}: ranks' losses differ")
            check(loss_rel <= TM_LOSS_TOL and param_rel <= TM_PARAM_TOL,
                  f"trainmesh parity {label}: loss {loss_rel:.3e}, params "
                  f"{param_rel:.3e}")


def _tm_world(out, label, job, recs):
    """Log one full-width world's run, add its launches to the phase's,
    then check it: every rank's losses equal, finite, and each rank's K6
    launches two forwards (remat) and one backward per layer and step,
    all on the mma body."""
    import math
    cfg = _depth_cfg(TRAIN_ARCH, job["layers"])
    n = job["data"] * job["model"]
    steps = recs[0]["steps"]
    steady = steps[1:]
    step_s = sum(e["step_s"] for e in steady) / len(steady)
    world = dict(
        ranks=n, layers=cfg.n_layers, loss=[e["loss"] for e in steps],
        grad_norm=[e["grad_norm"] for e in steps],
        step_ms=[e["step_s"] * 1e3 for e in steps],
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
        peak_gb=[max(e["peak_gb"] for e in r["steps"]) for r in recs],
        shard_gb=[r["shard_gb"] for r in recs],
        gloo_gb_per_step=[sum(e["gloo"]["bytes"] for e in r["steps"][1:])
                          / len(steady) / 1e9 for r in recs],
        gloo_s_per_step=[sum(e["gloo"]["seconds"] for e in r["steps"][1:])
                         / len(steady) for r in recs],
        gloo_calls_per_step=steps[1]["gloo"]["calls"],
        launches={k: sum(r["launches"][k] for r in recs)
                  for k in ("flash_fwd", "flash_bwd")},
        wall_s=[r["wall_s"] for r in recs])
    out["worlds"][label] = world
    log(f"[trainmesh] {TRAIN_ARCH} {label}: {n} ranks on one card "
        f"({out['card']}), gloo; {cfg.n_layers} layers, full width, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, flash + remat, {TM_STEPS} "
        f"steps: step " + ", ".join(f"{ms:.1f}" for ms in world["step_ms"])
        + f" ms, {world['tokens_per_s']:.1f} tokens/s (steps 1-"
        f"{TM_STEPS - 1}); loss " + ", ".join(f"{x:.5f}" for x in
                                                world["loss"])
        + "; peak memory per rank " + ", ".join(
            f"{x:.2f}" for x in world["peak_gb"])
        + f" GB (shard {world['shard_gb'][0]:.2f} GB); gloo per step and "
        f"rank {world['gloo_gb_per_step'][0]:.3f} GB in "
        f"{world['gloo_calls_per_step']} all_reduce calls, "
        + ", ".join(f"{x:.2f}" for x in world["gloo_s_per_step"])
        + f" s; K6 launches over its ranks {world['launches']} (not a "
        f"{n}-card measurement)")
    for k in out["launches"]:
        out["launches"][k] += world["launches"][k]
        body = out["bodies"].setdefault(k, {})
        for r in recs:
            for b, c in r["bodies"][k].items():
                body[b] = body.get(b, 0) + c
    want = {"flash_fwd": 2 * cfg.n_layers * TM_STEPS,
            "flash_bwd": cfg.n_layers * TM_STEPS}
    for rec in recs:
        check([e["loss"] for e in rec["steps"]] == world["loss"],
              f"trainmesh {label}: rank {rec['coords']}'s losses are not "
              f"rank 0's")
        check(rec["launches"] == want,
              f"trainmesh {label}: rank {rec['coords']} K6 launches "
              f"{rec['launches']}, expected {want}")
        check(all(rec["bodies"][k] == {"mma": want[k], "fma": 0}
                  for k in want), f"trainmesh {label}: K6 bodies "
              f"{rec['bodies']}; every bf16 call runs on mma")
    check(all(math.isfinite(e["loss"]) and math.isfinite(e["grad_norm"])
              for e in steps),
          f"trainmesh {label}: a loss or grad norm is not finite")


def _tm_elastic(out, device, tmp, refs, resumed2, saved4):
    """The resume at tp = 1 (here) from the 2 x 2 FSDP save, beside the
    2-rank world's at tp = 2: both against the uninterrupted run."""
    import torch
    trainer = _tm_trainer(_depth_cfg(TRAIN_ARCH, TM_PARITY_LAYERS), None, None,
                          str(Path(tmp) / "tp1"), 4, 2, torch.float32,
                          device=device)
    params, _, log1 = trainer.run(seed=0)
    want = torch.load(refs["straight"]["path"], mmap=True)
    num = den = 0.0
    for p, t in _flat_paths(params):
        r = want["/".join(p)].to(t.device).double()
        num += float((t.detach().double() - r).square().sum())
        den += float(r.square().sum())
    del params, trainer, want
    torch.cuda.empty_cache()
    straight = refs["straight"]["losses"][2:]
    out["elastic"] = dict(saved_at=[e["step"] for e in saved4["log"]],
                          straight_losses=straight)
    for name, log_, n, d in (("tp=1", log1, num, den),
                             ("tp=2", resumed2["log"], resumed2["num"],
                              resumed2["den"])):
        check([e["step"] for e in log_] == [2, 3],
              f"trainmesh elastic {name}: resumed at {log_[0]['step']}")
        losses = [e["loss"] for e in log_]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, straight))
        r = out["elastic"][name] = dict(losses=losses, loss_rel=loss_rel,
                                        param_rel=(n / d) ** 0.5)
        log(f"[trainmesh] elastic: saved after step 1 at dp=2 x tp=2 FSDP "
            f"({TM_PARITY_LAYERS} layers, f32), restored by "
            f"restore_sharded and continued at {name}: losses of steps 2-3 "
            f"{losses} / uninterrupted one rank {straight} (relative "
            f"{loss_rel:.3e}, limit {TM_LOSS_TOL:.0e}); params after step 3: "
            f"relative difference {r['param_rel']:.3e} (limit "
            f"{TM_PARAM_TOL:.0e})")
        check(loss_rel <= TM_LOSS_TOL and r["param_rel"] <= TM_PARAM_TOL,
              f"trainmesh elastic {name}: loss {loss_rel:.3e}, params "
              f"{r['param_rel']:.3e} from the uninterrupted run")


# ---------------------------------------------------------------------------
# phase 13: the audit and the dry-run
# ---------------------------------------------------------------------------

AUDIT_ARCH = "qwen2-7b"
#: the audit's paged kernels: their launches the counts saw are held
#: against the wrappers' own counts
AUDIT_KERNELS = ("paged_decode", "paged_prefill", "paged_verify")
DRYRUN_CELL = ("granite-3-2b", "decode_32k")


def _audit_ratios(report) -> dict:
    """Per target: the matmul ratio and the wire's relative error, from
    the pricing findings' details."""
    out: dict = {}
    for f in report.findings:
        d = f.details
        t = d.get("target")
        if t is None or f.pass_name != "pricing":
            continue
        rec = out.setdefault(t, {})
        if f.code.startswith("pricing.matmul"):
            rec["matmul"] = d["ratio"]
        elif "rel_err" in d:
            rec["wire_rel_err"] = d["rel_err"]
    return out


def phase_audit(device, summary):
    """``repro_torch.analysis.run_audit`` at full width on the card:
    qwen2-7b (the reference's default arch), ``AuditGeometry()``, the six
    single-card targets, the LoRA target and ``decode/gather/tp2pp1`` on
    two ranks sharing the card; the paged targets' K1-K3 launches the
    counts saw held against the wrappers'; the rebuild pass on both
    impls; then one dry-run cell on the meta device."""
    import tempfile
    from repro_torch import analysis, configs
    from repro_torch.analysis import PricingTarget, hygiene
    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    card = card_name_and_power_limit()
    targets = (list(analysis.pricing.DEFAULT_TARGETS)
               + [PricingTarget("decode", "gather", lora_rank=64),
                  PricingTarget("decode", "gather", tp=2, pp=1)])
    _reset_launches()                   # the audit's steps start here
    report = analysis.run_audit(analysis.AuditConfig(
        arch=AUDIT_ARCH, reduced=False, device="cuda", share_device=True,
        targets=targets, run_engine=False))
    launched = _launches()              # ... and end here
    counted = {k: sum(c["kernel_launches"].get(k, 0)
                      for c in report.meta["counted"].values())
               for k in AUDIT_KERNELS}
    check(report.meta["targets"] == [t.name for t in targets],
          f"audit: executed {report.meta['targets']}")
    check(all(counted[k] > 0 and launched[k] == counted[k]
              for k in AUDIT_KERNELS),
          f"audit: the counts saw {counted} launches, the wrappers "
          f"{launched}")
    t_retrace = time.perf_counter()
    cfg = configs.get(AUDIT_ARCH)
    retrace_launches = {}
    for impl in ("gather", "paged"):
        _reset_launches()
        report.extend(hygiene.audit_retrace(cfg, impl, device=device))
        for k, n in _launches().items():
            retrace_launches[k] = retrace_launches.get(k, 0) + n
    retrace_s = time.perf_counter() - t_retrace
    ratios = _audit_ratios(report)
    for t in report.meta["targets"]:
        c, r = report.meta["counted"][t], ratios.get(t, {})
        log(f"[audit] {AUDIT_ARCH} full width, {t}: matmul ratio "
            f"{r.get('matmul', float('nan')):.4f} (counted dot "
            f"{c['dot_flops']:.6g} FLOPs), bytes ratio "
            f"{c['bytes'] / c['analytical_mem']:.4f} ({c['bytes']:.6g} B)"
            + (f", wire rel err {r['wire_rel_err']:.4f} "
               f"({c['wire_bytes']:.6g} B)" if "wire_rel_err" in r else "")
            + f", kernels {c['kernel_launches']}, step {c['run_s']:.3f} s "
            f"({card})")
    for f in report.findings:
        if f.pass_name != "pricing" or f.severity > analysis.Severity.INFO:
            log(f"[audit] [{f.severity}] {f.code}: {f.message}")
    with tempfile.TemporaryDirectory() as tmp:
        rec = dryrun.run_cell(*DRYRUN_CELL, out_dir=tmp, verbose=False)
    check(rec["status"] == "OK", f"audit: dry-run cell {DRYRUN_CELL} "
          f"{rec.get('error')}")
    log(f"[audit] dry-run {DRYRUN_CELL[0]} x {DRYRUN_CELL[1]} on pod16x16 "
        f"(meta device, rank 0): dominant {rec['roofline']['dominant']}, "
        f"useful_flops_ratio {rec['useful_flops_ratio']:.4f}, per chip "
        f"{rec['per_chip']['flops']:.6g} FLOPs, {rec['per_chip']['bytes']:.6g}"
        f" B, wire {rec['per_chip']['collective_wire_bytes']:.6g} B; LIFE "
        f"on nvidia-h100: {rec['life_forecast']['dominant']}")
    codes = [(f.code, str(f.severity)) for f in report.findings]
    out = dict(card=card, arch=AUDIT_ARCH, targets=report.meta["targets"],
               counted=report.meta["counted"], ratios=ratios,
               codes=codes, counts=report.counts(),
               exit_code=report.exit_code(), kernel_launches=launched,
               launches_total={k: launched.get(k, 0)
                               + retrace_launches.get(k, 0)
                               for k in AUDIT_KERNELS},
               retrace_s=retrace_s,
               dryrun={k: rec[k] for k in (
                   "arch", "shape", "mesh", "roofline", "useful_flops_ratio",
                   "model_flops_per_chip", "per_chip", "memory_analysis",
                   "life_forecast", "count_s")},
               wall_s=time.perf_counter() - t_phase)
    summary["audit"] = out
    log(f"[audit] findings {out['counts']}, exit code {out['exit_code']}; "
        f"K1-K3 launches: counted {counted}, wrappers {launched}; rebuild "
        f"runs {retrace_s:.1f} s; phase {out['wall_s']:.1f} s")
    check(out["exit_code"] == 0,
          f"audit: error findings {[c for c in codes if c[1] == 'error']}")


# ---------------------------------------------------------------------------
# phase 14: the examples, run as a user runs them
# ---------------------------------------------------------------------------

#: the serve example's scenarios, in its order (the reference example's)
SERVE_LABELS = ("baseline bf16-KV", "chunked admission(16)",
                "int8 KV blocks", "sampled T=0.8", "shared system prompt")
SERVE_LINE = re.compile(
    r"^(?P<label>.+?)\s+-> (?P<toks>\d+) toks over (?P<reqs>\d+) reqs on "
    r"\d+ slots  cuda\s+(?P<tps>[\d.]+) tok/s \((?P<hw>\S+)-twin ratio"
    r"\s+(?P<ratio>[\d.]+)x\)")
#: runs an example as ``__main__`` in a fresh process, then prints the
#: paged kernels' launches in that process (zero when it starts) as its
#: last line
_EXAMPLE_RUNNER = (
    "import json, runpy, sys\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "from repro_torch.kernels.paged_attention import ops\n"
    "print(json.dumps({'launches': dict(ops.LAUNCHES), 'bodies': {\n"
    "    w: dict(c) for w, c in ops.BODY_LAUNCHES.items()}}))\n")


def _run_example(args, timeout: int):
    """One example script as a subprocess from the repo root (the repo's
    ``src`` on ``PYTHONPATH``); returns (stdout lines, seconds).  A
    non-zero exit fails the phase with the end of its stderr."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", _EXAMPLE_RUNNER, *args],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=timeout)
    seconds = time.perf_counter() - t0
    check(out.returncode == 0, f"examples: {args[0]} exited "
          f"{out.returncode}: {out.stderr[-2000:]}")
    return out.stdout.strip().splitlines(), seconds


#: the train example's steps: 50 of its default 300, for the 1200 s
#: limit (300 took 51.0 s on the card, 100 took 25.6 s on a slower host)
EXAMPLE_TRAIN_STEPS = 50


def phase_examples(device, summary):
    """``examples/serve_batched_torch.py`` (qwen2-7b at full width on the
    card, paged attention: K2 and K1 in bf16 and int8 KV) and
    ``examples/train_100m_torch.py`` at ``EXAMPLE_TRAIN_STEPS`` steps of
    its default 8 x 256 (a fresh checkpoint directory), each in its own
    process: the
    serve example's five lines (tokens, measured tok/s, the twin's ratio
    on nvidia-h100, the shared prompt's measured prefix hit rate equal
    to the forecast's) and its K1/K2 launches; the train run's parameter
    count, wall time per step and falling loss."""
    import tempfile
    import torch
    torch.cuda.empty_cache()                 # the examples' processes
    card = card_name_and_power_limit()       # take the card's memory
    lines, serve_s = _run_example(["examples/serve_batched_torch.py"], 600)
    counted = json.loads(lines[-1])
    rows = {}
    for line in lines[:-1]:
        m = SERVE_LINE.match(line)
        if m:
            rows[m["label"]] = dict(line=line, tokens=int(m["toks"]),
                                    requests=int(m["reqs"]),
                                    tps=float(m["tps"]), twin_hw=m["hw"],
                                    twin_tps_ratio=float(m["ratio"]))
    check(tuple(rows) == SERVE_LABELS, f"examples: serve printed "
          f"{list(rows)}, not {list(SERVE_LABELS)}: {lines[:-1]}")
    hits = re.search(r"prefix hits: measured ([\d.]+)% = forecast "
                     r"([\d.]+)%", rows[SERVE_LABELS[-1]]["line"])
    check(hits is not None and float(hits[1]) > 0 and hits[1] == hits[2],
          f"examples: the shared prompt's line {rows[SERVE_LABELS[-1]]}")
    check(all(r["tokens"] == 120 and r["requests"] == 6
              and r["twin_hw"] == "nvidia-h100" for r in rows.values()),
          f"examples: serve lines {rows}")
    launches = {k: n for k, n in counted["launches"].items() if n}
    check(launches.get("paged_decode", 0) > 0
          and launches.get("paged_prefill", 0) > 0,
          f"examples: serve launched {counted}")
    for label, r in rows.items():
        log(f"[examples] serve_batched_torch {label}: {r['tokens']} tokens, "
            f"measured {r['tps']} tok/s, twin on {r['twin_hw']} "
            f"{r['twin_tps_ratio']}x the measured tok/s ({card})")
    log(f"[examples] serve_batched_torch (qwen2-7b full width): "
        f"{serve_s:.1f} s, prefix hits measured {hits[1]}% = forecast "
        f"{hits[2]}%, launches {launches}, bodies {counted['bodies']}")
    with tempfile.TemporaryDirectory() as tmp:
        lines, train_s = _run_example(
            ["examples/train_100m_torch.py", "--steps",
             str(EXAMPLE_TRAIN_STEPS), "--ckpt-dir", str(Path(tmp) / "ck")],
            600)
    text = "\n".join(lines[:-1])
    check(lines[0].startswith("[LIFE→nvidia-h100]") and "OK: loss improved"
          in text, f"examples: train printed {lines}")
    run = json.loads(text[text.index("{"):text.rindex("}") + 1])
    curve = run["loss_curve"]
    check(curve[-1][1] < curve[0][1], f"examples: train loss {curve}")
    step_ms = run["wall_s"] / run["steps"] * 1e3
    log(f"[examples] train_100m_torch: {run['params']} params, "
        f"{run['steps']} steps in {run['wall_s']} s ({step_ms:.1f} ms a "
        f"step, init and checkpoints included), loss {curve[0][1]} -> "
        f"{curve[-1][1]}; process {train_s:.1f} s ({card})")
    summary["examples"] = dict(
        card=card, serve=rows, serve_s=serve_s,
        prefix_hits=[float(hits[1]), float(hits[2])],
        serve_launches=launches, serve_bodies=counted["bodies"],
        train=dict(params=run["params"], steps=run["steps"],
                   wall_s=run["wall_s"], step_ms=step_ms,
                   loss_first=curve[0][1], loss_last=curve[-1][1]),
        train_s=train_s)


def run_phase(name: str, fn, *args):
    """Run one phase and log its wall time (``[time] <phase> <s> s``):
    a failure prints ``[fail] <phase>: <type>:
    <message>`` on stdout and is raised on (the exit stays non-zero;
    nothing is swallowed)."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    except BaseException as e:
        print(f"[fail] {name}: {type(e).__name__}: {e}", flush=True)
        raise
    finally:
        log(f"[time] {name} {time.perf_counter() - t0:.1f} s")


def phase_build():
    """One nvcc per kernel source, all started together."""
    from repro_torch.kernels import build as kbuild
    libs = [(mod.SOURCE, mod.LIBRARY_NAME) for mod in _kernel_ops()]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        builds = list(pool.map(
            lambda lib: kbuild.build(*lib, force=True), libs))
    log(f"[build] {len(libs)} libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for res in builds:
        log(f"[build] nvcc {res.path.name} in {res.seconds:.1f} s")
        for line in res.log.splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build] {line.strip()}")


def main() -> int:
    # before anything else: the package this script drives
    package = ROOT / "src" / "repro_torch"
    if not package.is_dir():
        print(f"chip_smoke: {package} is missing: run this script from a "
              f"checkout of the repository", flush=True)
        return 1
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list of {PHASES + EXTRA_PHASES}")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA device only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    run_phase("setup", _kernel_ops)

    torch.backends.cuda.matmul.allow_tf32 = False     # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    t_all = time.perf_counter()
    kernels, summary, trained, quant_measure, families = {}, {}, {}, {}, {}
    steps = {
        "build": (phase_build,),
        "kernels": (phase_kernels, device, kernels),
        "engine": (phase_engine, device, summary),
        "train": (phase_train, device, trained),
        "parity": (phase_parity, device),
        "quant": (phase_quant, device, quant_measure),
        "measure": (phase_measure, device, quant_measure),
        "moe": (phase_moe, device, families),
        "vlm": (phase_vlm, device, families),
        "lockstep": (lambda: phase_lockstep(device, families, summary.get(
            "engine_bf16", {}).get("tpot_p50_ms")),),
        "multidevice": (phase_multidevice, device, families),
        "trainmesh": (phase_trainmesh, device, families),
        "audit": (phase_audit, device, families),
        "examples": (phase_examples, device, families),
        "profile": (phase_profile, device),
    }
    for name in PHASES + EXTRA_PHASES:
        if name in phases:
            run_phase(name, *steps[name])
    log(f"[done] phases {phases} in {time.perf_counter() - t_all:.1f} s")

    # launch counts come from the main path's passes only (each zeroed
    # before it and read after it): K1-K4 from the engine, moe and
    # multidevice phases (the last summed over every rank of every
    # world), K6 from the train phase and the lockstep phase's prefills,
    # K5 from the quant phase; without a phase there is no count of it
    engine = summary.get("launches_total", {})
    moe = families.get("moe", {}).get("launches_total", {})
    md = families.get("multidevice", {}).get("launches_total", {})
    launches = {**{k: engine.get(k, 0) + moe.get(k, 0) + md.get(k, 0)
                   for k in {*engine, *moe, *md}},
                **quant_measure.get("quant", {}).get("launches", {})}
    for rec in (trained.get("train"), trained.get("train_wide"),
                families.get("trainmesh")):
        for k, n in (rec or {}).get("launches", {}).items():
            launches[k] = launches.get(k, 0) + n
    for k, n in families.get("audit", {}).get("launches_total", {}).items():
        launches[k] = launches.get(k, 0) + n
    for k, n in families.get("examples", {}).get("serve_launches",
                                                 {}).items():
        launches[k] = launches.get(k, 0) + n
    lockstep = families.get("lockstep")
    md_k6 = families.get("multidevice", {})
    for rec in (lockstep, md_k6):
        if rec and "k6_launches" in rec:
            launches["flash_fwd"] = (launches.get("flash_fwd", 0)
                                     + rec["k6_launches"])
    engine_bodies = summary.get("bodies_total", {})
    for phase in ("moe", "multidevice"):
        for w, c in families.get(phase, {}).get("bodies_total", {}).items():
            engine_bodies = {**engine_bodies, w: {
                b: engine_bodies.get(w, {}).get(b, 0) + n
                for b, n in c.items()}}
    bodies = {**engine_bodies,
              "quant_matmul": quant_measure.get("quant", {}).get("bodies")}
    for rec in (trained.get("train"), trained.get("train_wide"),
                families.get("trainmesh")):
        for k, c in (rec or {}).get("bodies", {}).items():
            bodies[k] = {b: (bodies.get(k) or {}).get(b, 0) + n
                         for b, n in c.items()}
    for rec in (lockstep, md_k6):
        if rec and "k6_bodies" in rec:
            fwd = bodies.get("flash_fwd") or {}
            bodies["flash_fwd"] = {b: fwd.get(b, 0) + n
                                   for b, n in rec["k6_bodies"].items()}
    if lockstep:
        if "flash_fwd" in kernels:
            kernels["flash_fwd"].setdefault("more_shapes", []).extend(
                lockstep["k6_shapes"].values())
    record = []
    for name, source, replaces in KERNELS:
        if name not in kernels:
            continue
        r = kernels[name]
        record.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches.get(name),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{key: r[key] for key in (
                "device_ms", "cold_ms", "cold_device_ms", "library_device_ms",
                "library_cold_ms", "library_cold_device_ms", "body")
               if key in r},
            **{key: v for key, v in r.items() if key.endswith("_why")},
            **({"body_launches": bodies[name]} if bodies.get(name)
               else {}),
            **({"more_shapes": r["more_shapes"]} if "more_shapes" in r
               else {}),
        })
    smi = card_name_and_power_limit()
    print(json.dumps({"quant": quant_measure.get("quant"),
                      "measure": quant_measure.get("measure")}))
    print(json.dumps({"moe": families.get("moe"),
                      "vlm": families.get("vlm"),
                      "lockstep": families.get("lockstep")}))
    print(json.dumps({"multidevice": families.get("multidevice")}))
    print(json.dumps({"train": trained.get("train"),
                      "train_wide": trained.get("train_wide"),
                      "trainmesh": families.get("trainmesh")}))
    print(json.dumps({"audit": families.get("audit"),
                      "examples": families.get("examples")}))
    print(json.dumps({"engine": summary}))
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
