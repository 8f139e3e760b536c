#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --phases build,kernels

Phases, in order (any failed check exits non-zero; no phase's failure is
caught and ignored):

1. build    — nvcc builds the three kernel libraries for sm_90a, together:
              src/repro_torch/kernels/paged_attention/csrc (K1 decode, K2
              prefill, K3 verify), kernels/grouped_lora/csrc (K4) and
              kernels/flash_attention/csrc (K6 forward and backward).
2. kernels  — every kernel against its plain PyTorch version on the card,
              at the llama2-7b (Hk=32, G=1) and qwen2-7b (Hk=4, G=7) head
              shapes, d=128, bs=16, bf16 and int8 KV: decode cursors at 0,
              mid-block and on block seams; prefill chunks at start>0 with
              valid<C over tables that share prefix blocks; verify with
              Q in {1, 5, 256} at cursors on and off seams and a padded
              last chunk near the table's end; grouped LoRA with mixed
              ranks and holes (idx = -1) at T in {1, 5, 256}; flash
              attention forward and backward on the reference's eight
              kernel cases (MHA, GQA, MQA, ragged s, a decode step with
              q_offset, a window, non-causal, head_dim 256) in bf16 and
              f32 and at the training shape.  Then each kernel's time,
              its plain version's, its bound and a library yardstick at
              the main path's shapes.
3. engine   — the main path: llama2-7b at full width and depth (random
              bf16 weights from a seed), paged attention, 8 requests of
              512 prompt + 64 new tokens through 4 slots, with a radix
              prefix hit and a copy-on-write fork; then the same requests
              with speculative decoding (spec_k=4, n-gram drafter) and
              four LoRA tenants of ranks 8/16 plus one base-model request,
              and again with bucketed admission (prefill_batch=4) and the
              same tenants.  Each pass zeroes the launch counts before it
              and reads them after it; between them the passes launch
              K1-K4.  Then a short int8-KV pass.
4. train    — the trainer: granite-3-2b at full width and depth (40
              layers, random bf16 weights from seed 0), flash attention,
              per-layer remat, AdamW, 4 x 2048 synthetic tokens, 4 steps;
              per step its loss, grad norm, time, tokens/s, train_mfu,
              peak memory and K6 launches.  Then at 4 layers, full width,
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
              granite-3-2b at 4 layers, full width, f32 weights: three
              training steps (two microbatches each) through the flash
              kernels equal three through eager attention.

``--phases profile`` (run only when named) profiles engine steps and one
training step of the train phase's configuration.

The last lines are the train and engine JSON summaries, the kernels' JSON
record, the card's name and power limit, and ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "engine", "train", "parity")
EXTRA_PHASES = ("profile",)     # run only when named

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


def log(msg: str) -> None:
    print(msg, flush=True)


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


def _compare(out, ref, cache_v, what, worst):
    """Hold a kernel's output to its plain version elementwise, within
    ``kernel_tolerance`` (stated in its docstring); returns max|err| and
    keeps the largest err/limit ratio seen in ``worst``."""
    from repro_torch.kernels.paged_attention.ref import kernel_tolerance
    diff = (out.float() - ref.float()).abs()
    ratio = float((diff / kernel_tolerance(ref, cache_v)).max())
    err = float(diff.max())
    worst[0] = max(worst[0], ratio)
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


def lora_bound(x, A, B, idx):
    """x in, the delta out, and the (padded) factors of each distinct
    adapter the batch uses read once; holes read no factor."""
    S, T, k = x.shape
    _, _, R = A.shape
    n = B.shape[2]
    live = [i for i in idx.tolist() if i >= 0]
    nbytes = (x.numel() * x.element_size() + S * T * n * x.element_size()
              + len(set(live)) * (k * R + R * n) * A.element_size() + S * 4)
    flops = 2 * T * (k * R + R * n) * len(live)
    return (max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3,
            "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S
            else "operations")


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
    err = _compare(ops.paged_verify(q, ck, cv, bt, pos),
                   ops.paged_verify_ref(q, ck, cv, bt, pos), cv, what, worst)
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
        plain_ms=time_ms(lambda: ops.paged_verify_ref(q, ck, cv, bt, pos)),
        bound_ms=bound, bound_by=by, library_ms=time_ms(lib),
        max_abs_err=err,
        shape=f"S={S} Q={Q} Hk={Hk} G={G} d={d} bs={bs} nb={nb} "
              f"pos={pos.tolist()} kv=bf16")


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


def check_grouped_lora(device, gen, worst, results):
    """K4 against its plain version (the elementwise limit of
    ``kernel_tolerance``: one bf16 ulp plus f32 summation slack for bf16
    deltas, 1e-4 of max|delta| for f32 ones), then timed at the
    speculative pass's shape: 4 slots x 5 rows, the q projection of
    llama2-7b (4096 -> 4096), ranks 8/16 padded to 16, one base-model
    slot."""
    import torch
    from repro_torch.kernels.grouped_lora import ops

    R = 16
    for k, n in ((4096, 4096), (3584, 512)):    # llama2 q/o, qwen2 k/v
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

    k = n = 4096
    A, B = _lora_pool(4, k, n, (8, 16), R, gen, device)
    idx = torch.tensor([0, 1, 2, -1], dtype=torch.int32, device=device)
    x = torch.randn((4, 5, k), generator=gen, device=device).to(
        torch.bfloat16)
    ref = ops.grouped_lora_ref(x, A, B, idx)
    err = _compare(ops.grouped_lora(x, A, B, idx), ref, ref,
                   "grouped_lora main-path shape", worst)
    # library yardstick: two batched products on factors gathered once
    # (holes pointed at zeroed factors) outside the timing
    a = A[idx.long().clamp(min=0)] * (idx >= 0)[:, None, None]
    b = B[idx.long().clamp(min=0)]
    lib = lambda: torch.bmm(torch.bmm(x, a), b)
    bound, by = lora_bound(x, A, B, idx)
    results["grouped_lora"] = dict(
        ms=time_ms(lambda: ops.grouped_lora(x, A, B, idx)),
        plain_ms=time_ms(lambda: ops.grouped_lora_ref(x, A, B, idx)),
        bound_ms=bound, bound_by=by, library_ms=time_ms(lib),
        max_abs_err=err,
        shape=f"S=4 T=5 k={k} n={n} R={R} ranks=(8,16) idx={idx.tolist()} "
              f"bf16")


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
    ||kernel - plain|| / ||plain||: at most 1e-5 in f32 (the same f32
    arithmetic summed in another order) and 2e-2 in bf16 (the kernel's
    D = rowsum(dO*O) reads the bf16-rounded output where autograd uses
    the f32 one, and every gradient rounds once to bf16).  Then both
    timed at the train phase's shape, beside the plain version and SDPA
    (``is_causal``, ``enable_gqa``; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops

    limit = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

    def one(case, dtype, what):
        b, s, L, H, Hk, d, causal, window, q_offset = case
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        mk = lambda *shape: torch.randn(shape, generator=gen,
                                        device=device).to(dtype)
        q, k, v, do = mk(b, s, H, d), mk(b, L, Hk, d), mk(b, L, Hk, d), \
            mk(b, s, H, d)
        o, lse = ops.flash_fwd(q, k, v, **kw)
        grads = ops.flash_bwd(q, k, v, o, lse, do, **kw)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        ref = ops.attention_ref(*leaves, **kw)
        ref_grads = torch.autograd.grad(ref, leaves, do)
        err = _compare(o, ref.detach(), v, f"flash_fwd {what}", worst)
        rel = [float((a.float() - r.float()).norm() / r.float().norm())
               for a, r in zip(grads, ref_grads)]
        grad_err = max(float((a.float() - r.float()).abs().max())
                       for a, r in zip(grads, ref_grads))
        log(f"[kernels] flash_bwd {what} dq/dk/dv rel err "
            f"{rel[0]:.3e}/{rel[1]:.3e}/{rel[2]:.3e} (limit "
            f"{limit[dtype]:.0e}) max_abs_err={grad_err:.3e}")
        check(max(rel) <= limit[dtype], f"flash_bwd {what}: relative "
              f"error {max(rel):.3e} above {limit[dtype]:.0e}")
        return (q, k, v, do, o, lse), err, grad_err

    for case in FA_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            one(case, dtype, f"{case} {str(dtype)[6:]}")
    (q, k, v, do, o, lse), err, grad_err = one(FA_MAIN, torch.bfloat16,
                                               "main-path shape")
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
    bound, by = flash_bound(FA_MAIN, 2, backward=False)
    results["flash_fwd"] = dict(
        ms=time_ms(lambda: ops.flash_fwd(q, k, v)),
        plain_ms=time_ms(lambda: ops.attention_ref(q, k, v)),
        bound_ms=bound, bound_by=by,
        library_ms=time_ms(lambda: sdpa(ql, kl, vl)),
        max_abs_err=err, shape=shape)
    bound, by = flash_bound(FA_MAIN, 2, backward=True)
    results["flash_bwd"] = dict(
        ms=time_ms(lambda: ops.flash_bwd(q, k, v, o, lse, do)),
        plain_ms=time_ms(plain_bwd), bound_ms=bound, bound_by=by,
        library_ms=time_ms(lib_bwd), max_abs_err=grad_err,
        shape=shape + " (backward alone; plain and library: autograd "
        "backward of a kept graph)")
    log(f"[kernels] SDPA forward+backward at {shape}: "
        f"{time_ms(lib_fwd_bwd):.4f} ms")
    del ref, lib_out
    torch.cuda.empty_cache()


def phase_kernels(device, results):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops

    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    bs, d, nb, N = 16, 128, 37, 512
    shapes = {"llama2-7b": (32, 1), "qwen2-7b": (4, 7)}
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
                out = ops.paged_decode(q, ck, cv, bt, pos)
                ref = ops.paged_decode_ref(q, ck, cv, bt, pos)
                _compare(out, ref, cv, f"paged_decode {tag}", worst)
                # prefill: an admission chunk, a chunk at start>0 with
                # valid<C that starts mid-block, a short tail chunk
                C = 256
                table = bt[1].contiguous()       # shares blocks with row 0
                for start, valid in ((0, 256), (200, 77), (520, 3)):
                    qp = torch.randn((C, Hk, G, d), generator=gen,
                                     device=device).to(q_dtype)
                    out = ops.paged_prefill(qp, ck, cv, table, start, valid)
                    ref = ops.paged_prefill_ref(qp, ck, cv, table, start,
                                                valid)
                    _compare(out[:valid], ref[:valid], cv,
                             f"paged_prefill {tag} start={start} "
                             f"valid={valid}", worst)

    # timing at the main path's shapes: llama2-7b, 4 slots, bf16 q and KV,
    # cursors around the middle of the 64-token decode after a 512 prompt
    Hk, G = shapes["llama2-7b"]
    ck, cv = _pool(N, bs, Hk, d, torch.bfloat16, gen, device)
    pos = torch.tensor([540, 544, 548, 552], dtype=torch.int32, device=device)
    S = pos.numel()
    bt = _tables(S, nb, N, 16, gen, device)
    q = torch.randn((S, Hk, G, d), generator=gen, device=device).to(
        torch.bfloat16)
    err = _compare(ops.paged_decode(q, ck, cv, bt, pos),
                   ops.paged_decode_ref(q, ck, cv, bt, pos), cv,
                   "paged_decode main-path shape", worst)
    L = int(pos.max()) + 1
    # library yardstick: SDPA over K/V already gathered into contiguous
    # (S, Hk, L, d) buffers; the gather is done once, outside the timing
    kg = ck[bt.long()].reshape(S, nb * bs, Hk, d)[:, :L].transpose(1, 2)
    vg = cv[bt.long()].reshape(S, nb * bs, Hk, d)[:, :L].transpose(1, 2)
    kg, vg = kg.contiguous(), vg.contiguous()
    qs = q.reshape(S, Hk * G, 1, d)
    mask = (torch.arange(L, device=device)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask)
    bound, by = decode_bound(q, ck, bt, pos, bs)
    results["paged_decode"] = dict(
        ms=time_ms(lambda: ops.paged_decode(q, ck, cv, bt, pos)),
        plain_ms=time_ms(lambda: ops.paged_decode_ref(q, ck, cv, bt, pos)),
        bound_ms=bound, bound_by=by, library_ms=time_ms(lib),
        max_abs_err=err,
        shape=f"S={S} Hk={Hk} G={G} d={d} bs={bs} nb={nb} "
              f"pos={pos.tolist()} kv=bf16")

    # prefill: the second 256-token chunk of a 512-token prompt
    C, start, valid = 256, 256, 256
    table = bt[0].contiguous()
    qp = torch.randn((C, Hk, G, d), generator=gen, device=device).to(
        torch.bfloat16)
    err = _compare(ops.paged_prefill(qp, ck, cv, table, start, valid),
                   ops.paged_prefill_ref(qp, ck, cv, table, start, valid),
                   cv, "paged_prefill main-path shape", worst)
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
    results["paged_prefill"] = dict(
        ms=time_ms(lambda: ops.paged_prefill(qp, ck, cv, table, start,
                                             valid)),
        plain_ms=time_ms(lambda: ops.paged_prefill_ref(qp, ck, cv, table,
                                                       start, valid)),
        bound_ms=bound, bound_by=by, library_ms=time_ms(lib),
        max_abs_err=err,
        shape=f"C={C} start={start} valid={valid} Hk={Hk} G={G} d={d} "
              f"bs={bs} nb={nb} kv=bf16")
    check_verify(device, gen, shapes, worst, results)
    check_grouped_lora(device, gen, worst, results)
    check_flash(device, gen, worst, results)
    log(f"[kernels] largest err/limit over every comparison: "
        f"{worst[0]:.3e}")
    for name, res in results.items():
        for r in (res, *res.get("more_shapes", ())):
            log(f"[kernels] {name} @ {r['shape']}: kernel_ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} "
                f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                f"library_ms={r['library_ms']:.4f}")


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
)
#: the kernels the engine passes launch (the train phase launches K6)
ENGINE_KERNELS = ("paged_decode", "paged_prefill", "paged_verify",
                  "grouped_lora")


def _kernel_ops():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.grouped_lora import ops as lora_ops
    from repro_torch.kernels.paged_attention import ops
    return ops, lora_ops, fa_ops


def _reset_launches() -> None:
    for mod in _kernel_ops():
        mod.reset_launch_counts()


def _launches() -> dict:
    return {k: n for mod in _kernel_ops() for k, n in mod.LAUNCHES.items()}


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
    _check_results(cfg, reqs, results, "engine bf16")
    check(launches["paged_decode"] > 0 and launches["paged_prefill"] > 0,
          f"main path did not launch both kernels: {launches}")
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
        launches=launches, prefill_chunks=n_chunks, decode_steps=n_steps,
        kv_pool_gb=kv_gb, wall_s=wall,
        peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9)
    log(f"[engine] llama2-7b paged bf16: 8 requests x ({prompt_len} prompt + "
        f"{max_new} new), 4 slots, KV pool {kv_gb:.2f} GB; "
        f"TTFT p50 {summary['engine_bf16']['ttft_p50_ms']:.2f} ms, "
        f"TPOT p50 {summary['engine_bf16']['tpot_p50_ms']:.3f} ms, "
        f"TPS {summary['engine_bf16']['tps']:.1f}, prefix hit rate "
        f"{eng.prefix_hit_rate:.4f}; launches {launches} over {n_chunks} "
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
        _check_results(cfg, reqs_l, results, tag)
        check(all(launches[k] > 0 for k in path),
              f"{tag} did not launch {path}: {launches}")
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
            launches=launches, wall_s=wall)
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
            + f"; launches {launches}; wall {wall:.1f} s (warm-up included)")
        del eng
        torch.cuda.empty_cache()
    total = {k: sum(summary[t]["launches"][k] for t in
                    ("engine_bf16", "engine_spec_lora",
                     "engine_bucketed_lora")) for k in ENGINE_KERNELS}
    check(all(v > 0 for v in total.values()),
          f"the engine passes did not launch every kernel: {total}")
    summary["launches_total"] = total

    # a short second pass with int8 KV
    reqs8 = _requests(cfg.vocab_size, 4, prompt_len, 16, 256, seed=2)
    ec8 = dataclasses.replace(ec, kv_dtype="int8", max_len=prompt_len + 32)
    eng, results = _serve(cfg, params, ec8, reqs8, device)
    _check_results(cfg, reqs8, results, "engine int8")
    check(eng.state["cache_k"].dtype == torch.int8, "int8 pool dtype")
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


def train_flops(cfg, batch, seq) -> float:
    """Model FLOPs of one training step: 6*N per token, plus attention's
    forward and backward (3 x 4*b*H*hd per live causal pair and layer).
    Remat's recompute is not counted: it is not the model's work."""
    pairs = attention_pairs(seq, seq, True, cfg.local_window or None, 0)
    return (6 * cfg.param_count() * batch * seq
            + 12 * batch * cfg.n_heads * cfg.head_dim * pairs * cfg.n_layers)


def _trainer(cfg, ckpt_dir, total, ckpt_every, device, seed=0, **kw):
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.optim import AdamW
    from repro_torch.runtime import Trainer, TrainerConfig
    data = SyntheticTokens(cfg, DataConfig(TRAIN_BATCH, TRAIN_SEQ, seed),
                           device=device)
    opt = AdamW(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    tc = TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                       ckpt_dir=ckpt_dir, log_every=1)
    return Trainer(cfg, opt, data, tc, use_flash=True, device=device, **kw)


def phase_train(device, summary):
    """granite-3-2b at full width and depth through ``Trainer.run`` with
    flash attention; then the resume check at 4 layers, full width."""
    import math
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.optim.adamw import tree_leaves

    cfg = configs.get(TRAIN_ARCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    marks = []

    def mark(step):
        """The trainer's per-step hook, called before each step: the peak
        memory and launch counts up to here, then a fresh peak."""
        marks.append((torch.cuda.max_memory_allocated(device), _launches()))
        torch.cuda.reset_peak_memory_stats(device)

    with tempfile.TemporaryDirectory() as ckpt:
        # no checkpoint in this run: one is 25 GB of disk (params, mu, nu);
        # the resume check below writes them at 4 layers
        trainer = _trainer(cfg, ckpt, TRAIN_STEPS, TRAIN_STEPS + 1, device,
                           failure_injector=mark)
        torch.cuda.reset_peak_memory_stats(device)
        _reset_launches()                     # the main path starts here
        t0 = time.perf_counter()
        params, opt_state, steps = trainer.run(seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()                # ... and ends here
    marks.append((torch.cuda.max_memory_allocated(device), launches))
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[train] {TRAIN_ARCH} params {n_params / 1e9:.4f} B, {cfg.n_layers} "
        f"layers, d={cfg.d_model}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens per "
        f"step, flash attention, remat, AdamW; {flops / 1e12:.2f} TFLOP "
        f"per step (model); init + {TRAIN_STEPS} steps in {wall:.1f} s")
    check(len(steps) == TRAIN_STEPS, f"train: {len(steps)} steps logged")
    for e, (peak, after), (_, before) in zip(steps, marks[1:], marks[:-1]):
        e["tokens_per_s"] = tokens / e["step_s"]
        e["train_mfu"] = flops / (e["step_s"] * BF16_FLOPS_PER_S)
        e["peak_mem_gb"] = peak / 1e9
        e["launches"] = {k: after[k] - before[k]
                         for k in ("flash_fwd", "flash_bwd")}
        log(f"[train] step {e['step']}: loss {e['loss']:.5f} grad_norm "
            f"{e['grad_norm']:.5f} step {e['step_s'] * 1e3:.1f} ms, "
            f"{e['tokens_per_s']:.1f} tokens/s, train_mfu "
            f"{e['train_mfu']:.4f}, peak memory {e['peak_mem_gb']:.2f} GB, "
            f"K6 launches {e['launches']}")
    check(all(math.isfinite(e["loss"]) and math.isfinite(e["grad_norm"])
              for e in steps), "train: a loss or grad norm is not finite")
    check(steps[-1]["loss"] < steps[0]["loss"],
          f"train: loss did not fall ({steps[0]['loss']} -> "
          f"{steps[-1]['loss']})")
    want = {"flash_fwd": 2 * cfg.n_layers * TRAIN_STEPS,
            "flash_bwd": cfg.n_layers * TRAIN_STEPS}
    got = {k: launches[k] for k in want}
    check(got == want, f"train: K6 launches {got}, expected {want} (the "
          f"forward twice per layer and step under remat)")
    steady = steps[1:]
    summary["train"] = dict(
        arch=TRAIN_ARCH, params=n_params, steps=TRAIN_STEPS,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, step_flops=flops,
        loss=[e["loss"] for e in steps],
        grad_norm=[e["grad_norm"] for e in steps],
        step_ms=[e["step_s"] * 1e3 for e in steps],
        tokens_per_s=sum(e["tokens_per_s"] for e in steady) / len(steady),
        train_mfu=sum(e["train_mfu"] for e in steady) / len(steady),
        peak_mem_gb=max(e["peak_mem_gb"] for e in steps),
        launches=got, wall_s=wall)
    log(f"[train] steps 1-{TRAIN_STEPS - 1}: {summary['train']['tokens_per_s']:.1f} "
        f"tokens/s, train_mfu {summary['train']['train_mfu']:.4f}; peak "
        f"memory {summary['train']['peak_mem_gb']:.2f} GB; launches {got}")
    del trainer, params, opt_state
    torch.cuda.empty_cache()

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
    firsts = [t[0] for t in _parity_tokens(cfg, params, reqs, "fp32",
                                           "paged", device)]
    log(f"[parity] kv=fp32: engine first tokens {firsts}, dense forward "
        f"argmax {first}")
    check(firsts == first, "engine first tokens differ from dense forward")

    # the reference's invariants of the three features (its tests
    # test_spec_decode.py and test_lora_serving.py).  The runs compared
    # batch their rows differently (a verify pass, a batched chunk, one
    # request alone), so they keep f32 KV: bf16 rounding of K/V could
    # part two runs at a near-tie of the logits
    def tokens(reqs_, impl="paged", drafter=None, **extra):
        return _parity_tokens(cfg, params, reqs_, "fp32", impl, device,
                              drafter, **extra)

    greedy = tokens(reqs)
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
    _train_parity(device)


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
    three LoRA tenants and a base-model request (K4's four launches per
    layer per step on top), and again with bucketed admission
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
    _profile_train(device)


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


def _profile_train(device):
    """One profiled training step of the train phase's configuration
    (granite-3-2b, full depth, 4 x 2048, flash attention, remat), after an
    unprofiled one: device busy and idle share, K6, cuBLAS, elementwise
    and the optimizer (the kernels inside ``make_train_step``'s
    ``optimizer`` range, a part of the elementwise time)."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs

    cfg = configs.get(TRAIN_ARCH)
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = _trainer(cfg, ckpt, TRAIN_STEPS, TRAIN_STEPS + 1, device)
        params, state = trainer.init_state(0)
        params, state, _ = trainer.step_fn(params, state,
                                           trainer.data.batch(0))
        batch = trainer.data.batch(1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, state, m = trainer.step_fn(params, state, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kinds, optimizer = _device_kinds(prof)
    busy = sum(kinds.values()) / 1e6
    parts = ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in
                      sorted(kinds.items(), key=lambda kv: -kv[1]))
    log(f"[profile] train step ({TRAIN_ARCH}, {cfg.n_layers} layers, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, flash, remat): wall {wall * 1e3:.2f} "
        f"ms, device busy {busy * 1e3:.2f} ms (idle share "
        f"{max(0.0, 1 - busy / wall):.3f}); {parts}; optimizer range "
        f"{optimizer / 1e3:.2f} ms of device time")
    del trainer, params, state
    torch.cuda.empty_cache()


def main() -> int:
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
    from repro_torch.kernels import build as kbuild
    paged_ops, lora_ops, fa_ops = _kernel_ops()

    torch.backends.cuda.matmul.allow_tf32 = False     # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    t_all = time.perf_counter()
    kernels, summary, trained = {}, {}, {}
    if "build" in phases:
        # one nvcc per source, all started together
        libs = [(mod.SOURCE, mod.LIBRARY_NAME)
                for mod in (paged_ops, lora_ops, fa_ops)]
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
    if "kernels" in phases:
        phase_kernels(device, kernels)
    if "engine" in phases:
        phase_engine(device, summary)
    if "train" in phases:
        phase_train(device, trained)
    if "parity" in phases:
        phase_parity(device)
    if "profile" in phases:
        phase_profile(device)
    log(f"[done] phases {phases} in {time.perf_counter() - t_all:.1f} s")

    # launch counts come from the main path's passes only (each zeroed
    # before it and read after it): K1-K4 from the engine phase, K6 from
    # the train phase; without a phase there is no count of it to report
    launches = {**summary.get("launches_total", {}),
                **trained.get("train", {}).get("launches", {})}
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
            **({"more_shapes": r["more_shapes"]} if "more_shapes" in r
               else {}),
        })
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"train": trained.get("train")}))
    print(json.dumps({"engine": summary}))
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
