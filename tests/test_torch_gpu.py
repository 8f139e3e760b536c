"""Tests that need the card: the CUDA kernels against their plain
versions, the engine's two attention impls against each other (with
speculative decoding and LoRA tenants too), and a training step through
the flash attention kernels against the eager one.

They import neither JAX nor the JAX package, so they run on a GPU
machine as they are:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Elsewhere they skip (a CUDA kernel has no CPU mode); ``chip_smoke.py``
runs the same checks at the main path's shapes.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.engine import Engine, EngineConfig, Request
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.grouped_lora import ops as lora_ops
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import kernel_tolerance
from repro_torch.models import init_params

pytestmark = pytest.mark.gpu


def _assert_within_tolerance(out, ref, cache_v):
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= kernel_tolerance(ref, cache_v)).all()), \
        float(diff.max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(chip_smoke.py runs these checks on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("Hk,G", [(32, 1), (4, 7)])
def test_kernels_match_plain_versions(cuda_device, kv, Hk, G):
    """Tolerance: ``kernel_tolerance``, elementwise — one bf16 ulp of
    each output plus 1e-3 of the mean magnitude (both sides accumulate in
    f32 from the same inputs and round the output once)."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    N, bs, d, nb = 64, 16, 128, 8
    if kv == torch.int8:
        ck = torch.randint(-40, 41, (N, bs, Hk, d), generator=gen,
                           device=cuda_device, dtype=torch.int8)
    else:
        ck = torch.randn((N, bs, Hk, d), generator=gen,
                         device=cuda_device).to(kv)
    cv = ck.flip(0).contiguous()
    bt = torch.randperm(N, generator=gen, device=cuda_device)[:3 * nb]
    bt = bt.reshape(3, nb).to(torch.int32).contiguous()
    pos = torch.tensor([0, 17, nb * bs - 1], dtype=torch.int32,
                       device=cuda_device)
    q = torch.randn((3, Hk, G, d), generator=gen,
                    device=cuda_device).bfloat16()
    before = dict(ops.LAUNCHES)
    out = ops.paged_decode(q, ck, cv, bt, pos)
    ref = ops.paged_decode_ref(q, ck, cv, bt, pos)
    _assert_within_tolerance(out, ref, cv)
    qp = torch.randn((32, Hk, G, d), generator=gen,
                     device=cuda_device).bfloat16()
    table = bt[1].contiguous()
    out = ops.paged_prefill(qp, ck, cv, table, 40, 21)
    ref = ops.paged_prefill_ref(qp, ck, cv, table, 40, 21)
    _assert_within_tolerance(out[:21], ref[:21], cv)
    assert ops.LAUNCHES["paged_decode"] == before["paged_decode"] + 1
    assert ops.LAUNCHES["paged_prefill"] == before["paged_prefill"] + 1


def _decode_case(device, kv, Hk, G, q_dtype, d=128, nb=37, bs=16, seed=6):
    """Five slots at cursors 0, 15, 16, 300 and the table's last position;
    slots 1.. share slot 0's first two blocks (a radix prefix hit)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    S, shared = 5, 2
    N = S * nb
    if kv == torch.int8:
        ck, cv = (torch.randint(-40, 41, (N, bs, Hk, d), generator=gen,
                                device=device, dtype=torch.int8)
                  for _ in range(2))
    else:
        ck, cv = (torch.randn((N, bs, Hk, d), generator=gen,
                              device=device).to(kv) for _ in range(2))
    perm = torch.randperm(N, generator=gen, device=device).to(torch.int32)
    rows = [perm[:nb]] + [torch.cat([perm[:shared], perm[nb + i * (nb - shared):
                                                        nb + (i + 1) * (nb - shared)]])
                          for i in range(S - 1)]
    bt = torch.stack(rows).contiguous()
    pos = torch.tensor([0, 15, 16, 300, nb * bs - 1], dtype=torch.int32,
                       device=device)
    q = torch.randn((S, Hk, G, d), generator=gen, device=device).to(q_dtype)
    return q, ck, cv, bt, pos


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("Hk,G", [(32, 1), (4, 7)])
def test_decode_split_body_matches_plain_version(cuda_device, Hk, G, kv,
                                                 q_dtype):
    """K1's split body at llama2-7b's and qwen2-7b's heads, every (q, KV)
    dtype pair it takes, cursors that leave splits empty and end mid-block,
    within ``kernel_tolerance``; a repeat gives the same bits, and each call
    counts one launch on ``split``."""
    q, ck, cv, bt, pos = _decode_case(cuda_device, kv, Hk, G, q_dtype)
    before = ops.BODY_LAUNCHES["paged_decode"]["split"]
    out = ops.paged_decode(q, ck, cv, bt, pos)
    again = ops.paged_decode(q, ck, cv, bt, pos)
    torch.cuda.synchronize()
    assert ops.BODY_LAUNCHES["paged_decode"] == {"split": before + 2}
    assert out.dtype == q_dtype and out.shape == q.shape
    _assert_within_tolerance(out, ops.paged_decode_ref(q, ck, cv, bt, pos),
                             cv)
    assert torch.equal(out, again)


@pytest.mark.parametrize("Hk,G,d", [(2, 16, 128), (1, 10, 256), (8, 4, 64),
                                    (2, 3, 32), (2, 2, 8)])
def test_decode_split_body_other_heads(cuda_device, Hk, G, d):
    """Row groups (G > 8), a head dim of 256 (a key row over the whole
    warp), 64, 32 and 8, and G = 3 (one row of four unused); on a 9-block
    table the cursor 300 lies past its 144 keys, and the whole table is
    attended, as in the plain version."""
    q, ck, cv, bt, pos = _decode_case(cuda_device, torch.bfloat16, Hk, G,
                                      torch.bfloat16, d=d, nb=9)
    out = ops.paged_decode(q, ck, cv, bt, pos)
    _assert_within_tolerance(out, ops.paged_decode_ref(q, ck, cv, bt, pos),
                             cv)


def test_decode_rejects_a_head_dim_it_does_not_take(cuda_device):
    q = torch.zeros((2, 2, 1, 12), device=cuda_device, dtype=torch.bfloat16)
    ck = torch.zeros((4, 4, 2, 12), device=cuda_device, dtype=torch.bfloat16)
    bt = torch.zeros((2, 2), dtype=torch.int32, device=cuda_device)
    pos = torch.zeros((2,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        ops.paged_decode(q, ck, ck, bt, pos)
    with pytest.raises(ValueError, match="head dim"):
        ops.paged_decode(q[..., :8].contiguous(), ck[..., :8].contiguous(),
                         ck[..., :8].contiguous(), bt[:, :0].contiguous(),
                         pos)


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("Hk,G", [(32, 1), (4, 7)])
@pytest.mark.parametrize("Q", [1, 5, 19])
def test_verify_kernel_matches_plain_version(cuda_device, kv, Hk, G, Q):
    """Cursors at 0, on a seam and near the table's end (the padding rows
    of the last slot run past it)."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(1)
    N, bs, d, nb = 64, 16, 128, 6
    if kv == torch.int8:
        ck = torch.randint(-40, 41, (N, bs, Hk, d), generator=gen,
                           device=cuda_device, dtype=torch.int8)
    else:
        ck = torch.randn((N, bs, Hk, d), generator=gen,
                         device=cuda_device).to(kv)
    cv = ck.flip(0).contiguous()
    bt = torch.randperm(N, generator=gen, device=cuda_device)[:3 * nb]
    bt = bt.reshape(3, nb).to(torch.int32).contiguous()
    pos = torch.tensor([0, 32, nb * bs - 3], dtype=torch.int32,
                       device=cuda_device)
    q = torch.randn((3, Q, Hk, G, d), generator=gen,
                    device=cuda_device).bfloat16()
    before = ops.LAUNCHES["paged_verify"]
    out = ops.paged_verify(q, ck, cv, bt, pos)
    ref = ops.paged_verify_ref(q, ck, cv, bt, pos)
    torch.cuda.synchronize()
    _assert_within_tolerance(out, ref, cv)
    assert ops.LAUNCHES["paged_verify"] == before + 1


def _verify_case(device, kv, Hk, G, Q, d, pos, nb=6, seed=4):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    N, bs = 128, 16
    if kv == torch.int8:
        ck = torch.randint(-40, 41, (N, bs, Hk, d), generator=gen,
                           device=device, dtype=torch.int8)
    else:
        ck = torch.randn((N, bs, Hk, d), generator=gen, device=device).to(kv)
    cv = ck.flip(0).contiguous()
    S = len(pos)
    bt = torch.randperm(N, generator=gen, device=device)[:S * nb]
    bt = bt.reshape(S, nb).to(torch.int32).contiguous()
    pos = torch.tensor(pos, dtype=torch.int32, device=device)
    q = torch.randn((S, Q, Hk, G, d), generator=gen, device=device)
    return q, ck, cv, bt, pos


@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("Hk,G", [(4, 1), (2, 7)])
@pytest.mark.parametrize("Q", [1, 5, 256])
def test_verify_mma_body_matches_plain_version(cuda_device, Q, Hk, G, kv,
                                               d):
    """The tensor-core body (bf16 q): one 16-row tile with the keys split
    four ways when Q*G <= 16, 64-row blocks otherwise; cursors at 0, on a
    seam, mid-table and where a chunk's padding rows run past the table.
    Tolerance ``kernel_tolerance``, as every comparison of the kernels."""
    nb = 20
    q, ck, cv, bt, pos = _verify_case(cuda_device, kv, Hk, G, Q, d,
                                      [0, 16, 37, nb * 16 - 3], nb=nb)
    q = q.bfloat16()
    assert ops.verify_body(q.dtype, kv, d, Q * G)[0] == "mma"
    before = dict(ops.BODY_LAUNCHES["paged_verify"])
    out = ops.paged_verify(q, ck, cv, bt, pos)
    torch.cuda.synchronize()
    assert ops.BODY_LAUNCHES["paged_verify"] == dict(before,
                                                     mma=before["mma"] + 1)
    _assert_within_tolerance(out, ops.paged_verify_ref(q, ck, cv, bt, pos),
                             cv)


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8])
def test_verify_f32_q_keeps_the_rows_body(cuda_device, kv):
    """f32 q stays exact in f32: it takes attend_rows, not the bf16
    tensor-core body."""
    q, ck, cv, bt, pos = _verify_case(cuda_device, kv, 4, 7, 5, 128,
                                      [3, 40])
    assert ops.verify_body(q.dtype, kv, 128, 35) == ("rows", 1)
    before = dict(ops.BODY_LAUNCHES["paged_verify"])
    out = ops.paged_verify(q, ck, cv, bt, pos)
    torch.cuda.synchronize()
    assert ops.BODY_LAUNCHES["paged_verify"] == dict(before,
                                                     rows=before["rows"] + 1)
    _assert_within_tolerance(out, ops.paged_verify_ref(q, ck, cv, bt, pos),
                             cv)


def _prefill_case(device, kv, Hk, G, C, q_dtype, nb=37, seed=5):
    q, ck, cv, bt, _ = _verify_case(device, kv, Hk, G, C, 128, [0], nb=nb,
                                    seed=seed)
    return q[0].to(q_dtype).contiguous(), ck, cv, bt[0].contiguous()


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("Hk,G", [(32, 1), (4, 7)])
@pytest.mark.parametrize("start,valid", [(0, 256), (200, 77), (520, 3)])
def test_prefill_mma_body_matches_plain_version(cuda_device, start, valid,
                                                Hk, G, kv):
    """K2 on the tensor-core body (bf16 q): 256-row chunks at llama2-7b's
    and qwen2-7b's heads; an admission chunk, one that starts mid-block
    with valid < C, and a tail chunk, both with the key limit below every
    padding row's causal one.  Every row is held to the plain version,
    the padding rows too (finite, as the reference's)."""
    q, ck, cv, table = _prefill_case(cuda_device, kv, Hk, G, 256,
                                     torch.bfloat16)
    assert ops.prefill_body(q.dtype, kv, 128, 256 * G) == ("mma", 1)
    before = dict(ops.BODY_LAUNCHES["paged_prefill"])
    out = ops.paged_prefill(q, ck, cv, table, start, valid)
    torch.cuda.synchronize()
    assert ops.BODY_LAUNCHES["paged_prefill"] == dict(before,
                                                      mma=before["mma"] + 1)
    assert bool(torch.isfinite(out.float()).all())
    _assert_within_tolerance(
        out, ops.paged_prefill_ref(q, ck, cv, table, start, valid), cv)


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8])
def test_prefill_short_chunk_splits_the_keys(cuda_device, kv):
    """A chunk of C * G <= 16 rows runs the key-split variant (KS = 4)
    of the mma body, with the key limit."""
    q, ck, cv, table = _prefill_case(cuda_device, kv, 4, 1, 8,
                                     torch.bfloat16, nb=8)
    assert ops.prefill_body(q.dtype, kv, 128, 8) == ("mma", 4)
    for start, valid in ((0, 8), (37, 5), (120, 3)):
        out = ops.paged_prefill(q, ck, cv, table, start, valid)
        torch.cuda.synchronize()
        _assert_within_tolerance(
            out, ops.paged_prefill_ref(q, ck, cv, table, start, valid), cv)


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8])
def test_prefill_f32_q_keeps_the_rows_body(cuda_device, kv):
    """f32 q stays exact in f32: K2 takes attend_rows for it."""
    q, ck, cv, table = _prefill_case(cuda_device, kv, 4, 7, 64,
                                     torch.float32)
    assert ops.prefill_body(q.dtype, kv, 128, 448) == ("rows", 1)
    before = dict(ops.BODY_LAUNCHES["paged_prefill"])
    out = ops.paged_prefill(q, ck, cv, table, 200, 41)
    torch.cuda.synchronize()
    assert ops.BODY_LAUNCHES["paged_prefill"] == dict(before,
                                                      rows=before["rows"] + 1)
    _assert_within_tolerance(
        out, ops.paged_prefill_ref(q, ck, cv, table, 200, 41), cv)


def _lora_pool(device, k, n, gen, ranks=(4, 8, 16, 8), R=16):
    P = len(ranks)
    A = torch.zeros((P, k, R), device=device)
    B = torch.zeros((P, R, n), device=device)
    for p, r in enumerate(ranks):
        A[p, :, :r] = torch.randn((k, r), generator=gen,
                                  device=device) * r ** -0.5
        B[p, :r] = torch.randn((r, n), generator=gen, device=device) * 0.05
    return A.bfloat16().contiguous(), B.bfloat16().contiguous()


@pytest.mark.parametrize("T", [1, 5, 40, 256])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_grouped_lora_kernel_matches_plain_version(cuda_device, T, x_dtype):
    """Mixed ranks (4/8/16 padded to 16), a shared tenant and holes."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(2)
    S, k, n = 5, 320, 300
    A, B = _lora_pool(cuda_device, k, n, gen)
    x = torch.randn((S, T, k), generator=gen,
                    device=cuda_device).to(x_dtype)
    idx = torch.tensor([2, -1, 0, 2, 3], dtype=torch.int32,
                       device=cuda_device)
    before = lora_ops.LAUNCHES["grouped_lora"]
    out = lora_ops.grouped_lora(x, A, B, idx)
    ref = lora_ops.grouped_lora_ref(x, A, B, idx)
    torch.cuda.synchronize()
    _assert_within_tolerance(out, ref, ref)
    assert not out[1].any()
    assert lora_ops.LAUNCHES["grouped_lora"] == before + 1


@pytest.mark.parametrize("T", [1, 5, 256])
@pytest.mark.parametrize("k,n", [(4096, 4096), (3584, 512)])
def test_grouped_lora_kernel_at_main_path_widths(cuda_device, k, n, T):
    """llama2-7b's q/o and qwen2-7b's k/v widths at the main path's T:
    decode, speculative verify, a prefill chunk (k split 32 ways at 4 x 1
    and 4 x 5 rows, 5 ways at 4 x 256)."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    A, B = _lora_pool(cuda_device, k, n, gen, ranks=(8, 16, 8, 16))
    x = torch.randn((4, T, k), generator=gen,
                    device=cuda_device).bfloat16()
    idx = torch.tensor([0, -1, 3, 1], dtype=torch.int32, device=cuda_device)
    out = lora_ops.grouped_lora(x, A, B, idx)
    ref = lora_ops.grouped_lora_ref(x, A, B, idx)
    torch.cuda.synchronize()
    _assert_within_tolerance(out, ref, ref)
    assert not out[1].any()


@pytest.mark.parametrize("T", [1, 5, 256])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_grouped_lora_qkv_matches_three_plain_calls(cuda_device, T, x_dtype):
    """One launch for q, k and v (q wider than k and v, as under GQA)
    against three plain calls, holes exact zeros."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(4)
    k = 896
    pairs = [_lora_pool(cuda_device, k, n, gen) for n in (896, 128, 128)]
    x = torch.randn((4, T, k), generator=gen, device=cuda_device).to(x_dtype)
    idx = torch.tensor([1, 3, -1, 1], dtype=torch.int32, device=cuda_device)
    before = dict(lora_ops.LAUNCHES)
    got = lora_ops.grouped_lora_qkv(x, *pairs, idx, scale=0.5)
    torch.cuda.synchronize()
    assert lora_ops.LAUNCHES == dict(
        before, grouped_lora_qkv=before["grouped_lora_qkv"] + 1)
    for out, (A, B) in zip(got, pairs):
        ref = lora_ops.grouped_lora_ref(x, A, B, idx, scale=0.5)
        _assert_within_tolerance(out, ref, ref)
        assert not out[2].any()


@pytest.mark.parametrize("T", [5, 256])
def test_grouped_lora_is_deterministic(cuda_device, T):
    """Fixed sum orders: the same input gives the same bits."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(6)
    A, B = _lora_pool(cuda_device, 4096, 4096, gen, ranks=(8, 16))
    x = torch.randn((4, T, 4096), generator=gen,
                    device=cuda_device).bfloat16()
    idx = torch.tensor([0, 1, -1, 0], dtype=torch.int32, device=cuda_device)
    first = lora_ops.grouped_lora(x, A, B, idx)
    for _ in range(3):
        assert torch.equal(lora_ops.grouped_lora(x, A, B, idx), first)


def test_grouped_lora_kernel_faults_on_a_slot_past_the_pool(cuda_device):
    """idx = P traps in the kernel, which the next synchronisation
    raises as a device-side assert, as for torch's own indexing (the
    plain version raises IndexError).  A child process runs it: the
    trap ends that process's CUDA context."""
    code = textwrap.dedent("""
        import torch
        from repro_torch.kernels.grouped_lora import ops
        x = torch.ones((2, 1, 64), device="cuda")
        A = torch.ones((3, 64, 8), device="cuda")
        B = torch.ones((3, 8, 32), device="cuda")
        idx = torch.tensor([0, 3], dtype=torch.int32, device="cuda")
        ops.grouped_lora(x, A, B, idx)
        torch.cuda.synchronize()
        """)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert "device-side assert" in proc.stderr, proc.stderr[-2000:]


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((2, 2, 1, 16), device=cuda_device, dtype=torch.float16)
    ck = torch.zeros((4, 4, 2, 16), device=cuda_device)
    bt = torch.zeros((2, 2), dtype=torch.int32, device=cuda_device)
    pos = torch.zeros((2,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="queries"):
        ops.paged_decode(q, ck, ck, bt, pos)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_decode(q.float(), ck, ck, bt.long(), pos)
    with pytest.raises(ValueError, match="does not fit"):
        ops.paged_prefill(q.float(), ck, ck, bt[0], 6, 3)


def test_gather_equals_paged_engine(cuda_device):
    """f32 weights keep both read paths within argmax resolution."""
    cfg = configs.reduced(configs.get("qwen2-7b"))
    params = init_params(cfg, 0, device=cuda_device, dtype=torch.float32)
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, (4, 19))
    prompts[1, :10] = prompts[0, :10]
    prompts[3] = prompts[2]
    toks = {}
    for impl in ("gather", "paged"):
        for kv in ("bf16", "int8"):
            eng = Engine(cfg, params, EngineConfig(
                max_slots=2, max_len=40, chunk_size=8, decode_block=3,
                block_size=8, kv_dtype=kv, attn_impl=impl),
                device=cuda_device)
            toks[impl, kv] = [r.tokens for r in eng.run(
                [Request(rid=i, prompt=p.tolist(), max_new=6)
                 for i, p in enumerate(prompts)])]
    assert toks["gather", "bf16"] == toks["paged", "bf16"]
    assert toks["gather", "int8"] == toks["paged", "int8"]


def test_gather_equals_paged_engine_with_spec_and_lora(cuda_device):
    """Speculative verify (K3) and grouped LoRA (K4) on the paged path
    give the gather path's greedy tokens with f32 weights, through a
    bucketed admission too."""
    cfg = configs.reduced(configs.get("qwen2-7b"))
    params = init_params(cfg, 0, device=cuda_device, dtype=torch.float32)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab_size, (4, 19))
    toks = {}
    for impl in ("gather", "paged"):
        eng = Engine(cfg, params, EngineConfig(
            max_slots=2, max_len=40, chunk_size=8, decode_block=3,
            block_size=8, attn_impl=impl, spec_k=3, prefill_batch=2,
            lora_tenants=3, lora_ranks=(4, 8), lora_slots=2),
            device=cuda_device)
        toks[impl] = [r.tokens for r in eng.run(
            [Request(rid=i, prompt=p.tolist(), max_new=6,
                     adapter_id=[0, 1, 2, None][i])
             for i, p in enumerate(prompts)])]
    assert toks["gather"] == toks["paged"]


def _serve_on_rank(mesh, cfg, jobs, prompts):
    """One rank of :func:`test_tp2_on_one_card_equals_tp1`: its shard of
    the seed-0 f32 weights, the jobs' tokens."""
    from repro_torch.runtime.sharding import init_shard
    params = init_shard(cfg, 0, mesh, device=mesh.device,
                        dtype=torch.float32)
    return [_serve_tokens(cfg, params, kw, prompts, mesh)
            for kw in jobs]


def _serve_tokens(cfg, params, kw, prompts, mesh=None):
    eng = Engine(cfg, params, EngineConfig(**kw), device="cuda", mesh=mesh)
    tenants = [0, 1, 2, None]
    return [r.tokens for r in eng.run(
        [Request(rid=i, prompt=p, max_new=16,
                 adapter_id=tenants[i] if kw.get("lora_tenants") else None)
         for i, p in enumerate(prompts)])]


def test_tp2_on_one_card_equals_tp1(cuda_device):
    """llama2-7b at full width with 4 layers, f32 weights and KV: two
    ranks on the one card (gloo on CUDA tensors, the explicit opt-in),
    each running K1, K2 and K4 on its 16 heads and 8 of 16 rank lanes,
    give the one-rank engine's greedy tokens, plain and with LoRA tenants
    and speculation (K3)."""
    import dataclasses
    from repro_torch.launch.mesh import spawn
    cfg = dataclasses.replace(configs.get("llama2-7b"), n_layers=4)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (4, 64)).tolist()
    # f32 KV: a bf16 or int8 cache would round K/V that the
    # all-reduce's other summation order moved by ~1e-6 to other values
    # now and then, and part the runs at a near-tie of the logits
    base = dict(max_slots=2, max_len=96, chunk_size=32, decode_block=4,
                block_size=16, attn_impl="paged", kv_dtype="fp32")
    jobs = [base, dict(base, spec_k=4, lora_tenants=4, lora_ranks=(8, 16))]
    params = init_params(cfg, 0, device=cuda_device, dtype=torch.float32)
    want = [_serve_tokens(cfg, params, kw, prompts) for kw in jobs]
    del params
    torch.cuda.empty_cache()
    ranks = spawn(_serve_on_rank, (cfg, jobs, prompts), model=2,
                  device="cuda", share_device=True)
    assert ranks[0] == want and ranks[1] == want


def _lockstep_on_rank(mesh, cfg, prompts):
    """One rank of :func:`test_lockstep_tp2_on_one_card_equals_tp1`."""
    from repro_torch.runtime.sharding import init_shard
    params = init_shard(cfg, 0, mesh, device=mesh.device,
                        dtype=torch.float32)
    return _lockstep_tokens(cfg, params, prompts, mesh)


def _lockstep_tokens(cfg, params, prompts, mesh=None):
    from repro_torch.runtime import ServeConfig, Server
    sc = ServeConfig(batch=1, max_len=2048 + 16, kv_dtype="fp32")
    toks, stats = Server(cfg, params, sc, device="cuda", mesh=mesh).generate(
        torch.tensor(prompts, device="cuda"), 8)
    return toks.tolist(), stats


def test_lockstep_tp2_on_one_card_equals_tp1(cuda_device):
    """recurrentgemma-2b at full width with 4 layers (rglru, rglru, attn,
    rglru), f32 weights and KV: a 2048-token prompt takes the local
    layer's blockwise branch, K6 on 5 of the 10 query heads a rank over
    the whole KV head; two ranks on the one card give the one-rank
    ``Server``'s greedy tokens and final position."""
    import dataclasses
    from repro_torch.launch.mesh import spawn
    cfg = dataclasses.replace(configs.get("recurrentgemma-2b"), n_layers=4)
    prompts = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, 2048)).tolist()
    params = init_params(cfg, 0, device=cuda_device, dtype=torch.float32)
    want = _lockstep_tokens(cfg, params, prompts)
    del params
    torch.cuda.empty_cache()
    ranks = spawn(_lockstep_on_rank, (cfg, prompts), model=2,
                  device="cuda", share_device=True)
    assert ranks[0] == want and ranks[1] == want


def _train_on_rank(mesh, cfg, batches, fsdp):
    """One rank of :func:`test_train_dp2_tp2_on_one_card_equals_one_rank`:
    its shard of the seed-0 f32 weights, two flash training steps on the
    mesh; the losses and (rank 0) the whole params on the host."""
    from repro_torch.models.layers import param_defs
    from repro_torch.optim import AdamW
    from repro_torch.runtime import make_train_step
    from repro_torch.runtime import sharding as S
    policy = S.ShardingPolicy(fsdp=fsdp)
    params = S.init_shard(cfg, 0, mesh, policy, device=mesh.device,
                          dtype=torch.float32)
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=4)
    state = opt.init(params)
    step = make_train_step(cfg, opt, mesh, policy, use_flash=True)
    losses = []
    for b in batches:
        params, state, m = step(params, state, {k: v.to(mesh.device)
                                                for k, v in b.items()})
        losses.append(float(m["loss"]))

    def whole(t, d, path):
        return {k: (whole(t[k], d[k], path + (k,)) if isinstance(d[k], dict)
                    else S.unshard_leaf(path + (k,), d[k].axes,
                                        t[k].detach(), d[k].shape, mesh,
                                        policy).cpu())
                for k in d}
    out = whole(params, param_defs(cfg), ())
    return losses, out if mesh.rank == 0 else None


def test_train_dp2_tp2_on_one_card_equals_one_rank(cuda_device):
    """granite-3-2b at full width with 2 layers, f32 weights, flash
    attention (K6 on its 16 of 32 query heads a rank, 2 of 4 rows): four
    ranks of a dp = 2 × tp = 2 FSDP mesh on the one card (gloo on CUDA
    tensors) train two steps to the one-rank step's losses (1e-5
    relative) and params (1e-4 relative norm, AdamW's normalised update
    of sums taken in another order)."""
    import dataclasses
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import spawn
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import make_train_step
    cfg = dataclasses.replace(configs.get("granite-3-2b"), n_layers=2)
    data = SyntheticTokens(cfg, DataConfig(4, 256, 3), device="cpu")
    batches = [data.batch(i) for i in range(2)]
    params = init_params(cfg, 0, device=cuda_device, dtype=torch.float32)
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=4)
    state = opt.init(params)
    step = make_train_step(cfg, opt, use_flash=True)
    want = []
    for b in batches:
        params, state, m = step(params, state, {k: v.to(cuda_device)
                                                for k, v in b.items()})
        want.append(float(m["loss"]))
    want_params = [t.detach().cpu() for t in tree_leaves(params)]
    del params, state
    torch.cuda.empty_cache()
    ranks = spawn(_train_on_rank, (cfg, batches, True), data=2, model=2,
                  device="cuda", share_device=True)
    for losses, _ in ranks:
        assert losses == ranks[0][0]
    for a, b in zip(ranks[0][0], want):
        assert abs(a - b) <= 1e-5 * abs(b), (ranks[0][0], want)
    got = list(tree_leaves(ranks[0][1]))
    num = sum(float((a.double() - b.double()).square().sum())
              for a, b in zip(got, want_params))
    den = sum(float(b.double().square().sum()) for b in want_params)
    assert (num / den) ** 0.5 <= 1e-4


#: the reference's eight flash attention kernel cases, as chip_smoke.py's
#: FA_CASES: (b, s, L, H, Hk, d, causal, window, q_offset): MHA, GQA, MQA,
#: ragged s, a decode step, a window, non-causal, head_dim 256
FA_CASES = [(1, 128, 128, 4, 4, 64, True, None, 0),
            (2, 256, 256, 8, 2, 128, True, None, 0),
            (1, 256, 256, 4, 1, 64, True, None, 0),
            (1, 100, 100, 4, 2, 64, True, None, 0),
            (1, 1, 384, 4, 2, 64, True, None, 383),
            (2, 192, 192, 4, 4, 64, True, 64, 0),
            (1, 64, 64, 4, 4, 128, False, None, 0),
            (1, 128, 128, 2, 2, 256, True, None, 0)]
#: those the rule sends to the tensor-core body in bf16
FA_MMA_CASES = [c for c in FA_CASES
                if fa_ops.flash_body(torch.bfloat16, c[5]) == "mma"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FA_CASES, ids=[str(c) for c in FA_CASES])
def test_flash_attention_kernels_match_plain_version(cuda_device, case,
                                                     dtype):
    """The rule's body through the differentiable wrapper: forward
    within ``kernel_tolerance``; dq, dk, dv within a relative norm of
    1e-5 in f32 (the ``fma`` body: the same f32 arithmetic in another
    order) and 2e-2 in bf16 (D = rowsum(dO*O) reads the bf16-rounded
    output, the gradients round once to bf16, and the ``mma`` body rounds
    P and dS once to bf16)."""
    b, s, L, H, Hk, d, causal, window, q_offset = case
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    mk = lambda *shape: torch.randn(shape, generator=gen,
                                    device=cuda_device).to(dtype)
    q, k, v = mk(b, s, H, d), mk(b, L, Hk, d), mk(b, L, Hk, d)
    g = mk(b, s, H, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = dict(fa_ops.LAUNCHES)
    qk = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*qk, **kw)
    grads = torch.autograd.grad(out, qk, g)
    assert fa_ops.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    assert fa_ops.LAUNCHES["flash_bwd"] == before["flash_bwd"] + 1
    qr = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = fa_ops.attention_ref(*qr, **kw)
    ref_grads = torch.autograd.grad(ref, qr, g)
    torch.cuda.synchronize()
    _assert_within_tolerance(out.detach(), ref.detach(), v)
    limit = 1e-5 if dtype == torch.float32 else 2e-2
    for a, r in zip(grads, ref_grads):
        rel = float((a.float() - r.float()).norm() / r.float().norm())
        assert rel <= limit, rel


def test_flash_attention_wrapper_rejects_what_the_kernels_do_not_take(
        cuda_device):
    q = torch.zeros((1, 8, 4, 64), device=cuda_device)
    k = torch.zeros((1, 8, 2, 64), device=cuda_device)
    with pytest.raises(TypeError, match="f32 or bf16"):
        fa_ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q, k.transpose(1, 2).contiguous()
                               .transpose(1, 2), k)
    with pytest.raises(ValueError, match="d <= 256"):
        big = torch.zeros((1, 8, 2, 512), device=cuda_device)
        fa_ops.flash_attention(torch.zeros((1, 8, 4, 512),
                                           device=cuda_device), big, big)


def test_flash_training_step_equals_eager(cuda_device):
    """Reduced granite-3-2b, f32 weights, remat on: the loss and every
    gradient through the flash attention kernels equal the eager path's
    to f32 rounding."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import make_loss_fn
    cfg = configs.reduced(configs.get("granite-3-2b"))
    params = init_params(cfg, 0, device=cuda_device, dtype=torch.float32)
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 65))).to(
        cuda_device)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:],
             "mask": torch.ones((2, 64), device=cuda_device)}
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    out = {}
    for use_flash in (False, True):
        loss, _ = make_loss_fn(cfg, use_flash=use_flash)(params, batch)
        out[use_flash] = (loss.detach(), torch.autograd.grad(loss, leaves))
    assert abs(float(out[True][0]) - float(out[False][0])) <= \
        1e-5 * abs(float(out[False][0]))
    for a, r in zip(out[True][1], out[False][1]):
        rel = float((a - r).norm() / r.norm().clamp(min=1e-30))
        assert rel <= 1e-4, rel


#: the lockstep step's blockwise branches: (b, s, L, Hk, G, d, window,
#: q_offset) — a dense chunk over a longer cache (llama2-7b's heads, the
#: mma body), a local chunk of its window (recurrentgemma-2b's, fma)
LOCKSTEP_CASES = {"dense": (1, 4096, 5120, 32, 1, 128, None, 1024),
                  "local": (2, 2048, 2048, 1, 10, 256, 2048, 0)}


@pytest.mark.parametrize("case", sorted(LOCKSTEP_CASES))
def test_lockstep_blockwise_runs_the_flash_kernel(cuda_device, case):
    """``attention.lockstep_blockwise`` on the card launches the flash
    forward kernel once, on ``flash_body``'s body, and agrees with the
    plain blockwise loop on the same q, k, v within ``kernel_tolerance``;
    it refuses what the plain loop refuses."""
    from repro_torch.models import attention
    b, s, L, Hk, G, d, window, q_offset = LOCKSTEP_CASES[case]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(4)
    mk = lambda *shape: torch.randn(shape, generator=gen,
                                    device=cuda_device).to(torch.bfloat16)
    q, k, v = mk(b, s, Hk, G, d), mk(b, L, Hk, d), mk(b, L, Hk, d)
    kw = dict(window=window, q_offset=q_offset)
    body = fa_ops.flash_body(torch.bfloat16, d)
    before = fa_ops.BODY_LAUNCHES["flash_fwd"][body]
    out = attention.lockstep_blockwise(q, k, v, **kw)
    assert fa_ops.BODY_LAUNCHES["flash_fwd"][body] == before + 1
    ref = attention.blockwise_attention(q, k, v, d ** -0.5, causal=True, **kw)
    _assert_within_tolerance(out, ref, v)
    with pytest.raises(ValueError, match="multiples of the blocks"):
        attention.lockstep_blockwise(q[:, :1500], k[:, :1500], v[:, :1500],
                                     **kw)


def _flash_inputs(case, device, seed=3, dtype=torch.bfloat16):
    b, s, L, H, Hk, d = case[:6]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=gen,
                                    device=device).to(dtype)
    return mk(b, s, H, d), mk(b, L, Hk, d), mk(b, L, Hk, d), mk(b, s, H, d)


@pytest.mark.parametrize("body", ["mma", "fma"])
@pytest.mark.parametrize("case", FA_MMA_CASES,
                         ids=[str(c) for c in FA_MMA_CASES])
def test_flash_bodies_match_plain_version(cuda_device, case, body):
    """Both bodies on every bf16 case the rule sends to ``mma`` (the
    ``fma`` body forced): the forward within ``kernel_tolerance``, dq,
    dk, dv within a relative norm of 2e-2 of autograd through the plain
    version (one bf16 rounding of P and dS in the ``mma`` backward, of
    every gradient in both)."""
    kw = dict(causal=case[6], window=case[7], q_offset=case[8])
    q, k, v, do = _flash_inputs(case, cuda_device)
    before = {n: dict(c) for n, c in fa_ops.BODY_LAUNCHES.items()}
    o, lse = fa_ops.flash_fwd(q, k, v, body=body, **kw)
    grads = fa_ops.flash_bwd(q, k, v, o, lse, do, body=body, **kw)
    for name in ("flash_fwd", "flash_bwd"):
        assert fa_ops.BODY_LAUNCHES[name][body] == before[name][body] + 1
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = fa_ops.attention_ref(*leaves, **kw)
    ref_grads = torch.autograd.grad(ref, leaves, do)
    torch.cuda.synchronize()
    _assert_within_tolerance(o, ref.detach(), v)
    for a, r in zip(grads, ref_grads):
        rel = float((a.float() - r.float()).norm() / r.float().norm())
        assert rel <= 2e-2, rel


def test_flash_mma_backward_is_deterministic(cuda_device):
    """Two identical backward calls give bit-identical gradients (no
    atomics; GQA's sum inside one dK/dV block), as the bit-exact resume
    of a training run needs."""
    case = (2, 384, 384, 8, 2, 64, True, None, 0)
    q, k, v, do = _flash_inputs(case, cuda_device)
    o, lse = fa_ops.flash_fwd(q, k, v)
    first = fa_ops.flash_bwd(q, k, v, o, lse, do)
    second = fa_ops.flash_bwd(q, k, v, o, lse, do)
    o2, lse2 = fa_ops.flash_fwd(q, k, v)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bf16_train_shape_runs_on_the_mma_body(cuda_device):
    """granite-3-2b's attention at the train phase's shape, through the
    differentiable wrapper: both directions land on the tensor cores."""
    case = (4, 2048, 2048, 32, 8, 64, True, None, 0)
    q, k, v, do = _flash_inputs(case, cuda_device)
    before = {n: dict(c) for n, c in fa_ops.BODY_LAUNCHES.items()}
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves)
    torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    got = {n: {b: fa_ops.BODY_LAUNCHES[n][b] - before[n][b] for b in c}
           for n, c in before.items()}
    assert got == {"flash_fwd": {"mma": 1, "fma": 0},
                   "flash_bwd": {"mma": 1, "fma": 0}}
    assert fa_ops.flash_body(torch.float32, 64) == "fma"


def test_flash_mma_tiles_match_the_library(cuda_device):
    """The tile plan the tests emulate is the one the CUDA source uses."""
    import ctypes
    lib = fa_ops.load_library()
    for d in range(16, 129, 16):
        out = (ctypes.c_int * 7)()
        assert lib.flash_mma_tiles(d, out) == 0
        assert tuple(out) == tuple(vars(fa_ops.mma_tiles(d)).values())
    assert lib.flash_mma_tiles(136, (ctypes.c_int * 7)()) == -1


def test_flash_wrapper_refuses_to_force_mma_where_it_does_not_apply(
        cuda_device):
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 256)):
        q, k, v, _ = _flash_inputs((1, 16, 16, 2, 2, d, True, None, 0),
                                   cuda_device, dtype=dtype)
        with pytest.raises(ValueError, match="mma body takes"):
            fa_ops.flash_fwd(q, k, v, body="mma")
    with pytest.raises(ValueError, match="body must be one of"):
        fa_ops.flash_fwd(q, k, v, body="wgmma")


#: (m, k, n, group_size, bits, x dtype): decode and a prefill chunk at a
#: llama2-7b projection, int8, a ragged n with g=64, one k row group
QMM_GPU_CASES = [(4, 4096, 4096, 128, 4, torch.bfloat16),
                 (256, 4096, 1024, 128, 4, torch.bfloat16),
                 (4, 1024, 512, 128, 8, torch.bfloat16),
                 (5, 1024, 200, 64, 4, torch.float32),
                 (5, 1024, 200, 64, 4, torch.bfloat16),
                 (17, 128, 33, 128, 4, torch.float32)]


@pytest.mark.parametrize("case", QMM_GPU_CASES,
                         ids=[str(c[:5]) + str(c[5])[6:] for c in QMM_GPU_CASES])
def test_quant_matmul_kernel_matches_plain_version(cuda_device, case):
    """K5 against its plain version; tolerance ``kernel_tolerance`` with
    the output as its scale: one bf16 ulp plus 1e-3 of the mean magnitude
    for bf16 outputs, 1e-4 of max|y| for f32 ones (both sides accumulate
    in f32 from the same dequantized weights, in other orders)."""
    from repro_torch.kernels.quant_matmul import ops as qmm
    from repro_torch.quant import quant_dense, quantize_weight
    m, k, n, g, bits, dtype = case
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    w = torch.randn((k, n), generator=gen, device=cuda_device) * 0.02
    q = quantize_weight(w, group_size=g, bits=bits)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dtype)
    before = qmm.LAUNCHES["quant_matmul"]
    out = quant_dense(x, q)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["quant_matmul"] == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    ref = qmm.quant_matmul_ref(x, q.w_q, q.scales, q.zeros, g)
    _assert_within_tolerance(out, ref, ref)


#: (m, k, n, group_size, bits, x dtype) through the wrapper's own rule:
#: m on both sides of WGMMA_MIN_ROWS, a ragged n at g = 64, int8, f32 x
QMM_BODY_CASES = ([(m, 1024, 384, 128, 4, torch.bfloat16)
                   for m in (1, 4, 15, 63, 64, 65, 256)]
                  + [(64, 1024, 200, 64, 4, torch.bfloat16),
                     (64, 1024, 208, 64, 4, torch.bfloat16),
                     (130, 512, 336, 128, 8, torch.bfloat16),
                     (130, 512, 200, 64, 8, torch.bfloat16),
                     (96, 1024, 256, 128, 4, torch.float32),
                     (3, 1024, 200, 64, 8, torch.float32)])


@pytest.mark.parametrize("force", [None, "wgmma", "splitk"])
@pytest.mark.parametrize("case", QMM_BODY_CASES,
                         ids=[str(c[:5]) + str(c[5])[6:]
                              for c in QMM_BODY_CASES])
def test_quant_matmul_bodies_match_plain_version(cuda_device, monkeypatch,
                                                 case, force):
    """Each body against the plain version at ``kernel_tolerance``: the
    wrapper's choice, and each body forced by moving its m threshold (f32
    x, a group size that is not a multiple of 64 and a width that is not
    one of 16 always take splitk).
    The chosen body's count rises by one per call, the other's not."""
    from repro_torch.kernels.quant_matmul import ops as qmm
    from repro_torch.quant import quantize_weight
    m, k, n, g, bits, dtype = case
    if force is not None:
        monkeypatch.setattr(qmm, "WGMMA_MIN_ROWS",
                            1 if force == "wgmma" else 1 << 30)
    body = qmm.qmm_body(dtype, m, n, g)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(m)
    w = torch.randn((k, n), generator=gen, device=cuda_device) * 0.02
    q = quantize_weight(w, group_size=g, bits=bits)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dtype)
    before = dict(qmm.BODY_LAUNCHES)
    out = qmm.quant_matmul(x, q.w_q, q.scales, q.zeros, group_size=g)
    torch.cuda.synchronize()
    assert qmm.BODY_LAUNCHES == dict(before, **{body: before[body] + 1})
    ref = qmm.quant_matmul_ref(x, q.w_q, q.scales, q.zeros, g)
    _assert_within_tolerance(out, ref, ref)


def test_quant_matmul_splitk_is_deterministic(cuda_device):
    """The split partials are added in one order: the same bits twice."""
    from repro_torch.kernels.quant_matmul import ops as qmm
    from repro_torch.quant import quantize_weight
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(5)
    q = quantize_weight(torch.randn((4096, 512), generator=gen,
                                    device=cuda_device) * 0.02)
    x = torch.randn((4, 4096), generator=gen, device=cuda_device).bfloat16()
    assert qmm.splitk_plan(4, 4096, 512, 128).splits > 1
    a = qmm.quant_matmul(x, q.w_q, q.scales, q.zeros)
    b = qmm.quant_matmul(x, q.w_q, q.scales, q.zeros)
    assert torch.equal(a, b)


def test_quant_matmul_wrapper_rejects_what_the_kernel_does_not_take(
        cuda_device):
    from repro_torch.kernels.quant_matmul import ops as qmm
    from repro_torch.quant import quantize_weight
    q = quantize_weight(torch.randn((256, 64), device=cuda_device))
    x = torch.zeros((4, 256), device=cuda_device)
    with pytest.raises(TypeError, match="f32 or bf16"):
        qmm.quant_matmul(x.half(), q.w_q, q.scales, q.zeros)
    with pytest.raises(TypeError, match="int8"):
        qmm.quant_matmul(x, q.w_q.int(), q.scales, q.zeros)
    with pytest.raises(ValueError, match="contiguous"):
        qmm.quant_matmul(torch.zeros((256, 4), device=cuda_device).t(),
                         q.w_q, q.scales, q.zeros)
    with pytest.raises(ValueError, match="does not divide"):
        qmm.quant_matmul(x, q.w_q, q.scales, q.zeros, group_size=100)


def test_quantize_on_the_card_equals_the_cpu(cuda_device):
    from repro_torch.quant import quantize_weight
    w = torch.randn((1024, 300), generator=torch.Generator().manual_seed(3))
    for bits in (4, 8):
        a = quantize_weight(w.to(cuda_device), group_size=64, bits=bits)
        b = quantize_weight(w, group_size=64, bits=bits)
        assert torch.equal(a.w_q.cpu(), b.w_q)
        assert torch.equal(a.scales.cpu().view(torch.int16),
                           b.scales.view(torch.int16))
        assert torch.equal(a.zeros.cpu().view(torch.int16),
                           b.zeros.view(torch.int16))
