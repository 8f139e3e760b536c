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


@pytest.mark.parametrize("T", [1, 5, 40])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_grouped_lora_kernel_matches_plain_version(cuda_device, T, x_dtype):
    """Mixed ranks (4/8/16 padded to 16), a shared tenant and holes."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(2)
    S, k, n, P, R = 5, 320, 300, 4, 16
    A = torch.zeros((P, k, R), device=cuda_device)
    B = torch.zeros((P, R, n), device=cuda_device)
    for p, r in enumerate((4, 8, 16, 8)):
        A[p, :, :r] = torch.randn((k, r), generator=gen,
                                  device=cuda_device) * r ** -0.5
        B[p, :r] = torch.randn((r, n), generator=gen,
                               device=cuda_device) * 0.05
    A, B = A.bfloat16().contiguous(), B.bfloat16().contiguous()
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


#: (b, s, L, H, Hk, d, causal, window, q_offset): GQA, ragged s, a decode
#: step, a window, non-causal, head_dim 256 (the reference's FA_CASES)
FA_GPU_CASES = [(2, 256, 256, 8, 2, 128, True, None, 0),
                (1, 100, 100, 4, 2, 64, True, None, 0),
                (1, 1, 384, 4, 2, 64, True, None, 383),
                (2, 192, 192, 4, 4, 64, True, 64, 0),
                (1, 64, 64, 4, 4, 128, False, None, 0),
                (1, 128, 128, 2, 2, 256, True, None, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FA_GPU_CASES,
                         ids=[str(c) for c in FA_GPU_CASES])
def test_flash_attention_kernels_match_plain_version(cuda_device, case,
                                                     dtype):
    """Forward within ``kernel_tolerance``; dq, dk, dv within a relative
    norm of 1e-5 in f32 (the same f32 arithmetic in another order) and
    2e-2 in bf16 (the kernel's D = rowsum(dO*O) reads the bf16-rounded
    output, and its gradients round once to bf16)."""
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
