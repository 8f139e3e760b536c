"""Tests that need the card: the CUDA kernels against their plain
versions, and the engine's two attention impls against each other.

They import neither JAX nor the JAX package, so they run on a GPU
machine as they are:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Elsewhere they skip (a CUDA kernel has no CPU mode); ``chip_smoke.py``
runs the same checks at the main path's shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.engine import Engine, EngineConfig, Request
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
