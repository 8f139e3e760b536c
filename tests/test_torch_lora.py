"""Multi-tenant LoRA pieces of the port against the JAX package: the plain
versions of the grouped-LoRA kernel (what its wrapper computes for CPU
tensors) against the reference's oracle and its Pallas kernel in
interpret mode on the reference tests' cases, the adapter pool under
random operation sequences, the seeded adapter store (bit-identical
factors), the merged-weights ceiling and the cache's adapter buffers.
The CUDA kernel is held to the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.engine import adapter_pool as jap
from repro.engine.decode_loop import _pregather_lora
from repro.engine.kv_cache import BlockPagedKVCache as JCache
from repro.kernels.grouped_lora import grouped_lora as pallas_lora
from repro.kernels.grouped_lora import grouped_lora_ref as jax_lora_ref
from repro.kernels.grouped_lora.ref import (
    grouped_lora_pregathered as jax_pregathered)
from repro.models import init_params as jax_init_params
from repro_torch import bridge, configs
from repro_torch.engine import adapter_pool as tap
from repro_torch.engine.kv_cache import BlockPagedKVCache
from repro_torch.kernels.grouped_lora import (grouped_lora,
                                              grouped_lora_pregathered,
                                              grouped_lora_qkv,
                                              grouped_lora_ref)
from repro_torch.kernels.grouped_lora.ref import pregather

_JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pool(P, k, n, R, ranks, seed=0):
    """Adapter pool with per-slot rank ``ranks[p % len(ranks)]``, lanes
    past each adapter's true rank exactly zero (the storage contract)."""
    rng = np.random.default_rng(seed)
    A = np.zeros((P, k, R), np.float32)
    B = np.zeros((P, R, n), np.float32)
    for p in range(P):
        r = ranks[p % len(ranks)]
        A[p, :, :r] = rng.standard_normal((k, r)) * r ** -0.5
        B[p, :r, :] = rng.standard_normal((r, n)) * 0.1
    return A, B


def _t(a):
    return bridge.tensor_from_numpy(np.asarray(a), device="cpu")


def _np(a):
    return np.asarray(a, np.float32)


def _check(x, A, B, idx, dt):
    """Plain version vs the reference's oracle and its Pallas kernel.

    f32: both sides accumulate the same products in f32 in another
    order, so 1e-5 of max|delta|.  bf16: both round one f32 result to
    bf16, so one bf16 ulp (2**-7 of the element) plus that slack."""
    xs, As, Bs = (np.array(jnp.asarray(a, _JNP[dt])) for a in (x, A, B))
    got = grouped_lora(_t(xs), _t(As), _t(Bs), _t(idx))
    assert got.dtype == (torch.float32 if dt == "f32" else torch.bfloat16)
    jargs = (jnp.asarray(xs), jnp.asarray(As), jnp.asarray(Bs),
             jnp.asarray(idx))
    for want in (jax_lora_ref(*jargs), pallas_lora(*jargs)):
        want = _np(want)
        slack = 1e-5 * max(1.0, float(np.abs(want).max()))
        tol = slack if dt == "f32" else 2.0 ** -7 * np.abs(want) + slack
        assert np.all(np.abs(_np(bridge.tensor_to_numpy(got)) - want)
                      <= tol)
    return got


@pytest.mark.parametrize("rank", [4, 8, 16, 64])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ref_matches_jax_ref_and_pallas_uniform_rank(rank, dt):
    S, T, k, n, P = 3, 2, 96, 64, 4
    rng = np.random.default_rng(5)
    x = rng.standard_normal((S, T, k)).astype(np.float32)
    A, B = _pool(P, k, n, rank, (rank,))
    _check(x, A, B, np.asarray([2, 0, 3], np.int32), dt)


@pytest.mark.parametrize("T", [1, 5])
def test_ref_matches_mixed_ranks_and_holes(T):
    """A mixed-rank pool with repeated slots and idx = -1 holes: exact
    zeros where there is no adapter, the same deltas elsewhere."""
    S, k, n, P, R = 6, 64, 48, 5, 16
    rng = np.random.default_rng(6)
    x = rng.standard_normal((S, T, k)).astype(np.float32)
    A, B = _pool(P, k, n, R, (4, 8, 16))
    idx = np.asarray([0, -1, 3, 0, 4, -1], np.int32)
    got = _check(x, A, B, idx, "f32")
    assert not got[1].any() and not got[5].any()
    assert got[2].any() and got[0].any() and got[3].any()
    # the pregathered form of the gather path is the same function
    a, b = (pregather(_t(f)[None], _t(idx))[0] for f in (A, B))
    pre = grouped_lora_pregathered(_t(x), a, b)
    np.testing.assert_allclose(pre.numpy(), got.numpy(), rtol=0, atol=1e-6)
    jx = _pregather_lora({"A": jnp.asarray(A)[None], "B": jnp.asarray(B)[None]},
                         jnp.asarray(idx))
    np.testing.assert_array_equal(a.numpy(), np.asarray(jx["A"][0]))
    np.testing.assert_allclose(
        pre.numpy(), _np(jax_pregathered(jnp.asarray(x), jx["A"][0],
                                         jx["B"][0])), rtol=0, atol=1e-5)


def test_ref_scale_and_dtype():
    rng = np.random.default_rng(8)
    x = _t(rng.standard_normal((2, 3, 16)).astype(np.float32))
    A, B = (_t(f) for f in _pool(2, 16, 8, 4, (4,)))
    idx = torch.tensor([1, -1], dtype=torch.int32)
    one = grouped_lora_ref(x, A, B, idx)
    half = grouped_lora_ref(x, A, B, idx, scale=0.5)
    torch.testing.assert_close(half, 0.5 * one, rtol=0, atol=0)
    assert grouped_lora_ref(x.bfloat16(), A, B, idx).dtype == torch.bfloat16


@pytest.mark.parametrize("T", [1, 5, 24])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_qkv_equals_three_plain_calls(T, dt):
    """``grouped_lora_qkv`` (one launch on the card) on the CPU is three
    ``grouped_lora_ref`` calls, bit for bit: a mixed-rank pool, a shared
    tenant, holes, and q wider than k and v (qwen2-7b's GQA shape cut
    down), with a scale."""
    S, k, P, R = 5, 64, 4, 16
    rng = np.random.default_rng(10 + T)
    x = _t(rng.standard_normal((S, T, k)).astype(np.float32))
    idx = torch.tensor([2, -1, 0, 2, 3], dtype=torch.int32)
    pairs = []
    for i, n in enumerate((56, 8, 8)):
        A, B = _pool(P, k, n, R, (4, 8, 16), seed=i)
        pairs.append(tuple(_t(f).to(_TORCH[dt]) for f in (A, B)))
    x = x.to(_TORCH[dt])
    got = grouped_lora_qkv(x, *pairs, idx, scale=0.5)
    assert len(got) == 3
    for out, (A, B) in zip(got, pairs):
        want = grouped_lora_ref(x, A, B, idx, scale=0.5)
        assert out.dtype == want.dtype and out.shape == want.shape
        assert torch.equal(out, want)
        assert not out[1].any()


def test_slot_past_the_pool_raises():
    """idx = P is a fault, not a hole: only idx < 0 gives a zero delta."""
    rng = np.random.default_rng(9)
    x = _t(rng.standard_normal((2, 1, 16)).astype(np.float32))
    A, B = (_t(f) for f in _pool(2, 16, 8, 4, (4,)))
    with pytest.raises(IndexError):
        grouped_lora(x, A, B, torch.tensor([0, 2], dtype=torch.int32))


@pytest.mark.parametrize("seed", range(4))
def test_adapter_pool_matches_reference(seed):
    """Random acquire/release/can_acquire sequences give the same slots,
    load flags, refusals and counters as the reference's pool."""
    rng = np.random.default_rng(seed)
    n_slots = int(rng.integers(1, 4))
    ours, ref = tap.AdapterPool(n_slots), jap.AdapterPool(n_slots)
    held = []
    for _ in range(200):
        op = rng.integers(0, 3)
        aid = int(rng.integers(0, 6))
        if op == 0:
            assert ours.can_acquire(aid) == ref.can_acquire(aid)
            try:
                want = ref.acquire(aid)
            except jap.AdapterPoolExhausted:
                with pytest.raises(tap.AdapterPoolExhausted):
                    ours.acquire(aid)
                continue
            assert ours.acquire(aid) == want
            held.append(aid)
        elif op == 1 and held:
            aid = held.pop(int(rng.integers(0, len(held))))
            ours.release(aid)
            ref.release(aid)
        for a in range(6):
            assert ours.slot_of(a) == ref.slot_of(a)
            assert ours.refcount(a) == ref.refcount(a)
    assert (ours.hits, ours.misses, ours.evictions, ours.n_resident) == (
        ref.hits, ref.misses, ref.evictions, ref.n_resident)
    assert ours.hit_rate == ref.hit_rate
    with pytest.raises(ValueError, match="unacquired"):
        tap.AdapterPool(1).release(0)
    with pytest.raises(ValueError, match="n_slots"):
        tap.AdapterPool(0)


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen2-7b"])
def test_adapter_store_factors_are_bit_identical(arch):
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    cfg = configs.reduced(configs.get(arch))
    ours = tap.AdapterStore(cfg, 5, (4, 8, 16), seed=3)
    ref = jap.AdapterStore(jcfg, 5, (4, 8, 16), seed=3)
    assert tap.LORA_FACTORS == jap.LORA_FACTORS
    assert ours.max_rank == ref.max_rank == 16
    for aid in (0, 2, 4):
        assert ours.rank_of(aid) == ref.rank_of(aid)
        got, want = ours.factors(aid), ref.factors(aid)
        assert list(got) == list(want)
        for name in tap.LORA_FACTORS:
            assert got[name].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                bridge.tensor_to_numpy(got[name]).view(np.int16),
                np.asarray(want[name]).view(np.int16))
    for bad in (-1, 5):
        with pytest.raises(ValueError, match="outside tenant"):
            ours.rank_of(bad)
    with pytest.raises(ValueError, match="ranks"):
        tap.AdapterStore(cfg, 2, ())


def test_merged_params_match_reference():
    jcfg = jconfigs.reduced(jconfigs.get("qwen2-7b"))
    cfg = configs.reduced(configs.get("qwen2-7b"))
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(jnp.float32)),
        jax_init_params(jcfg, jax.random.PRNGKey(0)))
    got = tap.AdapterStore(cfg, 3, (4, 8)).merged_params(
        bridge.params_from_numpy(tree, device="cpu"), 1, scale=0.5)
    want = jap.AdapterStore(jcfg, 3, (4, 8)).merged_params(
        jax.tree_util.tree_map(jnp.asarray, tree), 1, scale=0.5)
    for w in ("wq", "wk", "wv", "wo"):
        np.testing.assert_allclose(
            got["layers"]["attn"][w].numpy(),
            np.asarray(want["layers"]["attn"][w]), rtol=1e-6, atol=1e-7)


def test_cache_adapter_buffers_match_reference():
    geo = dict(max_slots=3, n_blocks=5, block_size=8, max_blocks_per_seq=2,
               lora_slots=2, lora_max_rank=16)
    cache = BlockPagedKVCache(configs.reduced(configs.get("qwen2-7b")), **geo)
    jcache = JCache(jconfigs.reduced(jconfigs.get("qwen2-7b")), **geo)
    state, jstate = cache.init_state("cpu"), jcache.init_state()
    assert state.keys() == jstate.keys()
    for k, v in jstate.items():
        assert tuple(state[k].shape) == v.shape, k
        np.testing.assert_array_equal(bridge.tensor_to_numpy(state[k]),
                                      np.asarray(v))
    state["adapter_slots"][1] = 0
    state = cache.reset_slot(state, 1)
    assert state["adapter_slots"].tolist() == [-1, -1, -1]
    with pytest.raises(ValueError, match="lora_max_rank"):
        BlockPagedKVCache(cache.cfg, 1, 2, 8, 2, lora_slots=1)
