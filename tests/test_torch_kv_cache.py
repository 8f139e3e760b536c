"""Engine host state of the port against the JAX package: KV cache
geometry and slot lifecycle, the saturating int8 KV cast, the block pool
and radix index under seeded random operation sequences, and sampling."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.engine import block_pool as jbp
from repro.engine.kv_cache import BlockPagedKVCache as JCache
from repro.engine.kv_cache import engine_supported as jax_engine_supported
from repro_torch import bridge, configs
from repro_torch.engine import block_pool as tbp
from repro_torch.engine import sample, to_kv
from repro_torch.engine.kv_cache import BlockPagedKVCache, engine_supported


@pytest.mark.parametrize("kv", ["bf16", "int8", "fp32"])
@pytest.mark.parametrize("arch", ["llama2-7b", "qwen2-7b"])
def test_cache_geometry_matches_reference(arch, kv):
    geo = dict(max_slots=3, n_blocks=7, block_size=16, max_blocks_per_seq=5,
               kv_dtype=kv)
    ref = JCache(jconfigs.get(arch), **geo)
    got = BlockPagedKVCache(configs.get(arch), **geo)
    assert got.buffer_shape() == ref.buffer_shape()
    assert got.bytes_per_block() == ref.bytes_per_block()
    assert got.total_bytes() == ref.total_bytes()
    assert got.max_len == ref.max_len
    small = BlockPagedKVCache(configs.reduced(configs.get(arch)), **geo)
    state = small.init_state("cpu")
    jstate = JCache(jconfigs.reduced(jconfigs.get(arch)), **geo).init_state()
    assert state.keys() == jstate.keys()
    for k, v in jstate.items():
        assert tuple(state[k].shape) == v.shape, k
        assert bridge.tensor_to_numpy(state[k]).dtype == np.asarray(v).dtype, k


def test_engine_supported_matches_reference():
    for arch in configs.ARCHS:
        assert engine_supported(configs.get(arch)) == jax_engine_supported(
            jconfigs.get(arch))
    ssm = jconfigs.get("falcon-mamba-7b")
    port_ssm = configs.ArchConfig(**{f: getattr(ssm, f) for f in
                                     ssm.__dataclass_fields__})
    assert not engine_supported(port_ssm)
    with pytest.raises(ValueError, match="does not support"):
        BlockPagedKVCache(port_ssm, 1, 2, 16, 2)


def test_copy_block_and_reset_slot_match_reference():
    cfg = configs.reduced(configs.get("llama2-7b"))
    jcfg = jconfigs.reduced(jconfigs.get("llama2-7b"))
    geo = dict(max_slots=2, n_blocks=4, block_size=4, max_blocks_per_seq=2,
               kv_dtype="int8")
    cache, jcache = BlockPagedKVCache(cfg, **geo), JCache(jcfg, **geo)
    rng = np.random.default_rng(0)
    vals = rng.integers(-128, 128, cache.buffer_shape()).astype(np.int8)
    state = cache.init_state("cpu")
    state["cache_k"].copy_(torch.from_numpy(vals))
    state["cache_v"].copy_(torch.from_numpy(-vals))
    state["pos"][1], state["tok"][1] = 5, 9
    jstate = jcache.init_state()
    jstate["cache_k"], jstate["cache_v"] = jnp.asarray(vals), jnp.asarray(-vals)
    jstate["pos"] = jstate["pos"].at[1].set(5)
    jstate["tok"] = jstate["tok"].at[1].set(9)
    state = cache.reset_slot(cache.copy_block(state, 2, 0), 1)
    jstate = jcache.reset_slot(jcache.copy_block(jstate, 2, 0), 1)
    for k in jstate:
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(jstate[k]))


@pytest.mark.parametrize("src", ["bf16", "f32"])
def test_int8_cast_saturates_like_reference(src):
    """torch wraps an out-of-range float->int8 cast (bf16 300 -> 44);
    the reference saturates it; the port's KV cast must agree."""
    vals = [300.0, -300.0, 1.7, -1.7, -128.9, 127.6, -0.5, 0.0, 126.0]
    jdt = jnp.bfloat16 if src == "bf16" else jnp.float32
    jx = jnp.asarray(vals, jdt)
    want = np.asarray(jx.astype(jnp.int8))
    got = to_kv(bridge.tensor_from_numpy(np.asarray(jx), device="cpu"),
                torch.int8)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:5].tolist() == [127, -128, 1, -1, -128]


def _run_ops(mod, seed, n_ops=300):
    """A seeded random sequence of pool/index operations; returns every
    observable result in order."""
    rng = np.random.default_rng(seed)
    bs = 4
    pool = mod.BlockPool(24, bs)
    index = mod.RadixIndex(pool)
    held, log = [], []
    vocab = 3                       # few tokens: many shared prefixes
    for _ in range(n_ops):
        op = rng.integers(0, 5)
        if op == 0:
            try:
                b = pool.alloc()
                held.append(b)
                log.append(("alloc", b))
            except mod.PoolExhausted:
                log.append(("exhausted",))
        elif op == 1 and held:
            b = held.pop(int(rng.integers(0, len(held))))
            log.append(("decref", b, pool.decref(b)))
        elif op == 2:
            n = int(rng.integers(1, 4))
            toks = rng.integers(0, vocab, n * bs + int(rng.integers(0, bs)))
            blocks = []
            for _ in range(n):
                if pool.n_free == 0:
                    break
                blocks.append(pool.alloc())
            log.append(("insert", index.insert(toks.tolist(), blocks)))
            held.extend(blocks)
        elif op == 3:
            toks = rng.integers(0, vocab, int(rng.integers(0, 4 * bs)))
            hits = index.match(toks.tolist())
            log.append(("match", tuple(hits)))
        else:
            log.append(("evict", index.evict(int(rng.integers(1, 4)))))
        log.append(("state", pool.n_free, pool.in_use, index.n_indexed,
                    tuple(pool.refcount(b) for b in range(pool.n_blocks))))
    return log


@pytest.mark.parametrize("seed", range(6))
def test_block_pool_and_radix_index_match_reference(seed):
    assert _run_ops(tbp, seed) == _run_ops(jbp, seed)


def test_sample_greedy_and_temperature_distribution():
    logits = torch.tensor([[0.1, 2.0, -1.0, 1.5, 0.0]])
    assert sample(logits, 0.0, vocab=5).tolist() == [1]
    assert sample(logits[0], -1.0, vocab=5).item() == 1
    gen = torch.Generator().manual_seed(0)
    n, temp = 40_000, 0.7
    draws = sample(logits.expand(n, -1), temp, gen, vocab=5)
    freq = np.bincount(draws.numpy(), minlength=5) / n
    want = torch.softmax(logits[0] / temp, -1).numpy()
    # 4 sigma of a binomial proportion at n=40k is below 0.01
    np.testing.assert_allclose(freq, want, atol=0.01)
    again = sample(logits.expand(n, -1), temp,
                   torch.Generator().manual_seed(0), vocab=5)
    assert torch.equal(draws, again)       # the generator fixes the draws
