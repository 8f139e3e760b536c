"""End to end: the port's engine against the reference ``Engine`` on
shared f32 weights.  Tokens and the ``TraceEvent`` sequence must be
identical, and the port's trace must replay through the reference's
analytical twin to the same forecast, for both attention impls and both
KV dtypes, through tail chunks, a radix prefix hit, a copy-on-write fork,
pool backpressure and EOS attrition — and with speculative decoding,
bucketed batched admission, multi-tenant LoRA (with adapter-pool
eviction), all three at once, and the prefix cache switched off."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import Variant
from repro.core import hardware
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import ForecastTwin
from repro.engine import Request as JRequest
from repro.engine.scheduler import TraceEvent as JTraceEvent
from repro.launch.mesh import make_host_mesh
from repro.models import init_params as jax_init_params
from repro.runtime import ShardingPolicy
from repro_torch import bridge, configs
from repro_torch.engine import Engine, EngineConfig, Request, TraceEvent

ARCHS = ["llama2-7b", "qwen2-7b"]

#: block_size 8, chunk 8, 2 slots and a 6-block pool:
#: rid 0 (24 tokens) indexes 3 full blocks; rid 1 (19 tokens: a tail
#: chunk of 3) shares 10 of them -> an 8-token radix hit; rid 2 repeats
#: rid 0 -> a 23-token hit whose partial block is forked copy-on-write;
#: rid 3 (13 tokens: a tail chunk of 5) finds the pool exhausted and waits
#: (admission backpressure) until rid 2 frees its blocks.
GEOMETRY = dict(max_slots=2, max_len=32, chunk_size=8, decode_block=3,
                block_size=8, n_blocks=6)


def _prompts(vocab):
    rng = np.random.default_rng(3)
    p0 = rng.integers(0, vocab, 24)
    p1 = np.concatenate([p0[:10], rng.integers(0, vocab, 9)])
    p3 = rng.integers(0, vocab, 13)
    return [p0.tolist(), p1.tolist(), p0.tolist(), p3.tolist()]


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's init in f32 (biases made non-zero) as numpy."""
    cfg = jconfigs.reduced(jconfigs.get(arch))
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(jnp.float32)),
        jax_init_params(cfg, jax.random.PRNGKey(0)))
    attn = tree["layers"]["attn"]
    rng = np.random.default_rng(1)
    for b in ("bq", "bk", "bv"):
        if b in attn:
            attn[b] = (rng.standard_normal(attn[b].shape) * 0.1).astype(
                np.float32)
    return tree


def _run_both(arch, kw, max_new=6, adapters=None):
    """Serve ``_prompts`` through the reference engine and the port's;
    ``adapters`` gives each request's LoRA tenant (None = base model)."""
    np_tree = _weights(arch)
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    cfg = configs.reduced(configs.get(arch))
    prompts = _prompts(cfg.vocab_size)
    aids = adapters or [None] * len(prompts)
    mesh = make_host_mesh()
    with mesh:
        jeng = JEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, np_tree),
                       mesh, ShardingPolicy(), JEngineConfig(**kw))
        jres = jeng.run([JRequest(rid=i, prompt=p, max_new=max_new,
                                  adapter_id=a)
                         for i, (p, a) in enumerate(zip(prompts, aids))])
    eng = Engine(cfg, bridge.params_from_numpy(np_tree, device="cpu"),
                 EngineConfig(**kw), device="cpu")
    res = eng.run([Request(rid=i, prompt=p, max_new=max_new, adapter_id=a)
                   for i, (p, a) in enumerate(zip(prompts, aids))])
    return (jeng, jres), (eng, res)


def _as_reference(trace):
    return [JTraceEvent(**dataclasses.asdict(ev)) for ev in trace]


def _assert_same_run(arch, jeng, jres, eng, res, kv="bf16"):
    """Tokens, counters, trace, final cursors and K/V pool, and the
    reference twin's replay of the port's trace, all as the reference."""
    assert [r.tokens for r in res] == [r.tokens for r in jres]
    assert [r.cached_tokens for r in res] == [r.cached_tokens for r in jres]
    assert eng.prefix_hit_tokens == jeng.prefix_hit_tokens
    assert eng.peak_blocks_in_use == jeng.peak_blocks_in_use
    assert _as_reference(eng.trace) == jeng.trace
    np.testing.assert_array_equal(eng.state["pos"].numpy(),
                                  np.asarray(jeng.state["pos"]))
    for name in ("cache_k", "cache_v"):
        got = bridge.tensor_to_numpy(eng.state[name]).astype(np.float32)
        want = np.asarray(jeng.state[name]).astype(np.float32)
        np.testing.assert_array_equal(got == 0, want == 0)
        if kv == "int8":
            np.testing.assert_allclose(got, want, rtol=0, atol=1)
        else:
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    twin = ForecastTwin(jcfg, hardware.TPU_V5E, Variant(), em=0.8)
    want = twin.replay(jeng.trace)
    got = twin.replay(_as_reference(eng.trace))
    assert got.total_time == want.total_time
    assert got.total_tokens == want.total_tokens
    for rid, rf in want.requests.items():
        assert got.requests[rid].ttft == rf.ttft
        assert got.requests[rid].tpot == rf.tpot


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("impl", ["gather", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch, impl, kv):
    (jeng, jres), (eng, res) = _run_both(
        arch, dict(GEOMETRY, attn_impl=impl, kv_dtype=kv))
    # the schedule this scenario is built to exercise
    assert [r.cached_tokens for r in res] == [0, 8, 23, 0]
    chunks = [e.chunk for e in eng.trace if e.kind == "prefill_chunk"]
    assert 3 in chunks and 5 in chunks and 1 in chunks      # tail chunks
    rid3 = [i for i, e in enumerate(eng.trace)
            if e.kind == "prefill_chunk" and e.rid == 3][0]
    assert any(e.kind == "decode_block" and [s[0] for s in e.slots] == [2]
               for e in eng.trace[:rid3])                   # rid 3 waited
    assert res[3].queue_time > 0
    assert eng.peak_blocks_in_use <= GEOMETRY["n_blocks"]
    # identical to the reference: tokens, counters, trace
    assert [r.tokens for r in res] == [r.tokens for r in jres]
    assert [r.cached_tokens for r in res] == [r.cached_tokens for r in jres]
    assert eng.prefix_hit_tokens == jeng.prefix_hit_tokens
    assert eng.peak_blocks_in_use == jeng.peak_blocks_in_use
    assert _as_reference(eng.trace) == jeng.trace
    # every slot ends free with its cursor back at 0, like the reference
    np.testing.assert_array_equal(eng.state["pos"].numpy(),
                                  np.asarray(jeng.state["pos"]))
    # and the pool holds the same K/V: the same entries written, none
    # dropped or extra; values to one unit of the storage type's last
    # place (the two frameworks round the f32 activations apart)
    for name in ("cache_k", "cache_v"):
        got = bridge.tensor_to_numpy(eng.state[name]).astype(np.float32)
        want = np.asarray(jeng.state[name]).astype(np.float32)
        np.testing.assert_array_equal(got == 0, want == 0)
        if kv == "int8":
            np.testing.assert_allclose(got, want, rtol=0, atol=1)
        else:
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    assert eng.done and sorted(eng.free_slots) == [0, 1]
    # the reference twin forecasts the port's trace exactly as its own
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    twin = ForecastTwin(jcfg, hardware.TPU_V5E, Variant(), em=0.8)
    want = twin.replay(jeng.trace)
    got = twin.replay(_as_reference(eng.trace))
    assert got.total_time == want.total_time
    assert got.total_tokens == want.total_tokens == sum(len(r.tokens)
                                                        for r in res)
    assert got.cached_tokens == want.cached_tokens == 31
    for rid, rf in want.requests.items():
        assert got.requests[rid].ttft == rf.ttft
        assert got.requests[rid].tpot == rf.tpot


@pytest.mark.parametrize("impl", ["gather", "paged"])
def test_eos_attrition_mid_block_matches_reference(impl):
    """An EOS token stops a slot inside a decode block: it stops writing
    KV and advancing while the other slot decodes on."""
    base = dict(GEOMETRY, attn_impl=impl, kv_dtype="int8", n_blocks=16,
                decode_block=4)
    (_, jres), _ = _run_both("qwen2-7b", base, max_new=8)
    eos = jres[0].tokens[2]                  # appears mid-stream
    (jeng, jres), (eng, res) = _run_both("qwen2-7b", dict(base, eos_id=eos),
                                         max_new=8)
    assert res[0].tokens[-1] == eos and len(res[0].tokens) < 8
    assert [r.tokens for r in res] == [r.tokens for r in jres]
    assert _as_reference(eng.trace) == jeng.trace


def test_engine_config_validation_matches_reference():
    bad = [dict(n_blocks=0), dict(chunk_size=0), dict(decode_block=0),
           dict(block_size=0), dict(max_slots=0), dict(attn_impl="flash"),
           dict(spec_k=-1), dict(lora_tenants=-1), dict(prefill_batch=0),
           dict(lora_tenants=2, lora_ranks=(4, 0)), dict(lora_slots=0)]
    for kw in bad:
        args = dict(dict(max_slots=2, max_len=64), **kw)
        with pytest.raises(ValueError) as want:
            JEngineConfig(**args)
        with pytest.raises(ValueError) as got:
            EngineConfig(**args)
        assert str(got.value) == str(want.value)
    ec = EngineConfig(max_slots=2, max_len=70, n_blocks=3)
    jec = JEngineConfig(max_slots=2, max_len=70, n_blocks=3)
    assert (ec.pool_blocks, ec.blocks_per_seq) == (jec.pool_blocks,
                                                    jec.blocks_per_seq)
    assert EngineConfig(max_slots=3, max_len=70).pool_blocks == \
        JEngineConfig(max_slots=3, max_len=70).pool_blocks
    for kw in (dict(lora_tenants=5), dict(lora_tenants=1, lora_ranks=[4, 8]),
               dict(lora_tenants=5, lora_slots=2), dict()):
        ec, jec = (E(max_slots=3, max_len=70, **kw)
                   for E in (EngineConfig, JEngineConfig))
        assert (ec.lora_ranks, ec.adapter_pool_slots) == (
            jec.lora_ranks, jec.adapter_pool_slots)


def test_moe_config_is_refused_naming_its_roadmap_item(monkeypatch):
    """A MoE stack passes the reference's ``engine_supported`` (which
    ``api.measure`` routes by).  The port's engine refused it until its
    MoE layers were ported (ROADMAP.md queue 1 item 3); it now serves it
    as the reference's does: the same tokens, trace and cursors on
    reduced qwen2-moe-a2.7b, paged attention (the MoE engine's full
    comparison is ``tests/test_torch_moe_engine.py``)."""
    from test_torch_moe import record_dispatches
    arch = "qwen2-moe-a2.7b"
    assert configs.get(arch).family == "moe"
    dispatches = record_dispatches(monkeypatch)
    (jeng, jres), (eng, res) = _run_both(
        arch, dict(GEOMETRY, attn_impl="paged"))
    assert sum(d for _, d in dispatches) > 0        # tokens were dropped
    assert [r.tokens for r in res] == [r.tokens for r in jres]
    assert _as_reference(eng.trace) == jeng.trace
    np.testing.assert_array_equal(eng.state["pos"].numpy(),
                                  np.asarray(jeng.state["pos"]))


def test_vlm_config_is_served_as_text_like_the_reference():
    """internvl2-26b's language stack is served as text by both engines
    (no vision prefix on the engine path): the same tokens and trace."""
    (jeng, jres), (eng, res) = _run_both(
        "internvl2-26b", dict(GEOMETRY, attn_impl="paged"))
    assert configs.get("internvl2-26b").family == "vlm"
    assert [r.tokens for r in res] == [r.tokens for r in jres]
    assert _as_reference(eng.trace) == jeng.trace


@pytest.mark.parametrize("kw,item", [(dict(spec_k=2), "item 8"),
                                     (dict(prefill_batch=2), "item 9"),
                                     (dict(lora_tenants=2), "item 10")])
def test_unported_features_raise(kw, item):
    """The three features the first slice refused (ROADMAP queue 1,
    items 8-10) are ported: each engine builds and serves a request
    (a LoRA tenant's, for the multi-tenant engine) instead of raising."""
    cfg = configs.reduced(configs.get("llama2-7b"))
    params = bridge.params_from_numpy(_weights("llama2-7b"), device="cpu")
    eng = Engine(cfg, params, EngineConfig(max_slots=2, max_len=64, **kw),
                 device="cpu")
    aid = 1 if eng.adapter_pool is not None else None
    res = eng.run([Request(rid=0, prompt=[5, 6, 7, 5, 6], max_new=5,
                           adapter_id=aid)])
    assert len(res[0].tokens) == 5
    kinds = {e.kind for e in eng.trace}
    assert ("spec_step" in kinds) == (eng.ec.spec_k > 0)
    assert ("prefill_batch" in kinds) == (eng.ec.prefill_batch > 1)
    assert eng.trace[-1].adapter_ranks == ((8,) if aid is not None else (0,))


def test_submit_validation_and_warmup():
    cfg = configs.reduced(configs.get("llama2-7b"))
    params = bridge.params_from_numpy(_weights("llama2-7b"), device="cpu")
    eng = Engine(cfg, params, EngineConfig(**GEOMETRY), device="cpu")
    with pytest.raises(ValueError, match="max_new"):
        eng.submit(Request(rid=0, prompt=[1, 2], max_new=0))
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(Request(rid=0, prompt=[1] * 30, max_new=5))
    with pytest.raises(ValueError, match="KV blocks"):
        Engine(cfg, params, EngineConfig(**dict(GEOMETRY, n_blocks=2)),
               device="cpu").submit(Request(rid=0, prompt=[1] * 20,
                                            max_new=5))
    with pytest.raises(ValueError, match="empty prompt"):
        Request(rid=0, prompt=[], max_new=1)
    eng.warmup()                  # leaves a cold cache and an empty pool
    assert eng.index.n_indexed == 0 and eng.pool.in_use == 0
    assert eng.trace == [] and eng.results == {}
    res = eng.run([Request(rid=0, prompt=[5] * 9, max_new=2)])
    assert len(res[0].tokens) == 2 and eng.aggregate_tps() > 0
    assert isinstance(eng.trace[0], TraceEvent) and eng.trace[0].kind == "engine"


def test_calibrate_step_period_leaves_a_clean_engine():
    cfg = configs.reduced(configs.get("llama2-7b"))
    params = bridge.params_from_numpy(_weights("llama2-7b"), device="cpu")
    eng = Engine(cfg, params, EngineConfig(**dict(GEOMETRY, n_blocks=8)),
                 device="cpu")
    eng.warmup()
    period = eng.calibrate_step_period(gen_tokens=4)
    assert period > 0 and eng.step_period == period
    assert eng.trace == [] and eng.results == {} and eng.step_idx == 0
    assert eng.index.n_indexed == 0 and eng.pool.in_use == 0
    with pytest.raises(RuntimeError, match="in flight"):
        eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new=2))
        eng.calibrate_step_period()


def test_temperature_sampling_is_seeded():
    cfg = configs.reduced(configs.get("llama2-7b"))
    params = bridge.params_from_numpy(_weights("llama2-7b"), device="cpu")
    runs = []
    for _ in range(2):
        eng = Engine(cfg, params, EngineConfig(**dict(
            GEOMETRY, temperature=1.0, n_blocks=16, seed=5)), device="cpu")
        runs.append([r.tokens for r in eng.run(
            [Request(rid=i, prompt=p, max_new=6)
             for i, p in enumerate(_prompts(cfg.vocab_size))])])
    assert runs[0] == runs[1]
    assert all(len(t) == 6 for t in runs[0])


# ---------------------------------------------------------------------------
# speculative decoding, bucketed admission, multi-tenant LoRA
# ---------------------------------------------------------------------------

FEATURE_CASES = {
    "spec": (dict(spec_k=2), None),
    "bucketed": (dict(prefill_batch=2), None),
    # three tenants of ranks 4/8/4 and a base request on two adapter
    # slots: the third tenant evicts a released one
    "lora": (dict(lora_tenants=3, lora_ranks=(4, 8), lora_slots=2),
             [0, 1, 2, None]),
    "all": (dict(spec_k=2, prefill_batch=2, lora_tenants=3,
                 lora_ranks=(4, 8), lora_slots=2), [0, 1, 2, None]),
}


@pytest.mark.parametrize("impl", ["gather", "paged"])
@pytest.mark.parametrize("feature", list(FEATURE_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_features_match_reference(arch, feature, impl):
    extra, adapters = FEATURE_CASES[feature]
    kw = dict(GEOMETRY, attn_impl=impl, n_blocks=8, **extra)
    (jeng, jres), (eng, res) = _run_both(arch, kw, adapters=adapters)
    _assert_same_run(arch, jeng, jres, eng, res)
    kinds = {e.kind for e in eng.trace}
    assert ("spec_step" in kinds) == ("spec_k" in extra)
    assert ("prefill_batch" in kinds) == ("prefill_batch" in extra)
    if "spec_k" in extra:
        assert eng.spec_steps == jeng.spec_steps > 0
        assert eng.spec_accepted > 0          # multi-token steps happen
        assert eng.spec_proposed == jeng.spec_proposed
        assert eng.spec_accepted == jeng.spec_accepted
        assert eng.spec_acceptance == jeng.spec_acceptance
        assert eng.spec_tokens_per_step == jeng.spec_tokens_per_step
    if "prefill_batch" in extra:
        assert any(len(e.members) == 2 for e in eng.trace
                   if e.kind == "prefill_batch")
    if adapters:
        pool, jpool = eng.adapter_pool, jeng.adapter_pool
        assert (pool.hits, pool.misses, pool.evictions) == (
            jpool.hits, jpool.misses, jpool.evictions)
        assert pool.evictions >= 1
        assert eng.adapter_hit_rate == jeng.adapter_hit_rate
        assert any(0 < r for e in eng.trace for r in e.adapter_ranks)
        for name in ("lora_A_q", "lora_B_o"):
            np.testing.assert_array_equal(
                bridge.tensor_to_numpy(eng.state[name]),
                np.asarray(jeng.state[name]))


@pytest.mark.parametrize("impl", ["gather", "paged"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_spec_kv_dtypes_match_reference(kv, impl):
    kw = dict(GEOMETRY, attn_impl=impl, kv_dtype=kv, n_blocks=8, spec_k=2)
    (jeng, jres), (eng, res) = _run_both("qwen2-7b", kw)
    _assert_same_run("qwen2-7b", jeng, jres, eng, res, kv=kv)


@pytest.mark.parametrize("impl", ["gather", "paged"])
def test_spec_budget_ending_on_a_block_seam(impl):
    """rid 1 (19 prompt tokens, budget 6) writes positions 0..23: its
    allocation ends on the seam at 24 while spec_k=4 exceeds what its
    budget leaves.  The queries past the budget must write nothing (the
    reference drops them out of range; the table entries past the
    allocation name other requests' blocks), the paged kernel's padding
    rows run past the table's end, and the host cursor mirror follows
    the device's through every step."""
    kw = dict(GEOMETRY, attn_impl=impl, n_blocks=8, spec_k=4,
              block_size=8, max_len=32)
    (jeng, jres), _ = _run_both("llama2-7b", kw)
    cfg = configs.reduced(configs.get("llama2-7b"))
    prompts = _prompts(cfg.vocab_size)
    assert (len(prompts[1]) + 6 - 1) % kw["block_size"] == 0
    eng = Engine(cfg, bridge.params_from_numpy(_weights("llama2-7b"),
                                               device="cpu"),
                 EngineConfig(**kw), device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=6))
    while not eng.done:
        eng.step()
        np.testing.assert_array_equal(eng._pos,
                                      eng.state["pos"].numpy())
    res = [eng.results[r] for r in sorted(eng.results)]
    _assert_same_run("llama2-7b", jeng, jres, eng, res)
    capped = [p for e in eng.trace if e.kind == "spec_step"
              for (rid, _, budget), p in zip(e.slots, e.proposed)
              if budget - 1 < 4]
    assert capped and all(p < 4 for p in capped)
    assert eng.spec_accepted > 0


def test_prefix_cache_off_matches_reference():
    kw = dict(GEOMETRY, prefix_cache=False, n_blocks=10)
    (jeng, jres), (eng, res) = _run_both("llama2-7b", kw)
    assert eng.index is None and jeng.index is None
    assert [r.cached_tokens for r in res] == [0, 0, 0, 0]
    _assert_same_run("llama2-7b", jeng, jres, eng, res)


def test_bucketed_cursor_advance_survives_duplicate_padding():
    """A group padded with duplicates of its first member's slot: the
    member's cursor advances by its ``valid`` (an ``index_add_``; a plain
    indexed ``+=`` would let a duplicate's +0 overwrite it), and the
    padding members write no K/V."""
    from repro_torch.engine import make_prefill_batch_fn
    cfg = configs.reduced(configs.get("llama2-7b"))
    params = bridge.params_from_numpy(_weights("llama2-7b"), device="cpu")
    ec = EngineConfig(**dict(GEOMETRY, prefill_batch=4))
    eng = Engine(cfg, params, ec, device="cpu")
    state = eng.state
    state["block_tables"][1] = torch.tensor([3, 4, 0, 0], dtype=torch.int32)
    state["pos"][1] = 5
    fn = make_prefill_batch_fn(cfg, eng.cache)
    qtoks = np.zeros((4, 8), np.int64)
    qtoks[0, :6] = [1, 2, 3, 4, 5, 6]
    before = state["cache_k"].clone()
    logits, state = fn(params, state, qtoks, np.array([1, 1, 1, 1]),
                       np.array([6, 0, 0, 0]))
    assert logits.shape == (4, cfg.vocab_size)
    assert int(state["pos"][1]) == 11
    changed = (state["cache_k"] != before).any(dim=(0, 3, 4))   # (N, bs)
    want = torch.zeros_like(changed)
    want[3, 5:8] = True
    want[4, 0:3] = True
    assert torch.equal(changed, want)
