"""The port's engine serving MoE decoders against the JAX package's
engine: tokens, counters, trace, cursors and K/V pool identical, with
the gather and paged attention paths, bf16 and int8 KV, speculative
decoding, bucketed admission and LoRA tenants; then ``api.measure`` of a
MoE scenario, whose schedule equals the reference's event for event.

Capacity is counted per call and per row, as in the reference: every row
of a prefill chunk is routed, padding rows included, so the engine's
first token need not be the dense forward's argmax, and a verify pass
(s = k + 1) has room for few tokens per expert.  Each case asserts that the
port dropped tokens, so the drop path is compared too.  Reduced
qwen2-moe-a2.7b and deepseek-moe-16b (E = 8, top-2), f32 weights; the
dense engine tests' geometry and helpers (``test_torch_engine.py``)."""
import dataclasses

import pytest

from repro import api as rapi
from repro_torch import api
from test_torch_engine import GEOMETRY, _assert_same_run, _run_both
from test_torch_moe import record_dispatches

MOE_ARCHS = ["qwen2-moe-a2.7b", "deepseek-moe-16b"]


@pytest.fixture
def dispatches(monkeypatch):
    return record_dispatches(monkeypatch)


def _assert_padding_routed(eng, dispatches, chunk):
    """Tail chunks shorter than ``chunk`` were admitted, and every
    single-slot prefill dispatch routed all ``chunk`` rows: padding rows
    take capacity, as in the reference's engine."""
    tails = [e.chunk for e in eng.trace
             if e.kind == "prefill_chunk" and e.chunk < chunk]
    assert tails
    assert all(n == chunk for (b, n), _ in dispatches if b == 1)
    assert sum(d for _, d in dispatches) > 0


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("impl", ["gather", "paged"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_matches_reference(arch, impl, kv, dispatches):
    (jeng, jres), (eng, res) = _run_both(
        arch, dict(GEOMETRY, attn_impl=impl, kv_dtype=kv))
    assert [r.cached_tokens for r in res] == [0, 8, 23, 0]
    assert res[3].queue_time > 0                         # backpressure
    _assert_same_run(arch, jeng, jres, eng, res, kv=kv)
    _assert_padding_routed(eng, dispatches, GEOMETRY["chunk_size"])
    assert eng.done and sorted(eng.free_slots) == [0, 1]


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
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_features_match_reference(arch, feature, impl, dispatches):
    """Speculation (a verify pass of s = 3 has capacity 1 per expert per
    slot), bucketed admission and LoRA tenants: the same run as the
    reference's."""
    extra, adapters = FEATURE_CASES[feature]
    kw = dict(GEOMETRY, attn_impl=impl, n_blocks=8, **extra)
    (jeng, jres), (eng, res) = _run_both(arch, kw, adapters=adapters)
    _assert_same_run(arch, jeng, jres, eng, res)
    assert sum(d for _, d in dispatches) > 0
    kinds = {e.kind for e in eng.trace}
    assert ("spec_step" in kinds) == ("spec_k" in extra)
    assert ("prefill_batch" in kinds) == ("prefill_batch" in extra)
    if "spec_k" in extra:
        assert eng.spec_steps == jeng.spec_steps > 0
        assert eng.spec_accepted == jeng.spec_accepted
        # a verify pass: 2 slots x (k + 1) rows, and tokens dropped in it
        assert any(d > 0 for (b, n), d in dispatches if n == 3)
    if "prefill_batch" in extra:
        assert any(len(e.members) == 2 for e in eng.trace
                   if e.kind == "prefill_batch")
    if adapters:
        pool, jpool = eng.adapter_pool, jeng.adapter_pool
        assert (pool.hits, pool.misses, pool.evictions) == (
            jpool.hits, jpool.misses, jpool.evictions)


#: reduced qwen2-moe-a2.7b through ``measure``: paged attention and a
#: 32-token shared prefix (two 16-token blocks) served from the cache
SCN = dict(model="qwen2-moe-a2.7b", reduced=True, batch=2, n_requests=3,
           prompt_len=40, gen_len=6, chunk=16, decode_block=2,
           attn_impl="paged", shared_prefix_len=32)


def test_moe_measured_schedule_equals_reference(dispatches):
    """``api.measure`` serves a MoE scenario: the reference's extras and
    counters, and its schedule event for event (no EOS, so the schedule
    depends on lengths, not on the two PRNGs' weights and prompts)."""
    ref = rapi.measure(rapi.Scenario(**SCN))
    port = api.measure(api.Scenario(**SCN), device="cpu")
    assert port.extras["mode"] == ref.extras["mode"] == "engine"
    assert sorted(port.extras) == sorted(ref.extras)
    for key in ("tokens", "requests", "prefix_hit_tokens",
                "peak_blocks_in_use"):
        assert port.extras[key] == ref.extras[key], key
    assert port.extras["prefix_hit_tokens"] > 0
    assert ([dataclasses.asdict(e) for e in port.trace]
            == [dataclasses.asdict(e) for e in ref.trace])
    assert port.to_dict()["phases"] == ref.to_dict()["phases"]
    assert sum(d for _, d in dispatches) > 0
