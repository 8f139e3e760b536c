"""Pipeline parallelism on the CPU: the port's engine at pp = 2 (two
stages of one layer each) and at tp = 2 × pp = 2 (four gloo ranks)
against the JAX package's engine at tp = pp = 1 on shared f32 weights,
for both attention paths, bf16 and int8 KV, LoRA tenants with
speculation and a MoE decoder; then ``api.measure`` at tp = 2 and at
pp = 2, whose schedule is the tp = 1 schedule event for event and whose
trace replays through both packages' twins to the same forecast.

The reference's own pipeline test
(``test_pipeline_pp.py::test_pp_tokens_identical_subprocess``) fails on
the seed, so the oracle is the reference at tp = pp = 1.  The rank
function and the reference runner are ``test_torch_tp.py``'s (that
module loads no JAX at its top, so the ranks import none)."""
import dataclasses
import functools

import pytest

from repro_torch import api
from repro_torch.launch import mesh as M
from test_torch_tp import (JOBS, assert_same_as_reference, reference_run,
                           reference_weights, serve_jobs)

#: the jobs the pipeline worlds serve
PP_JOBS = {k: JOBS[k] for k in (
    "llama-gather-bf16", "llama-gather-int8", "llama-paged-bf16",
    "llama-paged-int8", "llama-lora-spec-paged", "moe-paged-int8")}
PLANS = {"pp2": (1, 2), "tp2xpp2": (2, 2)}


@functools.lru_cache(maxsize=None)
def _reference(job):
    return reference_run(*JOBS[job])


@pytest.fixture(scope="module")
def worlds():
    trees = reference_weights()
    return {plan: M.spawn(serve_jobs, (trees, PP_JOBS), model=m, pipe=p,
                          device="cpu")
            for plan, (m, p) in PLANS.items()}


@pytest.mark.parametrize("job", list(PP_JOBS))
@pytest.mark.parametrize("plan", list(PLANS))
def test_pipeline_serves_the_reference_tokens(worlds, plan, job):
    """Every rank of every stage ends with the reference's tokens, hits
    and schedule; its pool holds its stage's one layer."""
    model, pipe = PLANS[plan]
    ranks = worlds[plan]
    assert len(ranks) == model * pipe
    assert_same_as_reference([r[job] for r in ranks], _reference(job),
                             tp=model, pp=pipe)
    for r in ranks:
        assert r[job]["pool"][0] == 1                   # 2 layers / 2 stages
        assert r["jax_loaded"] == []


#: ``test_torch_measure.py``'s scenario: reduced qwen2-7b, paged, a
#: shared prefix served from the cache
SCN = dict(model="qwen2-7b", reduced=True, batch=2, n_requests=3,
           prompt_len=40, gen_len=6, chunk=16, decode_block=2,
           attn_impl="paged", shared_prefix_len=32)


@pytest.fixture(scope="module")
def measured():
    return {plan: api.measure(api.Scenario(**dict(SCN, **kw)), device="cpu")
            for plan, kw in (("tp1", {}), ("tp2", {"tp": 2}),
                             ("pp2", {"pp": 2}))}


def _events(trace):
    return [dataclasses.asdict(e) for e in trace]


@pytest.mark.parametrize("plan", ["tp2", "pp2"])
def test_measure_keeps_the_one_device_schedule(measured, plan):
    """Rank 0's report: the tp = 1 run's schedule event for event, with
    the plan in the trace header, the extras and the scenario."""
    base, rep = measured["tp1"], measured[plan]
    tp, pp = (2, 1) if plan == "tp2" else (1, 2)
    got, want = _events(rep.trace), _events(base.trace)
    assert got[1:] == want[1:]
    assert (got[0].pop("tp"), got[0].pop("pp")) == (tp, pp)
    assert (want[0].pop("tp"), want[0].pop("pp")) == (1, 1)
    assert got[0] == want[0]
    assert (rep.extras["tp"], rep.extras["pp"]) == (tp, pp)
    assert (rep.scenario["tp"], rep.scenario["pp"]) == (tp, pp)
    assert rep.extras["mode"] == "engine" and rep.extras["tokens"] == 3 * 6
    assert rep.extras["prefix_hit_tokens"] == base.extras["prefix_hit_tokens"]
    for metric in ("ttft_s", "tpot_s", "tps"):
        assert getattr(rep, metric) > 0


@pytest.mark.parametrize("plan", ["tp2", "pp2"])
def test_sharded_trace_replays_in_both_twins(measured, plan):
    """The sharded run's trace replays through the port's twin and,
    crossed into the reference's ``TraceEvent``, through the reference's
    to the same forecast of the sharded scenario."""
    from repro import api as rapi
    from repro.engine.scheduler import TraceEvent as RefTraceEvent
    rep = measured[plan]
    kw = dict(SCN, tp=rep.extras["tp"], pp=rep.extras["pp"])
    ref_trace = [RefTraceEvent(**e) for e in _events(rep.trace)]
    want = rapi.forecast(rapi.Scenario(**kw), "tpu-v5e", trace=ref_trace)
    got = api.forecast(api.Scenario(**kw), "tpu-v5e", trace=rep.trace)
    assert got.to_dict() == want.to_dict()
    assert got.tps > 0
