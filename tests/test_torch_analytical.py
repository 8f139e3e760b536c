"""The analytical half of the port against the JAX package's: the copies
of ``configs``, ``core``, ``traffic``, ``api`` (forecast, sweep, max_qps)
and the engine's ``ForecastTwin`` give the reference's reports, field for
field, over every architecture × paper variant × the reference's hardware,
on traffic and on replayed traces; the CLI's ``forecast --json`` prints
the reference's JSON; and the registry's one addition, the H100, is data.

The code is the same Python arithmetic on both sides, so every comparison
here is exact equality."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro import api as rapi
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import PAPER_VARIANTS as REF_VARIANTS
from repro.core import hardware as rhw
from repro.engine import forecast_twin as rtwin
from repro.engine.scheduler import TraceEvent as RefTraceEvent
from repro_torch import api, configs
from repro_torch.core import hardware
from repro_torch.engine import forecast_twin as twin
from repro_torch.engine.scheduler import TraceEvent

ROOT = Path(__file__).resolve().parents[1]

#: the reference registry's own targets (fixed here: another test may
#: register a calibrated spec in the reference's registry at run time)
REF_HW = ("ryzen-9-hx370-cpu", "ryzen-ai-max-395-npu",
          "ryzen-ai-max-395-igpu", "nvidia-v100", "tpu-v5e")

#: a plain decode-heavy scenario and an engine-shaped one (chunked,
#: paged, a shared prefix served from the cache)
SCENARIOS = (dict(batch=4, prompt_len=512, gen_len=64),
             dict(batch=4, prompt_len=512, gen_len=64, chunk=256,
                  attn_impl="paged", shared_prefix_len=256, n_requests=8))


def _both(fn_ref, fn_port):
    """Run both sides; either both raise the same exception type and
    message, or both return."""
    try:
        want = fn_ref()
    except Exception as e:             # the reference's refusal is the spec
        with pytest.raises(type(e)) as got:
            fn_port()
        assert str(got.value) == str(e)
        return None, None
    return want, fn_port()


@pytest.mark.parametrize("variant", list(REF_VARIANTS))
@pytest.mark.parametrize("arch", list(REF_ARCHS))
def test_forecast_reports_equal_reference(arch, variant):
    for kw in SCENARIOS:
        for hw in REF_HW:
            want, got = _both(
                lambda: rapi.forecast(rapi.Scenario(model=arch,
                                                    variant=variant, **kw),
                                      hw),
                lambda: api.forecast(api.Scenario(model=arch,
                                                  variant=variant, **kw),
                                     hw))
            if want is not None:
                assert got.to_dict() == want.to_dict(), (arch, variant, hw,
                                                         kw)


def test_forecast_knobs_and_sharding_equal_reference():
    """ec/em/decode_ec, the dispatch convention, a tp × pp plan, a LoRA
    merge, multi-tenant LoRA and speculation priced the same way."""
    cases = [
        (dict(model="llama2-7b", variant="bf16-int4", batch=8, prompt_len=2048,
              gen_len=256, chunk=512), dict(ec=0.7, em=0.8, decode_ec=0.9,
                                            include_dispatch=False)),
        (dict(model="qwen2-7b", batch=4, prompt_len=1024, gen_len=128,
              tp=2, pp=2, chunk=256), dict(em=0.8)),
        (dict(model="llama2-7b", variant="bf16-int4-lora", batch=2,
              lora_rank=64), {}),
        (dict(model="llama2-7b", batch=4, prompt_len=256, gen_len=32,
              lora_n_tenants=4, lora_ranks=(8, 16), attn_impl="paged"), {}),
        (dict(model="llama2-7b", batch=4, prompt_len=256, gen_len=32,
              spec_k=4, spec_acceptance=0.6, attn_impl="gather"), {}),
        (dict(model="llama2-7b", batch=3, past_lens=(100, 300, 700),
              gen_len=16), {}),
    ]
    for scn, knobs in cases:
        for hw in ("tpu-v5e", "nvidia-v100"):
            want = rapi.forecast(rapi.Scenario(**scn), hw, **knobs)
            got = api.forecast(api.Scenario(**scn), hw, **knobs)
            assert got.to_dict() == want.to_dict(), (scn, hw)


def test_sweep_equals_reference():
    kw = dict(model="llama2-7b", variant="bf16-int4-kv8", batch=4,
              prompt_len=512, gen_len=64)
    want = rapi.sweep(rapi.Scenario(**kw), ["cpu", "v100", "v5e"],
                      tops=[10, 100], bw=[100, 800])
    got = api.sweep(api.Scenario(**kw), ["cpu", "v100", "v5e"],
                    tops=[10, 100], bw=[100, 800])
    assert [r.to_dict() for r in got] == [r.to_dict() for r in want]
    want = rapi.sweep(rapi.Scenario(**kw), ["v5e"], tops=[50], bw=[400],
                      interconnect_GBps=100.0, tp_degrees=[1, 2],
                      pp_degrees=[1, 2])
    got = api.sweep(api.Scenario(**kw), ["v5e"], tops=[50], bw=[400],
                    interconnect_GBps=100.0, tp_degrees=[1, 2],
                    pp_degrees=[1, 2])
    assert [r.to_dict() for r in got] == [r.to_dict() for r in want]


def _traffic(mod):
    return mod.Scenario(model="llama2-7b", batch=4, prompt_len=256,
                        gen_len=32, chunk=128, n_requests=24,
                        seed=3).traffic(
        "poisson", qps=3.0, ttft_slo=0.5, tpot_slo=0.05,
        prompt_len_dist="uniform:128:384")


def test_poisson_traffic_forecast_equals_reference():
    for hw in ("tpu-v5e", "nvidia-v100"):
        want = rapi.forecast(_traffic(rapi), hw, em=0.8)
        got = api.forecast(_traffic(api), hw, em=0.8)
        assert got.to_dict() == want.to_dict()
        assert got.extras["traffic"]["n_requests"] == 24


def test_max_qps_equals_reference():
    want = rapi.max_qps(_traffic(rapi), "tpu-v5e", goodput_target=0.9)
    got = api.max_qps(_traffic(api), "tpu-v5e", goodput_target=0.9)
    assert got == want and got > 0


def _traces(Event):
    """A plain trace with a prefix hit and a batched admission, and a
    speculative one, over the same hand-built schedule."""
    plain = [
        Event("engine", chunk=8, n_steps=2, attn_impl="paged",
              block_size=16),
        Event("prefill_chunk", rid=0, slot=0, chunk=8, past_len=0),
        Event("prefill_chunk", rid=0, slot=0, chunk=8, past_len=8,
              last=True),
        Event("prefill_chunk", rid=1, slot=1, chunk=4, past_len=12,
              cached=12, last=True),
        Event("decode_block", n_steps=2, slots=((0, 16, 5), (1, 16, 5))),
        Event("decode_block", n_steps=2, slots=((0, 18, 3), (1, 18, 3))),
        Event("prefill_batch", members=((2, 0, 8, 0, 0, True),
                                        (3, 1, 8, 0, 0, True))),
        Event("decode_block", n_steps=2, slots=((2, 8, 3), (3, 8, 3))),
    ]
    spec = [
        Event("engine", chunk=8, n_steps=2, attn_impl="gather",
              block_size=16, spec_k=2),
        Event("prefill_chunk", rid=0, slot=0, chunk=8, past_len=0,
              last=True),
        Event("prefill_chunk", rid=1, slot=1, chunk=8, past_len=0,
              last=True),
        Event("spec_step", spec_k=2, slots=((0, 8, 6), (1, 8, 6)),
              proposed=(2, 2), accepted=(2, 0)),
        Event("spec_step", spec_k=2, slots=((0, 11, 3), (1, 9, 5)),
              proposed=(2, 2), accepted=(1, 1)),
    ]
    return plain, spec


def _forecast_dict(tf):
    return dataclasses.asdict(tf)


def test_trace_replay_equals_reference():
    """Both twins replay the same schedule to the same forecast, and the
    counterfactual rewrites (cache-cold, despeculated) agree."""
    for port_trace, ref_trace in zip(_traces(TraceEvent),
                                     _traces(RefTraceEvent)):
        for hw in ("tpu-v5e", "nvidia-v100"):
            arch = REF_ARCHS["llama2-7b"]
            want = rtwin.ForecastTwin(arch, rhw.get(hw), em=0.8).replay(
                ref_trace)
            got = twin.ForecastTwin(configs.get("llama2-7b"), hardware.get(hw),
                                    em=0.8).replay(port_trace)
            assert _forecast_dict(got) == _forecast_dict(want)
            assert (got.tps, got.mean_ttft, got.mean_tpot) == \
                (want.tps, want.mean_ttft, want.mean_tpot)
        for rewrite in ("cold_trace", "despeculate_trace"):
            got = [dataclasses.asdict(e) for e in
                   getattr(twin, rewrite)(port_trace)]
            want = [dataclasses.asdict(e) for e in
                    getattr(rtwin, rewrite)(ref_trace)]
            assert got == want, rewrite
        kw = dict(model="llama2-7b", batch=2, prompt_len=16, gen_len=6,
                  chunk=8)
        want = rapi.forecast(rapi.Scenario(**kw), "tpu-v5e",
                             trace=ref_trace)
        got = api.forecast(api.Scenario(**kw), "tpu-v5e", trace=port_trace)
        assert got.to_dict() == want.to_dict()


def test_hardware_registry_is_the_reference_plus_h100():
    for name in REF_HW:
        assert dataclasses.asdict(hardware.get(name)) == \
            dataclasses.asdict(rhw.get(name))
    assert set(hardware.names()) >= set(REF_HW) | {"nvidia-h100"}
    h100 = hardware.get("H100")                  # alias, case-insensitive
    assert h100 is hardware.NVIDIA_H100
    assert (h100.name, h100.tops, h100.bw_gbps, h100.interconnect_GBps,
            h100.hbm_bytes, h100.onchip_bytes) == (
        "nvidia-h100", 989.0, 3350.0, 900.0, 80e9, 50 * 2 ** 20)
    for alias, name in rhw.ALIASES.items():
        assert hardware.ALIASES[alias] == name
    # the entry is data: the reference prices an equal spec identically
    spec = rhw.HardwareSpec(**dataclasses.asdict(h100))
    kw = dict(model="llama2-7b", batch=4, prompt_len=512, gen_len=64,
              chunk=256, attn_impl="paged")
    assert api.forecast(api.Scenario(**kw), "nvidia-h100").to_dict() == \
        rapi.forecast(rapi.Scenario(**kw), spec).to_dict()


def test_scenarios_resolve_like_the_reference():
    kws = [dict(model="llama2-7b", variant="bf16-int4-kv4", prompt_len=2048,
                gen_len=256),
           dict(model="qwen2-7b", batch=2, shared_prefix_len=32,
                prompt_len=64, n_requests=4, reduced=True),
           dict(model="llama2-7b", lora_n_tenants=3, lora_ranks=(4, 8),
                lora_popularity=1.1, batch=4)]
    for kw in kws:
        want, got = rapi.Scenario(**kw), api.Scenario(**kw)
        assert got.to_dict() == want.to_dict()
        assert dataclasses.asdict(got.arch) == dataclasses.asdict(want.arch)
        assert got.request_gen_lens == want.request_gen_lens
        assert got.lora_adapter_ids(6) == want.lora_adapter_ids(6)
    for bad in (dict(model="llama2-7b", batch=0),
                dict(model="no-such-model"),
                dict(model="llama2-7b", attn_impl="xla")):
        _both(lambda: rapi.Scenario(**bad).arch,
              lambda: api.Scenario(**bad).arch)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _cli(package, *args):
    out = subprocess.run([sys.executable, "-m", package, *args], env=_env(),
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_cli_forecast_json_equals_reference():
    args = ("forecast", "--model", "llama2-7b", "--variant",
            "bf16-int4-kv4", "--hw", "tpu-v5e", "--prompt", "2048", "--gen",
            "256", "--batch", "4", "--chunk", "512", "--json")
    assert json.loads(_cli("repro_torch", *args)) == \
        json.loads(_cli("repro", *args))
    out = _cli("repro_torch", "forecast", "--model", "llama2-7b", "--hw",
               "h100", "--prompt", "512", "--gen", "64", "--batch", "4")
    assert "nvidia-h100" in out and "TPOT" in out
    assert "nvidia-h100" in _cli("repro_torch", "hardware")
