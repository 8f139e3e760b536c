"""``repro_torch.api.measure`` on the CPU against the JAX package's
``measure``: the same scenario on reduced qwen2-7b gives the reference's
``extras`` keys and counters, the same engine schedule (its trace, event
for event: no EOS, so the schedule depends on lengths, not on the random
weights and prompts, which the two PRNGs draw differently), and that
trace replays through both twins to the same forecast.  Then the
refusals, traffic and the CLI."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro import api as rapi
from repro.engine.scheduler import TraceEvent as RefTraceEvent
from repro_torch import api

ROOT = Path(__file__).resolve().parents[1]

#: reduced qwen2-7b, paged attention, a 32-token shared prefix (two
#: 16-token blocks) served from the cache to the later requests
SCN = dict(model="qwen2-7b", reduced=True, batch=2, n_requests=3,
           prompt_len=40, gen_len=6, chunk=16, decode_block=2,
           attn_impl="paged", shared_prefix_len=32)


@pytest.fixture(scope="module")
def reports():
    ref = rapi.measure(rapi.Scenario(**SCN))
    port = api.measure(api.Scenario(**SCN), device="cpu")
    return ref, port


def _events(trace):
    return [dataclasses.asdict(e) for e in trace]


def test_measure_matches_reference_report(reports):
    ref, port = reports
    assert port.source == "measured" and port.hardware == "host"
    assert sorted(port.extras) == sorted(ref.extras)
    assert port.extras["mode"] == ref.extras["mode"] == "engine"
    for key in ("tokens", "requests", "attn_impl", "tp", "pp", "block_size",
                "prefix_hit_tokens", "prefix_hit_rate",
                "peak_blocks_in_use"):
        assert port.extras[key] == ref.extras[key], key
    assert port.extras["tokens"] == 3 * 6
    assert port.extras["prefix_hit_tokens"] > 0
    # the analytical phases and the scenario are the same on both sides
    want, got = ref.to_dict(), port.to_dict()
    assert got["phases"] == want["phases"]
    assert got["scenario"] == want["scenario"]
    for metric in ("ttft_s", "tpot_s", "tps"):
        assert got[metric] > 0


def test_measured_schedule_equals_reference(reports):
    ref, port = reports
    assert _events(port.trace) == _events(ref.trace)
    assert port.trace[0].kind == "engine"
    assert port.trace[0].attn_impl == "paged"


def test_trace_replays_to_the_same_forecast_in_both_twins(reports):
    """The port's measured trace, crossed into the reference's
    ``TraceEvent``, replays through the reference's twin to the forecast
    the port's twin gives, on the TPU spec and on the H100 spec."""
    _, port = reports
    ref_trace = [RefTraceEvent(**e) for e in _events(port.trace)]
    from repro.core.hardware import HardwareSpec
    from repro_torch.core import hardware
    h100 = HardwareSpec(**dataclasses.asdict(hardware.get("nvidia-h100")))
    for port_hw, ref_hw in (("tpu-v5e", "tpu-v5e"), ("nvidia-h100", h100)):
        want = rapi.forecast(rapi.Scenario(**SCN), ref_hw, trace=ref_trace)
        got = api.forecast(api.Scenario(**SCN), port_hw, trace=port.trace)
        assert got.to_dict() == want.to_dict()
        assert "trace_prefix_hit_rate" in got.extras
    delta = api.compare(api.forecast(api.Scenario(**SCN), "nvidia-h100",
                                     trace=port.trace), port)
    assert delta.measured_hw == "host" and delta.forecast_hw == "nvidia-h100"


def test_traffic_measure_has_the_reference_keys():
    kw = dict(SCN, shared_prefix_len=None)
    ref = rapi.measure(rapi.Scenario(**kw).traffic("poisson", qps=50.0))
    port = api.measure(api.Scenario(**kw).traffic("poisson", qps=50.0),
                       device="cpu")
    assert port.extras["mode"] == ref.extras["mode"] == "engine-traffic"
    assert sorted(port.extras) == sorted(ref.extras)
    assert sorted(port.extras["traffic"]) == sorted(ref.extras["traffic"])
    assert port.extras["requests"] == ref.extras["requests"]
    assert port.extras["tokens"] == ref.extras["tokens"]


def test_int4_variant_measures_bf16_weights_and_int8_kv(monkeypatch):
    """The reference's mapping: int4 KV variants run the int8 cache, and
    the weights stay bf16 whatever dtype_w says."""
    from repro_torch.engine import scheduler
    seen = {}
    real = scheduler.Engine.__init__

    def spy(self, cfg, params, ec, **kw):
        seen["kv"] = ec.kv_dtype
        seen["w"] = params["embed"].dtype
        real(self, cfg, params, ec, **kw)

    monkeypatch.setattr(scheduler.Engine, "__init__", spy)
    rep = api.measure(api.Scenario(**dict(SCN, variant="bf16-int4-kv4")),
                      device="cpu")
    assert seen == {"kv": "int8", "w": torch.bfloat16}
    assert rep.variant == "bf16-int4-kv4"


@pytest.mark.parametrize("kw,item", [
    (dict(tp=2), "item 15"),
    (dict(pp=2), "item 15"),
    (dict(model="falcon-mamba-7b"), "item 13"),
    (dict(model="recurrentgemma-2b"), "item 13"),
    (dict(model="qwen2-moe-a2.7b"), "item 11"),
])
def test_measure_refuses_what_is_not_ported(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        api.measure(api.Scenario(**dict(SCN, **kw)), device="cpu")


def test_measure_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the refusal path is not reachable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.measure(api.Scenario(**SCN))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_cli_measure_on_the_cpu():
    args = [sys.executable, "-m", "repro_torch", "measure", "--model",
            "qwen2-7b", "--reduced", "--batch", "2", "--requests", "3",
            "--prompt", "24", "--gen", "4", "--chunk", "8",
            "--decode-block", "2", "--attn-impl", "paged"]
    out = subprocess.run(args + ["--device", "cpu", "--json"], env=_env(),
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["source"] == "measured" and rep["extras"]["mode"] == "engine"
    assert rep["extras"]["tokens"] == 12
    if not torch.cuda.is_available():      # the default device is the card
        out = subprocess.run(args, env=_env(), cwd=ROOT, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert "torch.cuda.is_available() is False" in out.stderr
