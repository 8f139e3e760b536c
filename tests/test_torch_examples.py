"""The port's two examples, run as a user runs them (``runpy`` with
``sys.argv`` set) at CPU size: ``examples/serve_batched_torch.py
--device cpu --reduced`` serves the reference example's five scenarios
(6 requests, 120 tokens each; the shared prompt's measured prefix hit
rate equals the twin's forecast), and ``examples/train_100m_torch.py
--device cpu --small`` trains 20 steps with a falling loss.  Asked for
no device on a host without a GPU, each raises instead of running on
the CPU.  ``tests/test_torch_measure.py`` holds the measured schedule
equal to the reference's event for event."""
import json
import re
import runpy
import sys
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SERVE = EXAMPLES / "serve_batched_torch.py"
TRAIN = EXAMPLES / "train_100m_torch.py"


def _run(monkeypatch, path, *args):
    monkeypatch.setattr(sys, "argv", [str(path), *map(str, args)])
    runpy.run_path(str(path), run_name="__main__")


def test_serve_example_serves_the_five_scenarios(monkeypatch, capsys):
    _run(monkeypatch, SERVE, "--device", "cpu", "--reduced")
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(" -> ")[0].strip() for ln in lines] == [
        "baseline bf16-KV", "chunked admission(16)", "int8 KV blocks",
        "sampled T=0.8", "shared system prompt"]
    for ln in lines:
        assert " -> 120 toks over 6 reqs on 3 slots  cpu " in ln, ln
        assert "(cpu-twin ratio" in ln and "full model→nvidia-h100" in ln
    hits = re.search(r"prefix hits: measured ([\d.]+)% = forecast "
                     r"([\d.]+)%", lines[-1])
    assert hits and float(hits[1]) > 0 and hits[1] == hits[2], lines[-1]


def test_train_example_lowers_the_loss(monkeypatch, capsys, tmp_path):
    _run(monkeypatch, TRAIN, "--device", "cpu", "--small", "--steps", 20,
         "--batch", 2, "--seq", 64, "--ckpt-dir", tmp_path / "ck")
    out = capsys.readouterr().out
    assert out.startswith("[LIFE→nvidia-h100] fwd/step:")
    summary = json.loads(out[out.index("{"):out.index("}\n") + 1])
    assert summary["steps"] == 20 and summary["params"] > 20e6
    (first, l0), (last, l1) = summary["loss_curve"][0], \
        summary["loss_curve"][-1]
    assert (first, last) == (0, 19) and l1 < l0
    assert "OK: loss improved" in out


@pytest.mark.parametrize("path", [SERVE, TRAIN], ids=["serve", "train"])
def test_example_without_a_device_raises_on_a_gpu_less_host(
        monkeypatch, path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run(monkeypatch, path)
